"""Ranks, their layout and what moves between them (port of
multiagentperception_tpu/parallel/): data parallel over ranks, the agent
ring, the ``model`` axis (tensor parallel over output channels,
``parallel.tensor``), BatchNorm statistics over a group. One process
(rank) drives one card; a JAX mesh of D devices is D ranks of one
``torch.distributed`` group.
"""

from multiagentperception_tpu_torch.parallel.collectives import Group
from multiagentperception_tpu_torch.parallel.mesh import (
    Layout,
    agent_parallel_ranks,
    data_parallel_ranks,
    from_environment,
    init_distributed,
    model_parallel_ranks,
    spawn,
)

__all__ = ["Group", "Layout", "agent_parallel_ranks", "data_parallel_ranks",
           "from_environment", "init_distributed", "model_parallel_ranks", "spawn"]
