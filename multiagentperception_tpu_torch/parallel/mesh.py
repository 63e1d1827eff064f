"""Ranks and their layout (port of multiagentperception_tpu/parallel/mesh.py).

In PyTorch one process (a rank) drives one card. A JAX mesh of D devices
becomes D ranks of one ``torch.distributed`` process group:

- ``data_parallel_ranks`` is JAX's ``data_parallel_mesh`` policy (:126-155):
  0 picks the largest count of the available devices that divides the
  batch, with JAX's warning; an explicit count that does not divide the
  batch, or exceeds the devices, raises; 1 means no data parallel.
- ``agent_parallel_ranks`` is ``agent_parallel_mesh`` (:88-123): the agent
  count must divide over A ranks, A x D devices must exist and the batch
  must divide over D.
- ``init_distributed`` joins the process group and returns a ``Layout``: the
  world, its D x A grid (rank ``d * A + a``, JAX's ``reshape(d, n)``), the
  data group of each rank (the ranks of its agent index: its batch rows'
  peers) and its agent group (its ring), and its device
  ``cuda:{local_rank % device_count}``, made current with
  ``torch.cuda.set_device``.
- The backend is decided once, from the layout, before anything runs:
  ``nccl`` where every rank of a host has a card of its own, ``gloo`` where
  ranks share a card, or on the CPU. NCCL asked for on shared cards, or on
  the CPU, raises; a rank that finds no card raises.
- ``from_environment`` reads a ``MAP_COORDINATOR`` launch (JAX train.py:48-58):
  ``MAP_COORDINATOR=host:port`` (``tcp://``; or a ``file://`` URL, a
  rendezvous file every rank can reach), ``MAP_NUM_PROCESSES`` (the
  world) and ``MAP_PROCESS_ID`` (the rank); one such process is one rank
  on one card. Its local rank and the ranks on its host are torchrun's
  ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` where set, else the whole world is
  taken to be on one host.
- ``spawn`` starts D local ranks (the CLIs' ``--data_parallel D``) with a
  ``file://`` rendezvous, each with its own timeout; a failing rank fails
  the launch.

The JAX mesh's ``model`` axis (``make_mesh(n_model > 1)`` /
``param_shardings``, tensor parallel) is not ported: no CLI reaches it.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

from multiagentperception_tpu_torch.parallel.collectives import Group

LOG = logging.getLogger("multiagentperception_tpu_torch")
TIMEOUT_S = 600.0  # a collective that waits longer raises


def data_parallel_ranks(batch_size: int, n: int = 0, available: int = 1) -> int:
    """Ranks on the batch axis (JAX ``data_parallel_mesh``): ``n``, or with
    ``n == 0`` the largest count of ``available`` devices that divides the
    batch (a warning when it leaves devices idle)."""
    if not n:
        n = available
        while n > 1 and batch_size % n:
            n -= 1
        if n < available:
            LOG.warning("data-parallel mesh: using %d of %d devices (batch_size %d "
                        "divisibility); pick a batch divisible by the device count "
                        "to use them all", n, available, batch_size)
    elif batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by --data_parallel {n}")
    elif n > available:
        raise ValueError(f"--data_parallel {n} needs {n} devices, have {available}")
    return max(1, n)


def agent_parallel_ranks(cfg: Mapping[str, Any], n_cli: int = 0, n_data: int = 0,
                         available: int = 1) -> int:
    """Ranks on the agent axis (JAX ``agent_parallel_mesh``): ``n_cli`` or
    ``model.agent_parallel``; 1 when not asked for. With ``n_data > 1``
    each data group runs its own ring."""
    n = int(n_cli or cfg["model"].get("agent_parallel") or 0)
    if n <= 1:
        return 1
    d = max(1, int(n_data))
    agent_num = int(cfg["model"].get("agent_num") or 5)
    if available < n * d:
        raise ValueError(f"--agent_parallel {n} x --data_parallel {d} needs {n * d} "
                         f"devices, have {available}")
    if agent_num % n:
        raise ValueError(f"agent_num {agent_num} not divisible by agent_parallel {n}")
    batch = cfg.get("training", {}).get("batch_size")
    if d > 1 and batch and batch % d:
        raise ValueError(f"batch_size {batch} not divisible by --data_parallel {d}")
    return n


@dataclass(eq=False)
class Layout:
    """A rank's place in a D x A grid of ranks (module docstring)."""

    rank: int
    world: int
    agent: int  # A: ranks per ring
    backend: str
    device: torch.device
    world_group: Group
    data_group: Group  # the ranks of this rank's agent index
    agent_group: Group  # this rank's ring

    @property
    def data(self) -> int:
        return self.world // self.agent

    @property
    def data_index(self) -> int:
        return self.rank // self.agent

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def pick_backend(device_type: str, local_world: int, devices: int,
                 backend: str | None = None) -> tuple[str, str]:
    """(backend, reason): NCCL where each rank of a host has a card of its
    own, gloo where ranks share one or run on the CPU. An explicit ``nccl``
    that cannot hold raises."""
    if device_type == "cpu":
        reason = "ranks on the CPU"
        shared = True
    else:
        shared = local_world > devices
        reason = (f"{local_world} ranks share {devices} card(s) on this host" if shared
                  else f"{local_world} ranks, a card each")
    if backend is None:
        backend = "gloo" if shared else "nccl"
    if backend == "nccl" and shared:
        raise RuntimeError(f"backend nccl with {reason}: NCCL takes one rank per card")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    return backend, reason


def _groups(rank: int, world: int, agent: int, backend: str,
            device: torch.device) -> tuple[Group, Group, Group]:
    """The world group and this rank's data and agent groups. Every rank
    creates every group, in one order, as ``dist.new_group`` requires."""
    world_group = Group(tuple(range(world)), rank, backend, device, dist.group.WORLD)
    data = world // agent

    def make(members_of: list[list[int]]) -> Group:
        mine = None
        for members in members_of:
            if len(members) == world:
                return world_group
            pg = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                mine = Group(tuple(members), members.index(rank), backend, device, pg)
        return mine

    data_group = make([[d * agent + a for d in range(data)] for a in range(agent)])
    agent_group = make([[d * agent + a for a in range(agent)] for d in range(data)])
    return world_group, data_group, agent_group


def init_distributed(*, rank: int, world: int, init_method: str, device: str = "cuda",
                     agent: int = 1, local_rank: int | None = None,
                     local_world: int | None = None, backend: str | None = None) -> Layout:
    """Join the process group as ``rank`` of ``world`` and return the
    rank's ``Layout`` (module docstring). ``agent``: ranks per ring (A)."""
    if world % agent:
        raise ValueError(f"world {world} does not divide into rings of {agent}")
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(f"rank {rank}: no CUDA device (torch.cuda.is_available() "
                               "is False); pass --device cpu to run the ranks on the CPU")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    elif device == "cpu":
        count, dev = 0, torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}")
    backend, reason = pick_backend(dev.type, local_world, count, backend)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    world_group, data_group, agent_group = _groups(rank, world, agent, backend, dev)
    layout = Layout(rank, world, agent, backend, dev, world_group, data_group, agent_group)
    if rank == 0:
        line = (f"parallel: {world} rank(s), data {layout.data} x agent {agent}, "
                f"backend {backend} ({reason}), rank 0 on {dev}")
        print(line, flush=True)
        LOG.info(line)
    return layout


def from_environment(device: str = "cuda", agent: int = 1) -> Layout | None:
    """The ``Layout`` of a ``MAP_COORDINATOR`` launch, or None without one."""
    coord = os.environ.get("MAP_COORDINATOR")
    if not coord:
        return None
    world = int(os.environ["MAP_NUM_PROCESSES"])
    rank = int(os.environ["MAP_PROCESS_ID"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    init_method = coord if coord.startswith("file://") else f"tcp://{coord}"
    return init_distributed(rank=rank, world=world, init_method=init_method,
                            device=device, agent=agent, local_rank=local_rank,
                            local_world=local_world)


def _rank_entry(rank: int, world: int, init_method: str, device: str, agent: int,
                fn: Callable, args: tuple) -> None:
    layout = init_distributed(rank=rank, world=world, init_method=init_method,
                              device=device, agent=agent)
    try:
        fn(layout, *args)
    finally:
        layout.close()


def spawn(fn: Callable, world: int, args: tuple = (), device: str = "cuda",
          agent: int = 1, timeout_s: float = 3600.0) -> None:
    """Run ``fn(layout, *args)`` in ``world`` spawned local ranks (a
    ``file://`` rendezvous in a fresh directory) and wait for all of them;
    raise if one fails or outlives ``timeout_s`` (the others are stopped).
    ``fn`` must be importable by module path."""
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards, have "
                           f"{torch.cuda.device_count()}")
    work = tempfile.mkdtemp(prefix="map_ranks_")
    init_method = "file://" + os.path.join(work, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                         args=(r, world, init_method, device, agent, fn, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        pending = list(procs)
        while pending:
            for p in list(pending):
                p.join(timeout=0.2)
                if p.exitcode is not None:
                    pending.remove(p)
                    if p.exitcode != 0:
                        raise RuntimeError(f"{p.name} of {world} failed (exit code "
                                           f"{p.exitcode})")
            if pending and time.monotonic() > deadline:
                raise TimeoutError(f"ranks {[p.name for p in pending]} still running "
                                   f"after {timeout_s:.0f} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)
