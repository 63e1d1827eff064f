"""MIMO general dot-product attention (port of
multiagentperception_tpu/models/attention.py:81-108; reference agent.py:242-286).

Queries ``(B, Q, query_size)``, keys ``(B, K, key_size)``, values
``(B, K, ...)``; returns the fused values ``(B, Q, ...)`` and the graph
``(B, K, Q)``, softmaxed over keys. The reference's ``sparse`` flag is
ignored here as it is there.
"""

from __future__ import annotations

import torch
from torch import nn

from multiagentperception_tpu_torch.ops.comm import fuse_values


class MIMOGeneralDotAttention(nn.Module):
    def __init__(self, query_size: int, key_size: int):
        super().__init__()
        self.linear = nn.Linear(query_size, key_size)

    def project(self, q: torch.Tensor) -> torch.Tensor:
        """Q' = W q, the projected queries the fused comm kernel consumes."""
        return self.linear(q)

    def graph(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """(B, K, Q) softmax over keys of K Q'^T, in float32 (or float64)."""
        logits = torch.einsum("bkd,bqd->bkq", k, self.project(q))
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        return torch.softmax(logits, dim=1)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        coef = self.graph(q, k)
        return fuse_values(coef, v), coef
