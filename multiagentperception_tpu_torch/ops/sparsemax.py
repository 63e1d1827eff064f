"""Sparsemax (Martins & Astudillo 2016) as a ``torch.autograd.Function``
(port of multiagentperception_tpu/ops/sparsemax.py).

The Euclidean projection of the logits onto the simplex along ``dim``: a
sort-based threshold in float32, after subtracting the row's maximum (a
constant, outside the gradient). The backward is the reference's rule
(ptsemseg/models/utils.py:878-887, JAX ops/sparsemax.py:56-62),
``support * (g - sum(g * support) / max(|support|, 1))`` with ``support``
the non-zero outputs. It runs on the tiny (B, N) graph logits of the SRMS
attentions, so plain PyTorch ops are all it needs.
"""

from __future__ import annotations

import torch


def _sparsemax_last(z: torch.Tensor) -> torch.Tensor:
    """Sparsemax along the last axis of a float32 tensor (JAX :18-30)."""
    z = z - z.amax(dim=-1, keepdim=True)
    n = z.shape[-1]
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    k_range = torch.arange(1, n + 1, dtype=z.dtype, device=z.device)
    support = (1.0 + k_range * z_sorted) > torch.cumsum(z_sorted, dim=-1)
    k = torch.where(support, k_range, torch.zeros_like(z_sorted)).amax(dim=-1, keepdim=True)
    tau_sum = torch.where(support, z_sorted, torch.zeros_like(z_sorted)).sum(dim=-1,
                                                                             keepdim=True)
    return torch.clamp_min(z - (tau_sum - 1.0) / k, 0.0)


class Sparsemax(torch.autograd.Function):
    """``Sparsemax.apply(logits, dim)``: sparsemax along ``dim``, computed in
    float32 and returned in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, dim: int) -> torch.Tensor:
        moved = logits.detach().movedim(dim, -1)
        out = _sparsemax_last(moved.float()).to(logits.dtype).movedim(-1, dim)
        ctx.dim = dim
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (out,) = ctx.saved_tensors
        support = (out != 0).to(g.dtype)
        s = (g * support).sum(dim=ctx.dim, keepdim=True)
        cnt = torch.clamp_min(support.sum(dim=ctx.dim, keepdim=True), 1.0)
        return support * (g - s / cnt), None


def sparsemax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sparse alternative to softmax along ``dim``."""
    return Sparsemax.apply(logits, dim)
