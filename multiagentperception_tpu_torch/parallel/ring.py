"""Agent-axis parallelism: the communication step as a ring over ranks
(port of multiagentperception_tpu/parallel/ring.py:38-145).

Each rank of an agent group holds N/A agents' queries, keys and values.
``sharded_comm_step`` mirrors the dense step's semantics (``ops.comm``,
``comm_fusion``): the keys are all-gathered (they are small), each rank
builds the graph's columns of its own queries — a softmax over all N keys,
+``diag_bias`` on the global self-link, then the mode's mask (``activated``
keeps weights strictly above ``thres``, ``argmax`` the lowest-index
maximum; ``softmax`` fuses with the unbiased weights) — and
``ring_fuse_values`` accumulates the fusion from the value shard it holds
while the shards rotate round the ring, so the full value tensor is never
on one rank. The graphs come back sharded on the query axis.

Both are differentiable: the fusion's backward runs the reverse ring for
dV (an accumulator travels the other way) and the ring's transpose for the
graph's gradient (the value shards rotate again); the keys' all-gather has
a reduce-scatter for backward (an all-reduce and this rank's slice). The
comm kernel (K2) is not on this path, as the JAX ring does not reach the
Pallas kernel, so K2's agent limit does not bind here.
"""

from __future__ import annotations

import torch

from multiagentperception_tpu_torch.ops.comm import one_hot_argmax
from multiagentperception_tpu_torch.parallel.collectives import (
    Group,
    all_gather_cat,
    all_reduce_sum,
    ring_shift,
)

MODES = ("softmax", "activated", "argmax")


class _GatherKeys(torch.autograd.Function):
    """(B, Kl, D) per rank -> (B, N, D) on every rank; backward: the sum of
    every rank's gradient, this rank's rows of it."""

    @staticmethod
    def forward(ctx, k_local: torch.Tensor, group: Group):
        ctx.group, ctx.local = group, k_local.shape[1]
        return all_gather_cat(k_local, group, dim=1)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_sum(grad.contiguous(), ctx.group)
        start = ctx.group.rank * ctx.local
        return total[:, start:start + ctx.local].contiguous(), None


def gather_keys(k_local: torch.Tensor, group: Group) -> torch.Tensor:
    return _GatherKeys.apply(k_local, group)


class _RingFuse(torch.autograd.Function):
    """coef_local (B, N, Ql) (every key's weight for the local queries),
    vals_local (B, Kl, M) -> (B, Ql, M) = Σ over all N keys of coef * value."""

    @staticmethod
    def forward(ctx, coef: torch.Tensor, vals: torch.Tensor, group: Group):
        s, idx, kl = group.size, group.rank, vals.shape[1]
        acc = vals.new_zeros((vals.shape[0], coef.shape[2], vals.shape[2]))
        v = vals
        for i in range(s):
            src = (idx - i) % s  # after i shifts this rank holds rank src's shard
            part = coef[:, src * kl:(src + 1) * kl].to(v.dtype)
            acc = acc + torch.bmm(part.transpose(1, 2), v)
            if i < s - 1:
                v = ring_shift(v, group, 1)
        ctx.save_for_backward(coef, vals)
        ctx.group = group
        return acc

    @staticmethod
    def backward(ctx, grad):
        coef, vals = ctx.saved_tensors
        group = ctx.group
        s, idx, kl = group.size, group.rank, vals.shape[1]
        grad = grad.contiguous()
        d_coef = torch.zeros_like(coef)
        d_vals = torch.zeros_like(vals)
        v = vals
        for i in range(s):
            src = (idx - i) % s  # the value shard held, as in the forward
            d_coef[:, src * kl:(src + 1) * kl] = torch.bmm(
                v, grad.transpose(1, 2)).to(coef.dtype)
            # the accumulator of shard idx + 1 + i, on its way back to its owner
            dst = (idx + 1 + i) % s
            part = coef[:, dst * kl:(dst + 1) * kl].to(vals.dtype)
            d_vals = d_vals + torch.bmm(part, grad)
            if i < s - 1:
                v = ring_shift(v, group, 1)
                d_vals = ring_shift(d_vals, group, -1)
        return d_coef, d_vals, None


def ring_fuse_values(coef_local: torch.Tensor, vals_local: torch.Tensor,
                     group: Group) -> torch.Tensor:
    """Ring-scheduled ``fuse_values`` with the key/value axis sharded:
    coef_local (B, N, Ql), vals_local (B, Kl, M) -> (B, Ql, M)."""
    return _RingFuse.apply(coef_local, vals_local, group)


def sharded_comm_step(query_proj: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                      group: Group, mode: str = "softmax", diag_bias: float = 0.0,
                      thres: float = 0.2):
    """This rank's share of the agent-sharded communication step.

    query_proj (B, Ql, D) (the projected local queries), keys (B, Kl, D),
    vals (B, Kl, *rest) -> (fused (B, Ql, *rest), coef (B, N, Ql), soft
    (B, N, Ql)): ``soft`` the pre-mask graph, ``coef`` the masked one (in
    ``softmax`` mode ``soft``), both the local query columns."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    b, q_local = query_proj.shape[:2]
    k_local = vals.shape[1]
    n = k_local * group.size
    k_all = gather_keys(keys, group)
    logits = torch.einsum("bkd,bqd->bkq", k_all, query_proj)
    unbiased = torch.softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=1)
    coef = unbiased
    if diag_bias:
        queries = group.rank * q_local + torch.arange(q_local, device=vals.device)
        eye = torch.arange(n, device=vals.device)[:, None] == queries[None, :]
        coef = coef + diag_bias * eye.to(coef.dtype)
    soft = coef
    if mode == "activated":
        coef = torch.where(coef > thres, coef, torch.zeros_like(coef))
    elif mode == "argmax":
        coef = one_hot_argmax(coef, dim=1)
    else:  # the soft fusion takes the unbiased weights (JAX ring.py:100-104)
        coef = unbiased
    fused = ring_fuse_values(coef, vals.reshape(b, k_local, -1), group)
    fused = fused.reshape((b, q_local) + tuple(vals.shape[2:]))
    return fused, soft if mode == "softmax" else coef, soft
