"""Communication-graph ops (port of multiagentperception_tpu/ops/comm.py).

Conventions as in the JAX package: a coefficient matrix is ``(B, K, Q)`` —
entry ``[b, k, q]`` weighs key/supporter ``k`` in the fusion for
query/requester ``q``. Value maps are ``(B, K, ...)``: the port keeps them
NCHW per agent, the JAX package NHWC; the fusion does not care which.
"""

from __future__ import annotations

import torch


def fuse_values(coef: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """coef (B, K, Q), vals (B, K, *rest) -> (B, Q, *rest), one batched GEMM."""
    b, k = vals.shape[:2]
    out = torch.bmm(coef.to(vals.dtype).transpose(1, 2), vals.reshape(b, k, -1))
    return out.reshape((b, coef.shape[2]) + tuple(vals.shape[2:]))


def one_hot_argmax(prob: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """One-hot of the argmax along ``dim`` (ties: lowest index), same dtype."""
    idx = torch.argmax(prob, dim=dim, keepdim=True)
    return torch.zeros_like(prob).scatter_(dim, idx, 1.0)


def num_connect_offdiag(coef: torch.Tensor, agent_num: int) -> torch.Tensor:
    """MIMO bandwidth: off-diagonal non-zeros / (agent_num * B)
    (reference: agent.py:1050-1056, 1070-1077), as float32.

    The quotient is taken in float64 and rounded once: a float32 division
    by a scalar runs as a product with the reciprocal on CUDA, one ulp away
    from the CPU's division, and the card and the CPU must agree."""
    b, k, q = coef.shape
    eye = torch.eye(k, q, dtype=torch.bool, device=coef.device)
    offdiag = coef.masked_fill(eye, 0.0)
    return ((offdiag != 0).sum().to(torch.float64) / (agent_num * b)).to(torch.float32)


def drop_diagonal_softmax(logits: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Softmax over keys with self-links removed (port of ops/comm.py:122-133):
    the diagonal is masked to ``-inf`` before the softmax, so the other K-1
    keys renormalize, and written back as exact zeros."""
    k, q = logits.shape[-2:]
    eye = torch.eye(k, q, dtype=torch.bool, device=logits.device)
    out = torch.softmax(logits.masked_fill(eye, float("-inf")), dim=dim)
    return out.masked_fill(eye, 0.0)


def argmax_select(vals: torch.Tensor, prob: torch.Tensor, agent_num: int):
    """Hard top-1 graph. Returns (fused, coef (B, K, Q), num_connect)."""
    coef = one_hot_argmax(prob, dim=1)
    return fuse_values(coef, vals), coef, num_connect_offdiag(coef, agent_num)


def activated_select(vals: torch.Tensor, prob: torch.Tensor, agent_num: int,
                     thres: float = 0.2):
    """Thresholded graph: prune links with attention <= thres (strict >)."""
    coef = torch.where(prob > thres, prob, torch.zeros_like(prob))
    return fuse_values(coef, vals), coef, num_connect_offdiag(coef, agent_num)


def _topk_mask(prob: torch.Tensor, k: int) -> torch.Tensor:
    """(B, K, Q) -> per query, the keys at least as strong as its k-th
    strongest: every key tied with the k-th is kept, so a tie keeps more
    than k links (JAX ops/comm.py:89-90, ``pq >= kth``). k lies in 1..K."""
    if not 1 <= k <= prob.shape[1]:
        raise ValueError(f"topk: k={k} links of {prob.shape[1]} keys")
    kth = torch.topk(prob, k, dim=1).values[:, -1:]  # (B, 1, Q)
    return prob >= kth


def topk_select(vals: torch.Tensor, prob: torch.Tensor, agent_num: int, k: int):
    """Bandwidth-constrained graph (port of ops/comm.py:80-95; not in the
    reference): per query, the top-k keys' weights (ties with the k-th
    kept), renormalized by ``max(sum, 1e-12)``, the rest zero. Returns
    (fused, coef (B, K, Q), num_connect)."""
    kept = torch.where(_topk_mask(prob, k), prob, torch.zeros_like(prob))
    coef = kept / torch.clamp_min(kept.sum(dim=1, keepdim=True), 1e-12)
    return fuse_values(coef, vals), coef, num_connect_offdiag(coef, agent_num)


def per_frame_links(prob: torch.Tensor, inference: str, agent_num: int,
                    topk_k: int = 2, thres: float = 0.2) -> torch.Tensor:
    """Per-sample bandwidth (port of ops/comm.py:98-119): off-diagonal links
    per agent of each batch element, ``(B,)`` float32. The mode's mask is
    applied again to the returned ``(B, K, Q)`` graph (``topk`` keeps the
    ``topk_k`` strongest keys and those tied with them, unnormalized), so
    the mean equals ``num_connect_offdiag`` of the pruned graph;
    ``softmax`` (the full graph) gives K-1. Each quotient is taken in
    float64 and rounded once, as ``num_connect_offdiag``."""
    b, k, q = prob.shape
    if inference == "argmax_test":
        coef = one_hot_argmax(prob, dim=1)
    elif inference == "activated":
        coef = torch.where(prob > thres, prob, torch.zeros_like(prob))
    elif inference == "topk":
        coef = torch.where(_topk_mask(prob, topk_k), prob, torch.zeros_like(prob))
    else:  # softmax: the full graph
        return torch.full((b,), float(k - 1), dtype=torch.float32, device=prob.device)
    eye = torch.eye(k, q, dtype=torch.bool, device=prob.device)
    links = (coef.masked_fill(eye, 0.0) != 0).sum(dim=(1, 2))
    return (links.to(torch.float64) / agent_num).to(torch.float32)


def confusion_matrix(label_true: torch.Tensor, label_pred: torch.Tensor,
                     n_classes: int,
                     sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(C, C) int64 confusion matrix on the tensors' device, rows=true.

    Same accounting as the reference's ``_fast_hist`` (metrics.py:99-106):
    pixels whose true label lies outside [0, C) (the ignore index 250) are
    dropped. ``sample_mask`` (one flag per leading-dim element) gives the
    normal/noise split. Dropped pixels land in an overflow bin, and the
    bins are a scatter-add of ones: no data-dependent shape and no host
    sync (``torch.bincount`` reads its input's range back on CUDA), so a
    CUDA graph can capture it. Each image row adds into C*C + 1 int32 bins
    of its own, summed at the end: 122 shared bins would serialize the
    card's atomics.
    """
    t = label_true.reshape(label_true.shape[0], -1).to(torch.int64)
    p = label_pred.reshape(label_pred.shape[0], -1).to(torch.int64)
    valid = (t >= 0) & (t < n_classes)
    if sample_mask is not None:
        valid = valid & sample_mask.reshape(-1, 1).to(torch.bool)
    bins = n_classes * n_classes + 1
    idx = t * n_classes + p.clamp(0, n_classes - 1)
    idx = torch.where(valid, idx, torch.full_like(idx, bins - 1))
    rows = idx.reshape(-1, label_true.shape[-1])
    slots = rows + (torch.arange(rows.shape[0], device=rows.device) * bins).unsqueeze(1)
    counts = torch.zeros(rows.shape[0] * bins, dtype=torch.int32, device=rows.device)
    ones = torch.ones((), dtype=torch.int32, device=rows.device).expand(slots.numel())
    counts.scatter_add_(0, slots.reshape(-1), ones)
    hist = counts.view(rows.shape[0], bins).sum(0, dtype=torch.int64)
    return hist[: n_classes * n_classes].reshape(n_classes, n_classes)
