"""Segmentation losses (port of multiagentperception_tpu/loss.py; reference
ptsemseg/loss/loss.py, loss/__init__.py).

Logits are NCHW ``(B, C, H, W)``; targets ``(B, H, W)`` of any integer type
(the trainer ships them as uint8). Semantics are the JAX package's:

- ``cross_entropy2d`` resizes the logits to the label size with
  ``align_corners=True`` only when the two differ, ignores pixels labelled
  250, and averages over the pixels it keeps; a batch whose every pixel is
  ignored gives 0, not NaN (the mean divides by ``max(count, 1)``).
- ``multi_scale_cross_entropy2d`` weighs a tuple of outputs 1.0, 0.4, 0.16...
- ``bootstrapped_cross_entropy2d`` averages each image's K largest pixel
  losses (unweighted, as the JAX package's).

bf16 or float16 logits (mixed precision) are resized in their type and
then upcast: the log-softmax and the mean run in float32, as in JAX
(loss.py:41-44, 94). There is no loss scaling in either type (JAX has none).

Under data parallel (and the agent ring's training) each rank holds a
share of the pixels JAX's jit averages over; ``group`` (a
``parallel.Group``) makes each loss the rank's share of the global mean:
``cross_entropy2d`` divides its sum by the group's count of kept pixels
(all-reduced), ``bootstrapped_cross_entropy2d`` by the group's count of
images. Summed over the group's ranks — the gradients' all-reduce sums
them — that is the single-process loss on the global batch, also when the
ranks hold different numbers of ignored pixels. Without a group, or with
one that moves nothing, nothing changes.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from multiagentperception_tpu_torch.ops.resize import bilinear_resize
from multiagentperception_tpu_torch.parallel.collectives import Group, all_reduce_sum

IGNORE_INDEX = 250


def _pixel_nll(logits: torch.Tensor, target: torch.Tensor, weight=None):
    """Per-pixel (weighted) NLL in float32 (float64 logits stay float64),
    0 at ignored pixels, and the weight each pixel carries in the mean (0 at
    ignored pixels)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    tgt = target.long()
    valid = tgt != IGNORE_INDEX
    w = None if weight is None else torch.as_tensor(weight, dtype=logits.dtype,
                                                    device=logits.device)
    nll = F.cross_entropy(logits, tgt, weight=w, ignore_index=IGNORE_INDEX,
                          reduction="none")
    if w is None:
        return nll, valid.to(nll.dtype)
    return nll, w[torch.where(valid, tgt, 0)] * valid


def _global(count: torch.Tensor, group: Group | None) -> torch.Tensor:
    """``count`` summed over ``group``'s ranks (as it is without one)."""
    return count if group is None else all_reduce_sum(count, group)


def cross_entropy2d(input: torch.Tensor, target: torch.Tensor, weight=None,
                    size_average: bool = True, group: Group | None = None) -> torch.Tensor:
    """Pixelwise cross-entropy (reference: loss/loss.py:5-19)."""
    logits = bilinear_resize(input, *target.shape[-2:], align_corners=True)
    nll, denom = _pixel_nll(logits, target, weight)
    if size_average:
        return nll.sum() / _global(denom.sum().detach(), group).clamp(min=1.0)
    return nll.sum()


def multi_scale_cross_entropy2d(input, target, weight=None, size_average=True,
                                scale_weight=None, group: Group | None = None):
    """Aux-head weighted sum (reference: loss/loss.py:22-37)."""
    if not isinstance(input, (tuple, list)):
        return cross_entropy2d(input, target, weight, size_average, group)
    if scale_weight is None:
        scale_weight = [0.4 ** i for i in range(len(input))]
    loss = 0.0
    for w, inp in zip(scale_weight, input):
        loss = loss + w * cross_entropy2d(inp, target, weight, size_average, group)
    return loss


def bootstrapped_cross_entropy2d(input, target, K: int, weight=None,
                                 size_average=True, group: Group | None = None):
    """Per-image top-K hardest-pixel loss (reference: loss/loss.py:40-68);
    the logits must already have the labels' size."""
    nll, _ = _pixel_nll(input, target)
    topk = nll.reshape(nll.shape[0], -1).topk(K, dim=1).values
    per_image = topk.sum(1) / K
    if group is None:
        return per_image.mean()
    images = _global(per_image.new_full((), per_image.shape[0]), group)
    return per_image.sum() / images


KEY2LOSS: dict[str, Callable] = {
    "cross_entropy": cross_entropy2d,
    "bootstrapped_cross_entropy": bootstrapped_cross_entropy2d,
    "multi_scale_cross_entropy": multi_scale_cross_entropy2d,
}


def get_loss_function(cfg) -> Callable:
    """Loss registry (reference: loss/__init__.py:20-34)."""
    loss_dict = cfg["training"].get("loss")
    if loss_dict is None:
        return cross_entropy2d
    name = loss_dict["name"]
    if name not in KEY2LOSS:
        raise NotImplementedError(f"Loss {name} not implemented")
    params = {k: v for k, v in loss_dict.items() if k != "name"}
    return functools.partial(KEY2LOSS[name], **params)
