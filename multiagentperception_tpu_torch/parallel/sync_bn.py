"""BatchNorm's training statistics over a group of ranks, as JAX's global
jit computes them (multiagentperception_tpu/models/blocks.py:64-74).

Under data parallel (and in the agent ring's training) each rank holds a
slice of the rows one BatchNorm normalizes; JAX's jit sees them all, so its
statistics are global. The deep policy convs reduce over only 6-24 rows:
per-rank statistics would be visibly wrong. ``SyncBatchNorm2d``:

- all-reduces Σx, Σx² and the count in float32 (float64 for a float64
  model) in one collective, and normalizes with the global mean and the
  biased variance E[x²] - E[x]², as the JAX ``TorchBatchNorm``;
- moves the running statistics by the momentum towards the global mean and
  ``var * n / (n - 1)`` with the global n (blocks.py:74), and counts the
  batch in ``num_batches_tracked``, as ``nn.BatchNorm2d``;
- differentiates through ``_SyncBatchNormFn``, whose backward all-reduces
  its two sums, Σdy and Σdy·x̂ (the weight's and bias's own gradients stay
  the rank's: the trainer's gradient all-reduce sums them).

In eval mode, on a group of one, or in a module in eval mode
(``freeze_bn_stats``) it is ``nn.BatchNorm2d``. ``attach`` turns a model's
``nn.BatchNorm2d`` modules into it in place (their class changes, nothing
else): no ``state_dict`` key changes, so the weight bridge still loads with
``strict=True``. ``torch.nn.SyncBatchNorm`` does not serve: it all-gathers,
which gloo lacks on CUDA tensors, and its running variance is not
blocks.py:74's.
"""

from __future__ import annotations

import torch
from torch import nn

from multiagentperception_tpu_torch.parallel.collectives import Group, all_reduce_sum


def _channels(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


class _SyncBatchNormFn(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * weight + bias with the group's
    mean and biased variance; returns (y, mean, var, n) in float32 (float64
    for float64 x; y in x's dtype), the last three without gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group: Group):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        stats = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]),
                               group)
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - _channels(mean)) * _channels(invstd)
        y = xhat * _channels(weight) + _channels(bias)
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.group, ctx.x_dtype = group, x.dtype
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dn):
        xhat, invstd, weight, n = ctx.saved_tensors
        dy = dy.to(xhat.dtype)
        c = xhat.shape[1]
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xhat = (dy * xhat).sum((0, 2, 3))
        total = all_reduce_sum(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        dx = _channels(weight * invstd) * (
            dy - _channels(total[:c] / n) - xhat * _channels(total[c:] / n))
        return dx.to(ctx.x_dtype), sum_dy_xhat, sum_dy, None, None


class SyncBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training statistics are the group's
    (module docstring); made by ``attach``, never constructed."""

    group: Group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.group.size == 1:
            return super().forward(x)
        if not isinstance(self.momentum, float):
            raise ValueError("SyncBatchNorm2d takes a float momentum")
        y, mean, var, n = _SyncBatchNormFn.apply(x, self.weight, self.bias, self.eps,
                                                 self.group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * n / (n - 1).clamp_min(1.0))
            self.num_batches_tracked.add_(1)
        return y


def attach(model: nn.Module, group: Group) -> int:
    """Make every ``nn.BatchNorm2d`` of ``model`` a ``SyncBatchNorm2d`` over
    ``group`` (in place; returns how many)."""
    count = 0
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.__class__ = SyncBatchNorm2d
            mod.group = group
            count += 1
    return count
