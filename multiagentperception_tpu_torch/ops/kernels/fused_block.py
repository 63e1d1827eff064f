"""Fused eval-mode ResNet basic block (K3).

Port of the TPU kernel ``multiagentperception_tpu/ops/pallas/fused_block.py``
(``fused_basic_block``, bodies ``_kernel_pair`` and ``_kernel_plain``)::

    out = relu(s2 * conv2(relu(s1 * conv1(x) + b1)) + b2 + x)

3x3 stride-1 convolutions with zero padding at the image border and
BatchNorm folded into per-channel ``(s, b)`` by ``fold_bn``. The layout is
the JAX function's: ``x`` ``(B, H, W, C)``, ``w1``/``w2`` ``(3, 3, C, C)``
HWIO, ``s``/``b`` ``(C,)`` float32, the output ``(B, H, W, C)`` in
``x.dtype``. Weights are cast to ``x.dtype``, the convolutions accumulate
in float32, and ``y1 = relu(s1 * conv1(x) + b1)`` is rounded to ``x.dtype``
before conv2 sees it; outside the image conv2 sees zeros, never
``relu(b1)``. The residual is added in float32.

The JAX function's ``tile``, ``pair`` and ``interpret`` arguments choose the
TPU kernel's layout and change nothing in the result, so they are not
taken here.

On CUDA tensors ``fused_basic_block`` launches ``csrc/fused_block.cu``
(float32 or bfloat16, C in 64/128/256/512, any H and W); on CPU tensors it
runs ``fused_basic_block_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multiagentperception_tpu_torch.ops.kernels import _build

CHANNELS = (64, 128, 256, 512)  # ResNet-18's stride-1 blocks; instantiated in csrc
DTYPES = (torch.float32, torch.bfloat16)


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as a per-channel ``(s, b)``: ``y = x * s + b`` (f32)."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


def _oihw(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO weights, rounded to ``dtype``, as an OIHW float32 conv kernel."""
    return w.to(dtype).float().permute(3, 2, 0, 1)


def fused_basic_block_plain(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """The block with ``F.conv2d`` on float32 copies of ``x.dtype`` values:
    bf16 products are exact in float32, so this is the kernel's arithmetic
    up to the order of the sums."""
    xc = x.permute(0, 3, 1, 2).float()

    def affine(v, s, b):
        return v * s.float()[:, None, None] + b.float()[:, None, None]

    y = torch.relu(affine(F.conv2d(xc, _oihw(w1, x.dtype), padding=1), s1, b1))
    y = y.to(x.dtype).float()
    y = affine(F.conv2d(y, _oihw(w2, x.dtype), padding=1), s2, b2) + xc
    return torch.relu(y).to(x.dtype).permute(0, 2, 3, 1)


def fused_basic_block(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C) in ``x.dtype``; see the module docstring."""
    if x.dim() != 4:
        raise ValueError(f"expected x (B, H, W, C), got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_basic_block_plain(x, w1, s1, b1, w2, s2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"fused_basic_block kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_basic_block kernel takes a contiguous (B, H, W, C) x")
    bsz, h, w, c = x.shape
    if c not in CHANNELS:
        raise ValueError(f"fused_basic_block kernel takes C in {CHANNELS}, got {c}")
    if not (0 < bsz <= 65535) or h == 0 or w == 0:
        raise ValueError(f"fused_basic_block kernel: unsupported B={bsz}, H={h}, W={w}")
    for name, t, shape in (("w1", w1, (3, 3, c, c)), ("w2", w2, (3, 3, c, c)),
                           ("s1", s1, (c,)), ("b1", b1, (c,)),
                           ("s2", s2, (c,)), ("b2", b2, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    w1k, w2k = (wt.to(x.dtype).contiguous() for wt in (w1, w2))
    if w1k.data_ptr() % 16 or w2k.data_ptr() % 16:
        raise ValueError("fused_basic_block kernel reads weights as 16-byte vectors: "
                         "pass w1/w2 that start 16-byte aligned")
    s1k, b1k, s2k, b2k = (v.float().contiguous() for v in (s1, b1, s2, b2))
    out = torch.empty_like(x)
    lib = _build.load("fused_block")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_basic_block(
            x.data_ptr(), w1k.data_ptr(), s1k.data_ptr(), b1k.data_ptr(),
            w2k.data_ptr(), s2k.data_ptr(), b2k.data_ptr(), out.data_ptr(),
            bsz, h, w, c, int(x.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_basic_block kernel launch failed: CUDA error {rc}")
    fused_basic_block.launches += 1
    return out


fused_basic_block.launches = 0
