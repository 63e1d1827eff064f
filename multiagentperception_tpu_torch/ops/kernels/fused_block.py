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

On CUDA tensors ``fused_basic_block`` launches the kernels of one of four
routes, as ``route(dtype, C)`` says (any H and W on each):

- ``"wgmma"``: bfloat16 at C in 64/128 (the bench's layer1 and layer2),
  ``csrc/fused_block_wgmma.cu`` on Hopper's tensor cores;
- ``"tf32x3"``: float32 at C in 64/128 (the eval's layer1 and layer2),
  ``csrc/fused_block_tf32.cu`` on the tensor cores with error-compensated
  3xTF32 products: each float32 operand is split into a TF32 ``hi`` and
  ``lo`` (``tf32_split``) and a product is ``hi*hi + hi*lo + lo*hi``, which
  keeps K3's float32 check (1e-4) where a single TF32 product does not;
- ``"wgmma_conv"``: bfloat16 at C in 256/512 (layer3 and layer4),
  ``csrc/fused_block_wgmma_conv.cu``, and ``"tf32x3_conv"``: float32 there,
  ``csrc/fused_block_tf32_conv.cu``. At these widths a tile's halo, its y1
  ring and one tap's weights do not fit shared memory, so each entry point
  runs the block as two implicit-GEMM convolutions on the tensor cores
  (conv1 into a ``y1`` scratch tensor in ``x.dtype``, then conv2 with the
  residual), with the same products and per-stage sums as the route of
  the same type at C in 64/128.

Each route counts its own blocks in ``fused_basic_block.route_launches``,
and ``fused_basic_block.launches`` counts all four. A route that fails to
build or launch raises; none falls back to another. On CPU tensors the
wrapper runs ``fused_basic_block_plain``, the same function in plain
PyTorch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multiagentperception_tpu_torch.ops.kernels import _build

CHANNELS = (64, 128, 256, 512)  # ResNet-18's stride-1 blocks; instantiated in csrc
DTYPES = (torch.float32, torch.bfloat16)
FUSED_CHANNELS = (64, 128)  # instantiated in fused_block_wgmma.cu and fused_block_tf32.cu
TF32X3_STAGE = {64: 64, 128: 32}  # input channels of a weight stage in fused_block_tf32.cu
ROUTES = ("wgmma", "tf32x3", "wgmma_conv", "tf32x3_conv")
# route: (kernel source in csrc/, its C entry point)
KERNELS = {"wgmma": ("fused_block_wgmma", "fused_basic_block_wgmma"),
           "tf32x3": ("fused_block_tf32", "fused_basic_block_tf32x3"),
           "wgmma_conv": ("fused_block_wgmma_conv", "fused_basic_block_wgmma_conv"),
           "tf32x3_conv": ("fused_block_tf32_conv", "fused_basic_block_tf32x3_conv")}


def route(dtype: torch.dtype, c: int) -> str:
    """The route that takes a (dtype, C) block (one of ``ROUTES``). Raises
    on what no kernel takes."""
    if dtype not in DTYPES:
        raise TypeError(f"fused_basic_block kernel takes float32 or bfloat16, got {dtype}")
    if c not in CHANNELS:
        raise ValueError(f"fused_basic_block kernel takes C in {CHANNELS}, got {c}")
    path = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    return path if c in FUSED_CHANNELS else f"{path}_conv"


def wgmma_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Both convs' HWIO weights in bf16 as the wgmma kernel streams them:
    (2, 9, C/64, 8, C, 8) = [conv][tap][64-channel K chunk][8-channel K
    group][output channel][8 input channels], one 64 x C stage after
    another."""
    c = w1.shape[-1]
    w = torch.stack([w1, w2]).to(torch.bfloat16).reshape(2, 9, c // 64, 8, 8, c)
    return w.permute(0, 1, 2, 3, 5, 4).contiguous()


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest,
    ties away from zero, keeping 10 of the 23 mantissa bits."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``, both TF32 values, with ``hi = tf32_round(v)`` and
    ``lo = tf32_round(v - hi)`` (``v - hi`` is exact in float32)."""
    hi = tf32_round(v)
    return hi, tf32_round(v.float() - hi)


def tf32x3_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Both convs' HWIO weights split by ``tf32_split`` as the tf32x3 kernel
    streams them: (2, 9, C/KS, 2, KS/4, C, 4) float32 = [conv][tap][KS-channel
    K chunk][hi, lo][4-channel K group][output channel][4 input channels],
    KS = ``TF32X3_STAGE[C]``, one stage (hi then lo) after another."""
    c = w1.shape[-1]
    ks = TF32X3_STAGE[c]
    w = torch.stack([w1, w2]).float().reshape(2, 9, c // ks, ks // 4, 4, c)
    hi, lo = tf32_split(w.permute(0, 1, 2, 3, 5, 4))
    return torch.stack([hi, lo], dim=3).contiguous()


def wgmma_conv_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Both convs' HWIO weights in bf16 as the wgmma_conv kernel streams them:
    (2, C/128, C/64, 9, 8, 128, 8) = [conv][128-channel output slice]
    [64-channel K chunk][tap][8-channel K group][output channel][8 input
    channels], one 64 x 128 stage after another. The route's entry point
    arranges them so on the card; this is the layout's reference."""
    c = w1.shape[-1]
    w = torch.stack([w1, w2]).to(torch.bfloat16).reshape(2, 9, c // 64, 8, 8, c // 128, 128)
    return w.permute(0, 5, 2, 1, 3, 6, 4).contiguous()


def tf32x3_conv_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Both convs' HWIO weights split by ``tf32_split`` as the tf32x3_conv
    kernel streams them: (2, C/64, C/64, 9, 2, 16, 64, 4) float32 = [conv]
    [64-channel output slice][64-channel K chunk][tap][hi, lo][4-channel K
    group][output channel][4 input channels], one stage after another. The
    route's entry point arranges them so on the card; this is the layout's
    reference."""
    c = w1.shape[-1]
    w = torch.stack([w1, w2]).float().reshape(2, 9, c // 64, 16, 4, c // 64, 64)
    hi, lo = tf32_split(w.permute(0, 5, 2, 1, 3, 6, 4))
    return torch.stack([hi, lo], dim=4).contiguous()


# the weights that each route's entry point takes: arranged here for the
# fused routes; for the conv routes, HWIO float32 that the entry point
# arranges into a scratch tensor of WEIGHT_SCRATCH[route] * C * C elements
WEIGHTS = {"wgmma": wgmma_weights, "tf32x3": tf32x3_weights}
WEIGHT_SCRATCH = {"wgmma_conv": (2 * 9, torch.bfloat16), "tf32x3_conv": (2 * 9 * 2, torch.float32)}


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
    if not x.is_contiguous():
        raise ValueError("fused_basic_block kernel takes a contiguous (B, H, W, C) x")
    bsz, h, w, c = x.shape
    path = route(x.dtype, c)
    if not (0 < bsz <= 65535) or h == 0 or w == 0:
        raise ValueError(f"fused_basic_block kernel: unsupported B={bsz}, H={h}, W={w}")
    for name, t, shape in (("w1", w1, (3, 3, c, c)), ("w2", w2, (3, 3, c, c)),
                           ("s1", s1, (c,)), ("b1", b1, (c,)),
                           ("s2", s2, (c,)), ("b2", b2, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    out = torch.empty_like(x)
    sb = torch.cat([v.float() for v in (s1, b1, s2, b2)])
    if x.data_ptr() % 16:
        raise ValueError(f"fused_basic_block {path} kernel: x must start 16-byte aligned")
    source, entry = KERNELS[path]
    fn = getattr(_build.load(source), entry)
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        if path in WEIGHTS:
            wk = WEIGHTS[path](w1, w2)
            rc = fn(x.data_ptr(), wk.data_ptr(), sb.data_ptr(), out.data_ptr(), bsz, h, w, c,
                    stream)
        else:  # the weights arranged on the card, conv1 into y1, conv2 with the residual
            w1f, w2f = (t.float().contiguous() for t in (w1, w2))
            per_cc, wk_dtype = WEIGHT_SCRATCH[path]
            wk = torch.empty(per_cc * c * c, dtype=wk_dtype, device=x.device)
            y1 = torch.empty_like(x)
            rc = fn(x.data_ptr(), w1f.data_ptr(), w2f.data_ptr(), wk.data_ptr(), sb.data_ptr(),
                    y1.data_ptr(), out.data_ptr(), bsz, h, w, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_basic_block {path} kernel launch failed: error {rc}")
    fused_basic_block.route_launches[path] += 1
    fused_basic_block.launches += 1
    return out


fused_basic_block.launches = 0
fused_basic_block.route_launches = dict.fromkeys(ROUTES, 0)
