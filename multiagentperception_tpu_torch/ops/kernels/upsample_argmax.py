"""Fused bilinear upsample + class argmax: the eval epilogue's kernel (K1).

Port of the TPU kernel ``multiagentperception_tpu/ops/pallas/upsample_argmax.py``
(``upsample_argmax_pallas``). ``upsample_argmax`` takes the decoder's
pre-upsample logits NCHW ``(B*N, C, h, w)`` and returns the ``(B*N, H, W)``
int32 class map of their bilinear resize (``align_corners=False``), ties to
the lowest class. The logits are float32, bfloat16 or float16 (the
mixed-precision models' output); the resize and the compares run in
float32, as the TPU kernel upcasts each class's slice
(upsample_argmax.py:38). On a CUDA tensor it launches
``csrc/upsample_argmax.cu`` (entry point ``upsample_argmax_f32``,
``upsample_argmax_bf16`` or ``upsample_argmax_f16``, counted in
``upsample_argmax.route_launches``), which never writes the
full-resolution logits; on a CPU tensor it runs ``upsample_argmax_plain``,
the same function in plain PyTorch, and so it does on a ``meta`` tensor,
which computes nothing (the bench counts the model's FLOPs on them). On CPU
and CUDA tensors the wrapper calls the custom op ``when2com::upsample_argmax``
(``torch.library``): its CPU implementation is the plain version, its CUDA
one the launch (which counts), and its fake one only allocates the class
map, so ``torch.export`` keeps the op as one node of the graph. The kernel
takes its span path (a lane per run of ``SPAN`` output columns, the class
loop unrolled) where ``shared_spans`` holds for the output width and the
logits have the model's 11 classes, and its per-pixel path elsewhere. A
block stages ``plan(C, w)`` output rows of the vertical interpolation in
shared memory: 16 (the flagship's), or fewer where 16 rows of C x w floats
exceed what a block may hold; logits too wide for one row take the direct
kernel, which stages nothing. No width is refused.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multiagentperception_tpu_torch.ops.kernels import _build
from multiagentperception_tpu_torch.ops.resize import _weight_matrix, bilinear_resize

ROWS = (16, 8, 4, 2, 1)  # output rows a block may stage (kRows in csrc/upsample_argmax.cu)
SHARED_OPTIN = 232448  # bytes of shared memory a block may opt in to on Hopper (227 KB)
SPAN = 4  # output columns a thread owns on the kernel's span path
MAX_GRID_Y = 65535  # the CUDA grid's y extent: images
# dtype of the logits: (route, C entry point); the kernel stages float32 either way
ROUTES = {torch.float32: ("f32", "upsample_argmax_f32"),
          torch.bfloat16: ("bf16", "upsample_argmax_bf16"),
          torch.float16: ("f16", "upsample_argmax_f16")}


def upsample_argmax_plain(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """argmax over classes of the dense two-matmul bilinear resize."""
    return torch.argmax(bilinear_resize(x.float(), out_h, out_w), dim=1).to(torch.int32)


@functools.lru_cache(maxsize=16)
def _taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """Each output row's (at most two) taps of ``_weight_matrix(src, dst)``:
    int32 indices and f32 weights, both (dst, 2); a one-tap row gets a second
    tap of weight 0 on the same index."""
    wm = _weight_matrix(src, dst, False)
    idx = np.zeros((dst, 2), np.int32)
    wt = np.zeros((dst, 2), np.float32)
    for o in range(dst):
        nz = np.nonzero(wm[o])[0]
        if not 1 <= len(nz) <= 2:
            raise AssertionError(f"bilinear row {o} has {len(nz)} taps")
        idx[o, :] = nz[0]
        idx[o, : len(nz)] = nz
        wt[o, : len(nz)] = wm[o, nz]
    return idx, wt


@functools.lru_cache(maxsize=16)
def shared_spans(src: int, dst: int) -> bool:
    """Whether the kernel's span path holds for a resize of ``src`` columns
    to ``dst``: ``dst`` is a multiple of ``SPAN`` and every aligned run of
    ``SPAN`` output columns has the same two tap indices in ``_taps``, so
    one thread reads them once and weighs them per column."""
    if dst % SPAN:
        return False
    idx = _taps(src, dst)[0].reshape(dst // SPAN, SPAN, 2)
    return bool((idx == idx[:, :1]).all())


@functools.lru_cache(maxsize=None)
def _device_taps(h: int, out_h: int, w: int, out_w: int, device: torch.device):
    """(row idx, row wt, col idx, col wt) on ``device``, built once per shape
    and never evicted: a CUDA graph that captured a launch reads them where
    they lie."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in (*_taps(h, out_h), *_taps(w, out_w)))


def plan(c: int, w: int) -> int:
    """The output rows a block of the kernel stages for logits of ``c``
    classes and ``w`` columns: the largest of ROWS whose ``rows x c x w``
    float32 values (whatever the logits' type) and the rows' taps
    (16 bytes a row) fit in SHARED_OPTIN, or 0 where not even one row
    fits: the direct kernel, which stages nothing."""
    for rows in ROWS:
        if rows * (c * w * 4 + 16) <= SHARED_OPTIN:
            return rows
    return 0


def upsample_argmax(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B*N, C, h, w) float32, bfloat16 or float16 logits -> (B*N, out_h,
    out_w) int32 class map."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW logits, got shape {tuple(x.shape)}")
    if x.device.type == "meta":
        return upsample_argmax_plain(x, out_h, out_w)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return OP(x, out_h, out_w)


def class_map(logits: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The ``(B', out_h, out_w)`` int32 class map of a forward's logits with
    ``full_res=False``: ``upsample_argmax`` of a decoder's pre-upsample
    logits, or, where the decoder has none and its logits are already
    ``(out_h, out_w)`` (``n_segnet_decoder``), their argmax over classes,
    ties to the lowest (JAX trainer.py:512-517), with no kernel."""
    if tuple(logits.shape[-2:]) == (out_h, out_w):
        return logits.argmax(1).to(torch.int32)
    return upsample_argmax(logits, out_h, out_w)


@torch.library.custom_op("when2com::upsample_argmax", mutates_args=(), device_types="cpu")
def upsample_argmax_op(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return upsample_argmax_plain(x, out_h, out_w)


@upsample_argmax_op.register_fake
def _fake(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return x.new_empty((x.shape[0], out_h, out_w), dtype=torch.int32)


def _launch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The op's CUDA implementation: the kernel, or an error."""
    if x.dtype not in ROUTES:
        raise TypeError(f"upsample_argmax kernel takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("upsample_argmax kernel takes contiguous NCHW logits")
    n, c, h, w = x.shape
    if n == 0 or c == 0 or out_h <= 0 or out_w <= 0:
        raise ValueError(f"empty upsample_argmax: {tuple(x.shape)} -> {out_h}x{out_w}")
    if n > MAX_GRID_Y:
        raise ValueError(f"upsample_argmax kernel: {n} images exceed the grid's {MAX_GRID_Y}")
    yi, yw, xi, xw = _device_taps(h, out_h, w, out_w, x.device)
    out = torch.empty((n, out_h, out_w), dtype=torch.int32, device=x.device)
    route, entry = ROUTES[x.dtype]
    lib = _build.load("upsample_argmax")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), n, c, h, w, yi.data_ptr(), yw.data_ptr(),
            xi.data_ptr(), xw.data_ptr(), out_h, out_w, int(shared_spans(w, out_w)),
            plan(c, w), out.data_ptr(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"upsample_argmax kernel launch failed: CUDA error {rc}")
    upsample_argmax.route_launches[route] += 1
    upsample_argmax.launches += 1
    return out


# registered straight with the dispatcher, without custom_op's per-call
# Python wrapper (PERF.md section 6: its host cost on the int8 eval path)
torch.library.impl("when2com::upsample_argmax", "cuda", _launch)
OP = torch.ops.when2com.upsample_argmax.default  # what the wrapper calls

upsample_argmax.launches = 0
upsample_argmax.route_launches = {route: 0 for route, _ in ROUTES.values()}
