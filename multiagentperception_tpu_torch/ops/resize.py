"""Bilinear resize as two matmuls (port of multiagentperception_tpu/ops/resize.py).

A separable bilinear resize is two contractions with constant weight
matrices, ``out[b, c] = Wy @ x[b, c] @ Wx^T``. Geometry matches
half-pixel-centered bilinear (torch ``align_corners=False``):
src = (dst + 0.5) / scale - 0.5, edge-clamped; ``align_corners=True`` covers
the reference loss-path resize (loss.py:11).

``_weight_matrix`` is the port's own copy of the JAX package's, so the
upsample+argmax kernel's taps (ops/kernels/upsample_argmax.py) are
bit-identical to the plain version's weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _weight_matrix(src: int, dst: int, align_corners: bool = False) -> np.ndarray:
    """(dst, src) bilinear interpolation weights, rows sum to 1."""
    w = np.zeros((dst, src), dtype=np.float32)
    if align_corners and dst > 1:
        coords = np.arange(dst) * (src - 1) / (dst - 1)
    else:
        coords = (np.arange(dst) + 0.5) * src / dst - 0.5
    lo = np.clip(np.floor(coords).astype(np.int64), 0, src - 1)
    hi = np.clip(lo + 1, 0, src - 1)
    frac = np.clip(coords - np.floor(coords), 0.0, 1.0)
    frac = np.where(coords < 0, 0.0, np.where(coords > src - 1, 0.0, frac))
    rows = np.arange(dst)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    w.setflags(write=False)  # shared by every caller through the cache
    return w


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Separable bilinear resize of NCHW ``x`` via two matmuls (rows first)."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    wy = _device_weights(h, out_h, align_corners, x.dtype, x.device)
    wx = _device_weights(w, out_w, align_corners, x.dtype, x.device)
    return torch.matmul(torch.matmul(wy, x), wx.T)


@functools.lru_cache(maxsize=None)
def _device_weights(src: int, dst: int, align_corners: bool, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``_weight_matrix`` on ``device`` in ``dtype``, copied there once and
    never evicted: a CUDA graph reads it where it lies, and a copy from the
    host could not be captured. Made outside inference mode, so autograd
    may save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_weight_matrix(src, dst, align_corners).copy()).to(
            device=device, dtype=dtype)
