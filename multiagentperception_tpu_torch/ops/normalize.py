"""On-device input normalization (port of multiagentperception_tpu/ops/normalize.py).

Raw uint8 RGB frames cross the host link (3 bytes/pixel instead of 12) and
are normalized on the card: RGB->BGR, subtract the mean, /255 — the
reference transform (airsim_loader.py:515-540).
"""

from __future__ import annotations

import functools

import torch

# ImageNet-ish BGR mean, the reference's airsim constant (airsim_loader.py:191)
MEAN_RGB = (103.939, 116.779, 123.68)


def normalize_images(images: torch.Tensor, img_norm: bool = True,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 RGB (..., H, W, 3) -> normalized BGR float, channels last."""
    x = images.to(dtype).flip(-1)  # RGB -> BGR
    x = x - _mean(dtype, x.device)
    if img_norm:
        x = x / 255.0
    return x


@functools.lru_cache(maxsize=None)
def _mean(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``MEAN_RGB`` on ``device``, copied there once (a CUDA graph reads it
    where it lies, and a copy from the host could not be captured)."""
    with torch.inference_mode(False):
        return torch.tensor(MEAN_RGB, dtype=dtype, device=device)
