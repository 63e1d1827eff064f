"""Degraded-observation noise injection (reference: ptsemseg/process_img.py:6-35).

The port's own copy of ``multiagentperception_tpu/data/noise.py``; keep the
two in step. The When2com task degrades some agents' views (occlusion,
gaussian, grayscale, lowres); the shipped datasets bake the noise in
offline (``noisy_type: None`` in all configs), and ``data.noisy_type``
applies it online to the requester's view (``data/airsim.py``).

A deliberate difference: the generator is explicit. JAX's copy draws its
gaussian noise from an unseeded ``default_rng()`` when none is passed; here
the caller passes a ``numpy.random.Generator`` (the dataset derives one
from its seed, the epoch and the frame), so worker processes and a resumed
run reproduce the same noise. Given the same generator, both copies return
the same array.
"""

from __future__ import annotations

import numpy as np

NOISE_TYPES = ("occlusion", "gaussian", "grayscale", "lowres")


def generate_noise(img: np.ndarray, noise_type: str | None,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Apply a degradation to an HWC uint8/float image; ``rng`` is needed by
    ``gaussian`` alone. ``None`` / ``"None"`` returns a copy."""
    out = img.copy()
    h = img.shape[0]
    if noise_type == "occlusion":
        # zero the bottom 4/5 rows (reference: process_img.py:10-14)
        out[h // 5:, :, :] = 0
    elif noise_type == "gaussian":
        if rng is None:
            raise ValueError("gaussian noise needs an explicit numpy Generator (rng=)")
        noise = rng.normal(0, 25, img.shape)
        out = np.clip(img.astype(np.float64) + noise, 0, 255).astype(img.dtype)
    elif noise_type == "grayscale":
        gray = img.mean(axis=-1, keepdims=True)
        out = np.broadcast_to(gray, img.shape).astype(img.dtype).copy()
    elif noise_type == "lowres":
        small = out[::4, ::4]
        out = np.repeat(np.repeat(small, 4, axis=0), 4, axis=1)[: img.shape[0], : img.shape[1]]
    elif noise_type in (None, "None"):
        pass
    else:
        raise ValueError(f"Unknown noise type {noise_type}")
    return out
