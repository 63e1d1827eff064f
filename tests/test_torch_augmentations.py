"""The port's numpy augmentations (``data/augmentations.py``) against the JAX
package's PIL ones, given the same draws: the JAX copy draws from the global
``random`` seeded with ``random.seed(s)``, the port from ``random.Random(s)``.

Tolerances: flips, crops and translate exact on image and mask; scale and
rotate masks equal on at least 99.5% of pixels and images within one level
of 255 on at least 99% of them; brightness, saturation, contrast, gamma and
hue within one level on every pixel. ``Compose`` chains them in order and
draws in JAX's order; the registry holds JAX's keys.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

import multiagentperception_tpu.data.augmentations as jax_aug
from multiagentperception_tpu_torch.data import augmentations as port_aug

SHAPES = [(64, 64), (48, 80), (37, 53)]
EXACT = [("hflip", 0.5), ("vflip", 0.5), ("rcrop", 30), ("rcrop", (70, 90)), ("ccrop", 31),
         ("ccrop", 90), ("translate", (10, 7))]
GEOMETRIC = [("rotate", 10), ("rotate", 45), ("rotate", 180), ("rotate", 90), ("scale", 40),
             ("scale", 100), ("scale", 23)]
PHOTOMETRIC = [("brightness", 0.5), ("saturation", 0.5), ("contrast", 0.5), ("gamma", 0.5),
               ("hue", 0.5)]


def _pair(shape, smooth: bool, seed: int = 0):
    """An RGB image (random or a smooth ramp) and a class mask."""
    h, w = shape
    rng = np.random.default_rng(seed)
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx * 7 + yy * 2) % 256],
                       -1).astype(np.uint8)
    else:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return img, rng.integers(0, 11, (h, w), dtype=np.uint8)


def _both(aug_dict, img, mask, seed):
    random.seed(seed)
    want = jax_aug.get_composed_augmentations(aug_dict)(img, mask)
    got = port_aug.get_composed_augmentations(aug_dict)(img, mask, random.Random(seed))
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
    return got, want


def _levels(a, b) -> np.ndarray:
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("key,value", EXACT, ids=lambda v: str(v))
def test_exact_transforms_match_pil(key, value, shape):
    for seed in range(4):
        img, mask = _pair(shape, smooth=seed % 2 == 1, seed=seed)
        (gi, gm), (wi, wm) = _both({key: value}, img, mask, seed)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("key,value", GEOMETRIC, ids=lambda v: str(v))
def test_scale_and_rotate_match_pil(key, value, shape):
    for seed in range(4):
        img, mask = _pair(shape, smooth=seed % 2 == 1, seed=seed)
        (gi, gm), (wi, wm) = _both({key: value}, img, mask, seed)
        assert np.mean(gm == wm) >= 0.995
        assert np.mean(_levels(gi, wi) <= 1) >= 0.99


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("key,value", PHOTOMETRIC, ids=lambda v: str(v))
def test_photometric_transforms_match_pil(key, value, shape):
    for seed in range(4):
        img, mask = _pair(shape, smooth=seed % 2 == 1, seed=seed)
        (gi, gm), (wi, wm) = _both({key: value}, img, mask, seed)
        assert _levels(gi, wi).max() <= 1
        np.testing.assert_array_equal(gm, wm)  # the mask passes through


@pytest.mark.parametrize("key,value", [("brightness", 0.9), ("contrast", 0.9),
                                       ("saturation", 0.9)])
def test_enhance_extrapolation_clips_as_pil(key, value):
    """Factors above 1 extrapolate and clip (``Image.blend``'s other branch)."""
    img, mask = _pair((40, 40), smooth=False, seed=9)
    for seed in range(8):
        (gi, _), (wi, _) = _both({key: value}, img, mask, seed)
        assert _levels(gi, wi).max() <= 1


def test_compose_draws_in_jax_order():
    chain = {"hflip": 0.5, "rotate": 12, "rcrop": 40, "brightness": 0.3, "hue": 0.2,
             "translate": (4, 6), "gamma": 0.4, "vflip": 0.5}
    for seed in range(6):
        img, mask = _pair((48, 56), smooth=True, seed=seed)
        (gi, gm), (wi, wm) = _both(chain, img, mask, seed)
        assert np.mean(gm == wm) >= 0.995
        assert np.mean(_levels(gi, wi) <= 1) >= 0.99


def test_the_injected_generator_is_the_only_randomness():
    img, mask = _pair((32, 32), smooth=False)
    aug = port_aug.get_composed_augmentations({"rotate": 30, "hue": 0.3, "rcrop": 20})
    random.seed(1)
    a = aug(img, mask, random.Random(7))
    random.seed(2)  # the global generator is not read
    b = aug(img, mask, random.Random(7))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_registry_holds_jax_keys():
    assert set(port_aug.KEY2AUG) == set(jax_aug.KEY2AUG)
    assert port_aug.get_composed_augmentations(None) is None
    composed = port_aug.get_composed_augmentations({"hflip": 0.5, "scale": 32})
    assert [type(a).__name__ for a in composed.augmentations] == \
        ["RandomHorizontallyFlip", "Scale"]
