"""Paired image/mask augmentations (reference: ptsemseg/augmentations/).

The port's own copy of ``multiagentperception_tpu/data/augmentations.py``
(:17-190), on numpy alone: the JAX copy runs PIL, which the card's machine
does not promise. Each transform reproduces the PIL operation the JAX copy
calls, with PIL's arithmetic:

- flips, crops (zero fill outside the image) and ``RandomTranslate``'s
  integer AFFINE shift are exact copies;
- ``RandomRotate`` turns about the image centre with PIL's inverse matrix
  (cos/sin rounded to 15 digits): BILINEAR for the image (PIL's
  ``bilinear_filter``: pixel centres at +0.5, edge-clamped taps, truncated
  to uint8, zero outside), NEAREST for the mask (PIL's 16.16 fixed-point
  affine walk);
- ``Scale`` keeps PIL's integer output size; the image goes through PIL's
  two-pass BILINEAR resampling (horizontal, then vertical; the triangle
  filter widened by the scale when shrinking; 22-bit fixed-point weights,
  each pass rounded to uint8), the mask through PIL's NEAREST (a scaling
  affine: each output pixel takes the source pixel under its centre);
- the ``ImageEnhance`` blends in float32 as ``Image.blend`` does:
  Brightness against black, Color against the L grey
  (``(19595 R + 38470 G + 7471 B + 2^15) >> 16``), Contrast against the
  rounded mean of that grey;
- ``AdjustHue`` through PIL's 8-bit HSV (``rgb2hsv`` / ``hsv2rgb`` with
  their float and double steps); ``AdjustGamma`` is JAX's numpy.

A deliberate difference: randomness comes from the generator each call is
given (a ``random.Random``), not from the global ``random`` module, so worker
processes and a resumed run draw the same augmentations (the dataset derives
the generator from its seed, the epoch and the frame). Every transform
draws in JAX's order by JAX's methods (``random()``, ``randint``,
``uniform``): seeding both alike gives the same draws. None of the ten
shipped configs enable augmentations.
"""

from __future__ import annotations

import math
import random

import numpy as np

_PRECISION_BITS = 22  # PIL's 8-bit resampling: 32 - 8 - 2


class Compose:
    """Apply ``augmentations`` in order to an (H, W, 3) uint8 image and its
    (H, W) mask, drawing from ``rng``; returns uint8 copies."""

    def __init__(self, augmentations):
        self.augmentations = augmentations

    def __call__(self, img: np.ndarray, mask: np.ndarray, rng: random.Random):
        img = np.asarray(img, dtype=np.uint8)
        mask = np.asarray(mask).astype(np.uint8)
        for a in self.augmentations:
            img, mask = a(img, mask, rng)
        return np.ascontiguousarray(img), np.ascontiguousarray(mask)


class RandomHorizontallyFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, mask, rng):
        if rng.random() < self.p:
            return img[:, ::-1], mask[:, ::-1]
        return img, mask


class RandomVerticallyFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, mask, rng):
        if rng.random() < self.p:
            return img[::-1], mask[::-1]
        return img, mask


class RandomRotate:
    def __init__(self, degree):
        self.degree = degree

    def __call__(self, img, mask, rng):
        d = rng.random() * 2 * self.degree - self.degree
        return _rotate(img, d, bilinear=True), _rotate(mask, d, bilinear=False)


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img, mask, rng):
        h, w = img.shape[:2]
        th, tw = self.size
        if w == tw and h == th:
            return img, mask
        x1 = rng.randint(0, max(0, w - tw))
        y1 = rng.randint(0, max(0, h - th))
        return _crop(img, x1, y1, tw, th), _crop(mask, x1, y1, tw, th)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img, mask, rng):
        h, w = img.shape[:2]
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return _crop(img, x1, y1, tw, th), _crop(mask, x1, y1, tw, th)


class Scale:
    def __init__(self, size):
        self.size = size

    def __call__(self, img, mask, rng):
        h, w = img.shape[:2]
        if (w >= h and w == self.size) or (h >= w and h == self.size):
            return img, mask
        if w > h:
            ow = self.size
            oh = int(self.size * h / w)
        else:
            oh = self.size
            ow = int(self.size * w / h)
        return _resize_bilinear(img, ow, oh), _resize_nearest(mask, ow, oh)


class RandomTranslate:
    def __init__(self, offset):
        self.offset = offset  # (max_x, max_y)

    def __call__(self, img, mask, rng):
        dx = int(rng.uniform(-1, 1) * self.offset[0])
        dy = int(rng.uniform(-1, 1) * self.offset[1])
        return _shift(img, dx, dy), _shift(mask, dx, dy)


class _Enhance:
    """``ImageEnhance.<kind>(img).enhance(factor)`` with factor drawn from
    uniform(1 - value, 1 + value); the mask passes through."""

    def __init__(self, value):
        self.value = value

    def __call__(self, img, mask, rng):
        factor = rng.uniform(1 - self.value, 1 + self.value)
        return _blend(self.degenerate(img), img, factor), mask

    def degenerate(self, img):
        raise NotImplementedError


class AdjustBrightness(_Enhance):
    def degenerate(self, img):
        return np.zeros_like(img)


class AdjustSaturation(_Enhance):
    def degenerate(self, img):
        return np.repeat(_luma(img)[..., None], 3, axis=-1)


class AdjustContrast(_Enhance):
    def degenerate(self, img):
        luma = _luma(img)
        mean = int(int(luma.astype(np.int64).sum()) / luma.size + 0.5)
        return np.full_like(img, mean)


class AdjustGamma:
    def __init__(self, gamma):
        self.gamma = gamma

    def __call__(self, img, mask, rng):
        g = rng.uniform(1, 1 + self.gamma)
        arr = np.asarray(img, dtype=np.float64) / 255.0
        out = (np.power(arr, g) * 255.0).clip(0, 255).astype(np.uint8)
        return out, mask


class AdjustHue:
    def __init__(self, hue):
        self.hue = hue

    def __call__(self, img, mask, rng):
        shift = rng.uniform(-self.hue, self.hue)
        hsv = _rgb_to_hsv(img).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
        return _hsv_to_rgb(hsv.astype(np.uint8)), mask


KEY2AUG = {
    "gamma": AdjustGamma,
    "hue": AdjustHue,
    "brightness": AdjustBrightness,
    "saturation": AdjustSaturation,
    "contrast": AdjustContrast,
    "rcrop": RandomCrop,
    "ccrop": CenterCrop,
    "hflip": RandomHorizontallyFlip,
    "vflip": RandomVerticallyFlip,
    "scale": Scale,
    "rotate": RandomRotate,
    "translate": RandomTranslate,
}


def get_composed_augmentations(aug_dict):
    """Registry (reference: augmentations/__init__.py:40-52)."""
    if aug_dict is None:
        return None
    return Compose([KEY2AUG[k](v) for k, v in aug_dict.items()])


# ---------------------------------------------------------------- PIL's arithmetic

def _crop(a: np.ndarray, x1: int, y1: int, tw: int, th: int) -> np.ndarray:
    """``Image.crop((x1, y1, x1 + tw, y1 + th))``: zeros outside the image."""
    h, w = a.shape[:2]
    out = np.zeros((th, tw) + a.shape[2:], dtype=a.dtype)
    sx0, sy0 = max(x1, 0), max(y1, 0)
    sx1, sy1 = min(x1 + tw, w), min(y1 + th, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y1:sy1 - y1, sx0 - x1:sx1 - x1] = a[sy0:sy1, sx0:sx1]
    return out


def _shift(a: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """AFFINE (1, 0, dx, 0, 1, dy) with NEAREST: out[y, x] = a[y + dy, x + dx],
    zero where that lies outside."""
    h, w = a.shape[:2]
    return _crop(a, dx, dy, w, h)


def _floor_int(v: np.ndarray) -> np.ndarray:
    """PIL's FLOOR: truncation for v >= 0, floor below."""
    return np.where(v < 0, np.floor(v), np.trunc(v)).astype(np.int64)


def _rotation_matrix(angle: float, w: int, h: int) -> list[float]:
    """``Image.rotate``'s inverse affine matrix (destination -> source)."""
    cx, cy = w / 2, h / 2
    a = -math.radians(angle)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return m


def _rotate(a: np.ndarray, angle: float, bilinear: bool) -> np.ndarray:
    """``Image.rotate(angle, BILINEAR or NEAREST)`` without expand."""
    angle = angle % 360.0
    h, w = a.shape[:2]
    if angle == 0:
        return a.copy()
    if angle == 180:
        return a[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.rot90(a, 1 if angle == 90 else 3).copy()
    m = _rotation_matrix(angle, w, h)
    if bilinear:
        return _affine_bilinear(a, m)
    return _affine_nearest(a, m)


def _affine_bilinear(a: np.ndarray, m: list[float]) -> np.ndarray:
    """PIL's generic affine transform with ``bilinear_filter``."""
    h, w = a.shape[:2]
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64) + 0.5,
                         np.arange(w, dtype=np.float64) + 0.5, indexing="ij")
    xin = m[0] * xx + m[1] * yy + m[2]
    yin = m[3] * xx + m[4] * yy + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x, y = _floor_int(xin), _floor_int(yin)
    dx, dy = xin - x, yin - y
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    y0 = np.clip(y, 0, h - 1)
    has_y1 = (y + 1 >= 0) & (y + 1 < h)
    y1 = np.clip(y + 1, 0, h - 1)
    if a.ndim == 3:
        dx, dy, has_y1 = dx[..., None], dy[..., None], has_y1[..., None]
    src = a.astype(np.float64)
    v1 = src[y0, x0] + (src[y0, x1] - src[y0, x0]) * dx
    v2 = src[y1, x0] + (src[y1, x1] - src[y1, x0]) * dx
    v2 = np.where(has_y1, v2, v1)
    v = v1 + (v2 - v1) * dy
    out = v.astype(np.uint8)  # C's (UINT8) cast of a value in [0, 255]
    out[~inside] = 0
    return out


def _affine_nearest(a: np.ndarray, m: list[float]) -> np.ndarray:
    """PIL's NEAREST affine transform in 16.16 fixed point (``affine_fixed``;
    the matrix of an image below 32768 pixels a side always fits it)."""
    h, w = a.shape[:2]

    def fix(v: float) -> int:
        v = v * 65536.0 + 0.5
        return int(math.floor(v)) if v < 0 else int(v)

    a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
    a2 = fix(m[2] + m[0] * 0.5 + m[1] * 0.5)
    a5 = fix(m[5] + m[3] * 0.5 + m[4] * 0.5)
    ys = np.arange(h, dtype=np.int64)[:, None]
    xs = np.arange(w, dtype=np.int64)[None, :]
    xin = (a2 + ys * a1 + xs * a0) >> 16
    yin = (a5 + ys * a4 + xs * a3) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = a[np.clip(yin, 0, h - 1), np.clip(xin, 0, w - 1)]
    out[~inside] = 0
    return out


def _resample_weights(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for BILINEAR over the whole axis, then
    ``normalize_coeffs_8bpc``: (out, ksize) source indices and int weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = sum(k)
        for x, wgt in enumerate(k):
            wgt = wgt / ww if ww != 0.0 else wgt
            kk[xx, x] = int(0.5 + wgt * (1 << _PRECISION_BITS))
            idx[xx, x] = xmin + x
    return idx, kk


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of PIL's 8-bit resampling passes along ``axis``."""
    idx, kk = _resample_weights(a.shape[axis], out_size)
    taps = np.take(a.astype(np.int64), idx, axis=axis)  # axis -> (out, ksize)
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = kk.shape
    acc = (taps * kk.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_bilinear(a: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """``Image.resize((ow, oh), BILINEAR)``: horizontal pass, then vertical."""
    h, w = a.shape[:2]
    if ow != w:
        a = _resample_axis(a, ow, 1)
    if oh != h:
        a = _resample_axis(a, oh, 0)
    return a


def _resize_nearest(a: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """``Image.resize((ow, oh), NEAREST)``: PIL's scaling affine, positions
    accumulated from the first pixel centre."""
    h, w = a.shape[:2]

    def positions(in_size: int, out_size: int) -> np.ndarray:
        step = in_size / out_size
        pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
        return np.minimum(_floor_int(pos), in_size - 1)

    return a[positions(h, oh)][:, positions(w, ow)]


def _luma(img: np.ndarray) -> np.ndarray:
    """``convert("L")``: PIL's integer ITU-R 601-2 luma."""
    rgb = img.astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(im1, im2, alpha)``: float32 arithmetic, truncated to
    uint8, clipped when extrapolating."""
    alpha32 = np.float32(alpha)
    a, b = im1.astype(np.float32), im2.astype(np.float32)
    out = a + alpha32 * (b - a)
    if not 0.0 <= alpha32 <= 1.0:
        out = np.clip(out, 0.0, 255.0)
    return out.astype(np.uint8)


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``convert("HSV")`` (PIL's ``rgb2hsv_row``, colorsys with 8-bit
    outputs)."""
    f32 = np.float32
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    flat = maxc == minc
    cr = np.where(flat, 1, maxc - minc).astype(f32)
    s = cr / np.where(maxc == 0, 1, maxc).astype(f32)
    rc = (maxc - r).astype(f32) / cr
    gc = (maxc - g).astype(f32) / cr
    bc = (maxc - b).astype(f32) / cr
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc, 2.0 + rc.astype(np.float64) - bc,
                          4.0 + gc.astype(np.float64) - rc)).astype(f32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(f32)
    uh = np.clip(np.trunc(h.astype(np.float64) * 255.0), 0, 255)
    us = np.clip(np.trunc(s.astype(np.float64) * 255.0), 0, 255)
    out = np.stack([np.where(flat, 0, uh), np.where(flat, 0, us), maxc], axis=-1)
    return out.astype(np.uint8)


def _round_half_away(v: np.ndarray) -> np.ndarray:
    return np.sign(v) * np.floor(np.abs(v) + 0.5)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``Image.fromarray(hsv, "HSV").convert("RGB")`` (PIL's ``hsv2rgb``)."""
    f32 = np.float32
    h, s, v = (hsv[..., i].astype(np.float64) for i in range(3))
    i = np.floor(h * 6.0 / 255.0).astype(np.int64)
    f = (h * 6.0 / 255.0 - i).astype(f32)
    fs = (s / 255.0).astype(f32)
    p = _round_half_away(v * (1.0 - fs.astype(np.float64)))
    q = _round_half_away(v * (1.0 - (fs * f).astype(np.float64)))
    t = _round_half_away(v * (1.0 - fs.astype(np.float64) * (1.0 - f.astype(np.float64))))
    up, uq, ut = (np.clip(x, 0, 255) for x in (p, q, t))
    sector = i % 6
    choices = {0: (v, ut, up), 1: (uq, v, up), 2: (up, v, ut),
               3: (up, uq, v), 4: (ut, up, v), 5: (v, up, uq)}
    out = np.zeros(hsv.shape, np.float64)
    for k, chans in choices.items():
        sel = sector == k
        for c in range(3):
            out[..., c] = np.where(sel, chans[c], out[..., c])
    grey = hsv[..., 1] == 0
    out[grey] = np.repeat(v[grey][:, None], 3, axis=1)
    return out.astype(np.uint8)
