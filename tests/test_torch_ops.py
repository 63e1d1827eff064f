"""The port's tensor ops against the JAX package's, on the same numpy inputs.

Tolerances: floats within atol 1e-5 (float32 sums taken in another order);
masks, integer results and confusion matrices exactly equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu.ops import comm as jcomm
from multiagentperception_tpu.ops.normalize import normalize_images as j_normalize
from multiagentperception_tpu.ops.resize import bilinear_resize as j_resize
from multiagentperception_tpu_torch.ops import comm as tcomm
from multiagentperception_tpu_torch.ops.normalize import normalize_images as t_normalize
from multiagentperception_tpu_torch.ops.resize import bilinear_resize as t_resize

ATOL = 1e-5


@pytest.mark.parametrize("img_norm", [True, False])
def test_normalize(img_norm):
    x = np.random.default_rng(0).integers(0, 256, (2, 3, 8, 8, 3), np.uint8)
    want = np.asarray(j_normalize(jnp.asarray(x), img_norm=img_norm))
    got = t_normalize(torch.from_numpy(x), img_norm=img_norm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((4, 4), (128, 128)), ((5, 3), (17, 11)),
                                     ((16, 16), (512, 512)), ((9, 7), (4, 5))])
def test_bilinear_resize(src, dst, align_corners):
    x = np.random.default_rng(1).standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), *dst, align_corners=align_corners))
    got = t_resize(torch.from_numpy(x).permute(0, 3, 1, 2), *dst,
                   align_corners=align_corners).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _graph(b=2, n=4, seed=2):
    """A (B, K, Q) softmax graph with a +0.001 I bias, as MIMOcom builds it,
    and a tie in one column so the lowest-index rule is exercised."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, n, n)).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    prob[0, :, 1] = 1.0 / n  # all keys tie for query 1
    return (prob + 0.001 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _vals(b=2, n=4, seed=3):
    return np.random.default_rng(seed).standard_normal((b, n, 3, 5, 7)).astype(np.float32)


def test_fuse_values():
    prob, vals = _graph(), _vals()
    want = np.asarray(jcomm.fuse_values(jnp.asarray(prob), jnp.asarray(vals)))
    got = tcomm.fuse_values(torch.from_numpy(prob), torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_one_hot_argmax_ties_to_lowest():
    prob = _graph()
    prob[1, :, 2] = prob[1, 0, 2]  # an exact tie between every key
    want = np.asarray(jcomm.one_hot_argmax(jnp.asarray(prob), axis=1))
    got = tcomm.one_hot_argmax(torch.from_numpy(prob), dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1, 0, 2] == 1.0


@pytest.mark.parametrize("select", ["argmax_select", "activated_select"])
def test_select(select):
    prob, vals = _graph(), _vals()
    n = prob.shape[1]
    j_fused, j_coef, j_nc = getattr(jcomm, select)(jnp.asarray(vals), jnp.asarray(prob), n)
    t_fused, t_coef, t_nc = getattr(tcomm, select)(torch.from_numpy(vals),
                                                   torch.from_numpy(prob), n)
    np.testing.assert_array_equal(t_coef.numpy() != 0, np.asarray(j_coef) != 0)
    np.testing.assert_allclose(t_coef.numpy(), np.asarray(j_coef), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_fused.numpy(), np.asarray(j_fused), rtol=0, atol=ATOL)
    assert float(t_nc) == float(j_nc)


def test_activated_threshold_is_strict():
    prob = np.full((1, 2, 2), 0.2, np.float32)
    prob[0, 0, 0] = 0.6
    _, coef, nc = tcomm.activated_select(torch.zeros(1, 2, 3), torch.from_numpy(prob), 2)
    np.testing.assert_array_equal(coef.numpy()[0],
                                  np.array([[0.6, 0.0], [0.0, 0.0]], np.float32))
    assert float(nc) == 0.0


def test_num_connect_offdiag():
    coef = (_graph(b=3, n=5) > 0.25).astype(np.float32)
    want = float(jcomm.num_connect_offdiag(jnp.asarray(coef), 5))
    assert float(tcomm.num_connect_offdiag(torch.from_numpy(coef), 5)) == want


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_matrix(masked):
    rng = np.random.default_rng(4)
    t = rng.integers(0, 11, (6, 9, 13)).astype(np.uint8)
    t[t == 3] = 250  # the ignore index lies outside [0, C) and is dropped
    p = rng.integers(0, 11, (6, 9, 13)).astype(np.int32)
    mask = np.array([1, 0, 1, 1, 0, 0], bool) if masked else None
    want = np.asarray(jcomm.confusion_matrix(
        jnp.asarray(t), jnp.asarray(p), 11,
        None if mask is None else jnp.asarray(mask)))
    got = tcomm.confusion_matrix(torch.from_numpy(t), torch.from_numpy(p), 11,
                                 None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
