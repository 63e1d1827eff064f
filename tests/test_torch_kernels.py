"""The port's two kernels: their plain PyTorch versions against the JAX
package's Pallas kernels (run in interpret mode, as the JAX tests run them)
and the wrappers' CPU dispatch. Each CUDA kernel against its plain version
is in test_torch_cuda.py, which needs a card.

Tolerances: the class maps of K1 exactly equal (same weights, strict-``>``
argmax); K2's fused maps within atol 1e-5 and its graphs within 1e-6
(float32 sums in another order); masks exactly equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu.ops.pallas.comm_fusion import fused_comm_step
from multiagentperception_tpu.ops.pallas.upsample_argmax import upsample_argmax_pallas
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from multiagentperception_tpu_torch.ops.resize import _weight_matrix

MODES = ("softmax", "activated", "argmax")


def _logits(shape=(3, 4, 4, 11), seed=0):
    """NHWC logits for the JAX kernel."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _comm_inputs(b=2, n=6, d=64, seed=1):
    """Projected queries, keys and (B, N, h, w, C) values. The keys are
    scaled so the logits have a spread of about 2: `activated` then keeps
    off-diagonal links instead of pruning the uniform 1/N graph."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, d)).astype(np.float32)
    k = (rng.standard_normal((b, n, d)) * 2 / np.sqrt(d)).astype(np.float32)
    v = rng.standard_normal((b, n, 4, 4, 8)).astype(np.float32)
    return q, k, v


# ----------------------------------------------------------------- K1

@pytest.mark.parametrize("tie", [False, True], ids=["random", "all_tied"])
def test_upsample_argmax_plain_matches_pallas(tie):
    x = np.ones((3, 4, 4, 11), np.float32) if tie else _logits()
    want = np.asarray(upsample_argmax_pallas(jnp.asarray(x), 128, 128, interpret=True))
    got = k1.upsample_argmax_plain(torch.from_numpy(x).permute(0, 3, 1, 2), 128, 128)
    assert got.dtype == torch.int32 and got.shape == (3, 128, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    if tie:
        assert not got.any()  # every class equal: the lowest (0) wins


@pytest.mark.parametrize("src,dst", [(16, 512), (4, 128), (5, 17), (7, 3)])
def test_taps_rebuild_the_weight_matrix(src, dst):
    """The kernel's per-row taps carry exactly the plain version's weights."""
    idx, wt = k1._taps(src, dst)
    rebuilt = np.zeros((dst, src), np.float32)
    np.add.at(rebuilt, (np.arange(dst)[:, None], idx), wt)
    np.testing.assert_array_equal(rebuilt, _weight_matrix(src, dst, False))


@pytest.mark.parametrize("src,dst,want", [(16, 512, True), (4, 128, True), (5, 17, False),
                                          (7, 3, False), (8, 256, True), (16, 500, False),
                                          (16, 300, False), (7, 29, False)])
def test_shared_spans_against_taps(src, dst, want):
    """Where the helper lets the kernel take its span path, one tap pair per
    run of SPAN columns (the run's first column's) with each column's own
    weights rebuilds the plain version's weight matrix exactly; where it
    does not, the width is no multiple of SPAN or some run straddles a tap
    change."""
    assert k1.shared_spans(src, dst) is want
    idx, wt = k1._taps(src, dst)
    if want:
        lead = np.repeat(idx[::k1.SPAN], k1.SPAN, axis=0)
        rebuilt = np.zeros((dst, src), np.float32)
        np.add.at(rebuilt, (np.arange(dst)[:, None], lead), wt)
        np.testing.assert_array_equal(rebuilt, _weight_matrix(src, dst, False))
    else:
        runs = idx[: dst - dst % k1.SPAN].reshape(-1, k1.SPAN, 2)
        assert dst % k1.SPAN or bool((runs != runs[:, :1]).any())


def test_upsample_argmax_cpu_runs_plain_and_counts_no_launch():
    x = torch.from_numpy(_logits()).permute(0, 3, 1, 2).contiguous()
    before = k1.upsample_argmax.launches
    got = k1.upsample_argmax(x, 64, 64)
    assert k1.upsample_argmax.launches == before
    assert torch.equal(got, k1.upsample_argmax_plain(x, 64, 64))


# ----------------------------------------------------------------- K2

@pytest.mark.parametrize("mode", MODES)
def test_comm_fusion_plain_matches_pallas(mode):
    q, k, v = _comm_inputs()
    j_fused, j_coef, j_soft = fused_comm_step(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mode=mode,
        diag_bias=0.001, interpret=True)
    fused, coef, soft = k2.comm_fusion_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mode=mode, diag_bias=0.001)
    np.testing.assert_array_equal(coef.numpy() != 0, np.asarray(j_coef) != 0)
    np.testing.assert_allclose(coef.numpy(), np.asarray(j_coef), rtol=0, atol=1e-6)
    np.testing.assert_allclose(soft.numpy(), np.asarray(j_soft), rtol=0, atol=1e-6)
    np.testing.assert_allclose(fused.numpy(), np.asarray(j_fused), rtol=0, atol=1e-5)
    if mode == "activated":  # the input keeps real links in every sample
        offdiag = (coef.numpy() != 0) & ~np.eye(6, dtype=bool)
        assert offdiag.any(axis=(1, 2)).all()


def test_comm_fusion_cpu_runs_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _comm_inputs())
    before = k2.comm_fusion.launches
    got = k2.comm_fusion(q, k, v, mode="argmax", diag_bias=0.001)
    want = k2.comm_fusion_plain(q, k, v, mode="argmax", diag_bias=0.001)
    assert k2.comm_fusion.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_comm_fusion_rejects_unknown_mode():
    q, k, v = (torch.from_numpy(a) for a in _comm_inputs())
    with pytest.raises(ValueError, match="mode"):
        k2.comm_fusion(q, k, v, mode="topk")
