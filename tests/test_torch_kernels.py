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
from multiagentperception_tpu_torch.ops.kernels import checks
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


def test_comm_fusion_plain_returns_three_distinct_tensors():
    """In softmax mode ``coef`` equals ``soft`` but is a tensor of its own:
    the custom op's outputs may not alias each other."""
    q, k, v = (torch.from_numpy(a) for a in _comm_inputs())
    for mode in MODES:
        fused, coef, soft = k2.comm_fusion_plain(q, k, v, mode=mode, diag_bias=0.001)
        assert len({t.untyped_storage().data_ptr() for t in (fused, coef, soft)}) == 3
        if mode == "softmax":
            assert torch.equal(coef, soft)


# ----------------------------------------------------------------- the ops

# (Cin, Cout, side, kernel, stride, padding, bias, images): a conv of each
# GEMM route (s2d stem, halo 3x3/1, gather16 3x3/2 and 1x1/2)
K4_OPS = {"s2d": (3, 16, 13, 7, 2, 3, False, 2), "halo": (8, 24, 9, 3, 1, 1, True, 2),
          "gather16_3x3s2": (32, 16, 9, 3, 2, 1, False, 1),
          "gather16_1x1s2": (16, 32, 9, 1, 2, 0, True, 2)}


def _k4_inputs(name: str):
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4

    cin, cout, side, k, stride, pad, bias, n = K4_OPS[name]
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(n, cin, side, side, generator=g)
    weight = torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** 0.5
    w = k4.prepare_weight(weight)
    b = torch.randn(cout, generator=g) if bias else None
    s_x = k4.dynamic_scale(x)
    geometry = k4.plan(n, cin, side, side, cout, k, k, stride, pad)
    xq = k4.scratch_plain(x, s_x, geometry)
    gemm = (xq, w.operand(geometry), w.s_w, s_x, b, cin, k, k, side, side, stride, pad)
    return x, weight, w, b, s_x, geometry, gemm


def test_ops_are_registered_in_the_namespace():
    from multiagentperception_tpu_torch.ops import kernels

    assert kernels.NAMESPACE == "when2com"
    for name in kernels.OPS:
        assert hasattr(getattr(torch.ops.when2com, name), "default"), name


def test_upsample_argmax_op_cpu_is_the_plain_version():
    """Through ``torch.ops.when2com`` on CPU tensors, with the check the
    card runs (``checks.check_upsample_argmax``)."""
    x = torch.from_numpy(_logits()).permute(0, 3, 1, 2).contiguous()
    assert torch.equal(torch.ops.when2com.upsample_argmax(x, 64, 64),
                       k1.upsample_argmax_plain(x, 64, 64))
    res = checks.check_upsample_argmax(x, 64, 64, fn=torch.ops.when2com.upsample_argmax)
    assert res["pixel_agreement"] == 1.0


@pytest.mark.parametrize("mode", MODES)
def test_comm_fusion_op_cpu_is_the_plain_version(mode):
    q, k, v = (torch.from_numpy(a) for a in _comm_inputs())
    got = torch.ops.when2com.comm_fusion(q, k, v, mode, 0.001, 0.2)
    for a, b in zip(got, k2.comm_fusion_plain(q, k, v, mode, 0.001, 0.2)):
        assert torch.equal(a, b)
    checks.check_comm_fusion(q, k, v, mode, 0.001, fn=torch.ops.when2com.comm_fusion)


@pytest.mark.parametrize("name", list(K4_OPS))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.int32],
                         ids=["f32", "bf16", "s32"])
def test_int8_ops_cpu_are_the_plain_version(name, out_dtype):
    """The quantize op writes ``scratch_plain``'s scratch and the GEMM op on
    it gives ``int8_conv_plain``'s sums and outputs, to the bit."""
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4

    x, weight, w, b, s_x, geometry, gemm = _k4_inputs(name)
    xq = torch.ops.when2com.int8_quantize(x, s_x, geometry.route, geometry.gemm[2])
    assert torch.equal(xq, gemm[0])
    got = torch.ops.when2com.int8_gemm(*gemm, out_dtype)
    stride, pad = gemm[-2:]
    want = k4.int8_conv_plain(x, w, s_x, b, stride, pad, out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(k4.int8_conv(x, w, None, b, stride, pad, out_dtype=out_dtype), want)
    assert torch.equal(k4.conv_nhwc(xq, w, s_x, b, geometry, out_dtype), want)
    checks.check_int8_conv(x, weight, b, stride, pad, None, out_dtype, ops=True)


def _op_calls():
    """(name, op, args) of each op on CPU tensors."""
    x = torch.from_numpy(_logits()).permute(0, 3, 1, 2).contiguous()
    q, k, v = (torch.from_numpy(a) for a in _comm_inputs())
    calls = [("upsample_argmax", torch.ops.when2com.upsample_argmax.default, (x, 64, 48)),
             ("comm_fusion", torch.ops.when2com.comm_fusion.default,
              (q, k, v, "activated", 0.001, 0.2))]
    for name in ("s2d", "gather16_1x1s2"):
        xx, _, _, _, s_x, geometry, gemm = _k4_inputs(name)
        calls.append((f"int8_quantize_{name}", torch.ops.when2com.int8_quantize.default,
                      (xx, s_x, geometry.route, geometry.gemm[2])))
        calls.append((f"int8_gemm_{name}", torch.ops.when2com.int8_gemm.default,
                      (*gemm, torch.bfloat16)))
    return calls


@pytest.mark.parametrize("index", range(6), ids=lambda i: ["upsample_argmax", "comm_fusion",
                                                           "int8_quantize_s2d",
                                                           "int8_gemm_s2d",
                                                           "int8_quantize_gather16",
                                                           "int8_gemm_gather16"][i])
def test_fake_implementation_matches_the_real_one(index):
    """Under fake tensors (as ``torch.export`` traces) each op allocates
    outputs of the real implementation's shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, op, args = _op_calls()[index]
    real = op(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype) for t in real]


@pytest.mark.parametrize("index", range(6), ids=lambda i: ["upsample_argmax", "comm_fusion",
                                                           "int8_quantize_s2d",
                                                           "int8_gemm_s2d",
                                                           "int8_quantize_gather16",
                                                           "int8_gemm_gather16"][i])
def test_opcheck_on_the_cpu_implementations(index):
    """``torch.library.opcheck``: the schema, the fake implementation and
    the dispatcher's registrations agree with the CPU implementation."""
    _, op, args = _op_calls()[index]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_count_flops_still_counts_the_plain_versions(train):
    """On ``meta`` tensors the wrappers take their plain versions, not the
    ops, so the bench's FLOP count (and so its MFU) is the one read before
    the kernels became ops, at 2 x 3 agents at 64x64."""
    from multiagentperception_tpu_torch import bench

    want = {False: (4034135040, 2923576320), True: (11870078976, 8550623232)}[train]
    assert bench.count_flops(2, 64, 3, train) == want
