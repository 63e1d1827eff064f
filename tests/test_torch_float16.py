"""float16 (``model.dtype: float16``) in the port, kernel by kernel, on the
CPU: the plain versions of K1, K2 and K4 on float16 inputs against the JAX
package (its Pallas kernels in interpret mode, as the JAX tests run them,
and its ``_int8_conv`` in a float16 network), the four custom ops under
``torch.library.opcheck`` at float16, and the blocks' float16 dtypes. The
models against JAX are in tests/test_torch_float16_models.py, the CLIs in
tests/test_torch_float16_cli.py.

Tolerances (those of tests/test_torch_mixed_precision.py, read in float16):
K1's class maps exactly equal (both upcast the float16 logits exactly and
resize in float32 with the same weights, strict-``>`` argmax). K2 on
float16 Q', K and V: ``coef`` and ``soft`` within 1e-6 with equal masks
(float32 graphs of the same upcast values), ``fused`` within one float16
ulp of the larger value plus 1e-5 (two float32 sums of the same products
in another order, each rounded once to float16). K4: int8 operands and
int32 sums equal to JAX's, the float16 output within one float16 ulp of
JAX's (both round one float32 rescale once).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multiagentperception_tpu import quantize as jq
from multiagentperception_tpu_torch import quantize as tq
from multiagentperception_tpu_torch.models.blocks import Conv2d, ConvTranspose2d, Linear
from multiagentperception_tpu_torch.ops.kernels import checks
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from test_torch_kernels import _k4_inputs
from test_torch_mixed_precision import (
    MODES,
    _comm_inputs,
    _typed,
    k1_against_pallas,
    k2_against_pallas,
)
from test_torch_quantize import CONVS, one_conv_against_jax
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

F16 = torch.float16

# ----------------------------------------------------------------- K1


@pytest.mark.parametrize("tie", [False, True], ids=["random", "all_tied"])
def test_upsample_argmax_plain_f16_matches_pallas(tie):
    k1_against_pallas(tie, "float16")


def test_upsample_argmax_cpu_f16_runs_plain():
    """A CPU tensor takes the plain version (no route counts), which
    upcasts the float16 logits exactly."""
    x = torch.randn(2, 11, 4, 4, generator=torch.Generator().manual_seed(0)).to(F16)
    before = dict(k1.upsample_argmax.route_launches)
    got = k1.upsample_argmax(x, 64, 64)
    assert k1.upsample_argmax.route_launches == before
    assert torch.equal(got, k1.upsample_argmax_plain(x.float(), 64, 64))


# ----------------------------------------------------------------- K2


@pytest.mark.parametrize("n", [3, 6])
@pytest.mark.parametrize("mode", MODES)
def test_comm_fusion_plain_f16_matches_pallas(mode, n):
    k2_against_pallas(mode, n, "float16")


@pytest.mark.parametrize("mode", MODES)
def test_comm_fusion_plain_f16_upcasts_first(mode):
    """On float16 inputs the plain version is the float32 function of the
    upcast inputs, ``fused`` rounded once to float16, ``coef`` / ``soft``
    exactly the float32 ones: as the Pallas kernel, it never rounds the
    logits to float16 (the dense MIMO attention does, as JAX's does)."""
    (qt, _), (kt, _), (vt, _) = _comm_inputs(seed=5, dtype="float16")
    fused, coef, soft = k2.comm_fusion_plain(qt, kt, vt, mode=mode, diag_bias=0.001)
    f_fused, f_coef, f_soft = k2.comm_fusion_plain(qt.float(), kt.float(), vt.float(),
                                                   mode=mode, diag_bias=0.001)
    assert torch.equal(coef, f_coef) and torch.equal(soft, f_soft)
    assert fused.dtype == F16 and torch.equal(fused, f_fused.to(F16))


def test_comm_fusion_check_holds_float16_to_float64():
    """``checks.check_comm_fusion``'s float16 branch (the card's check, here
    on the plain version) passes in every mode, and ``assert_within_ulp``
    at float16 rejects a value two float16 ulps off and a non-finite one."""
    (qt, _), (kt, _), (vt, _) = _comm_inputs(seed=7, dtype="float16")
    for mode in MODES:
        assert checks.check_comm_fusion(qt, kt, vt, mode, 0.001) < 1e-3
    ref = torch.tensor([1.0, 100.0])
    checks.assert_within_ulp(torch.tensor([1.0 + 2 ** -10, 100.0]).to(F16), ref, 0.0, F16)
    for bad in ([1.0 + 2 ** -9, 100.0], [1.0, float("inf")]):
        with pytest.raises(AssertionError, match="float16 ulp"):
            checks.assert_within_ulp(torch.tensor(bad).to(F16), ref, 0.0, F16)


# ----------------------------------------------------------------- K4


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("name", list(CONVS))
def test_one_f16_conv_matches_jax(name, static):
    """K4's plain version writing float16 against JAX's ``_int8_conv`` in a
    float16 network (the stem reads float32 frames, every other conv
    float16 maps)."""
    one_conv_against_jax(name, "float16", static)


@pytest.mark.parametrize("scale", [1.0, 37.0, 1e-3])
def test_quantize_f16_activation_matches_jax_to_the_bit(scale):
    rng = np.random.default_rng(int(scale * 10) + 1)
    x = (rng.normal(size=(2, 8, 9, 16)) * scale).astype(np.float32)
    tx, jx = _typed(x.transpose(0, 3, 1, 2), "float16")
    j_q, j_s = jq.quantize_activation(jx.transpose(0, 2, 3, 1))
    t_q, t_s = tq.quantize_activation(tx)
    np.testing.assert_array_equal(t_q.numpy().transpose(0, 2, 3, 1), np.asarray(j_q))
    assert np.float32(t_s.item()).view(np.int32) == np.asarray(j_s).view(np.int32)


@pytest.mark.parametrize("name", ["s2d", "gather16_1x1s2", "halo"])
def test_int8_f16_conv_plain_is_one_rounding_of_float32(name):
    """K4's plain version (and so the ops' CPU implementations) in float16:
    the float32 rescale rounded once, through the wrapper, the ops and the
    GEMM alone, and the card's check (``checks.check_int8_conv``) passes on
    it for float16 input or float32 frames."""
    x, weight, w, b, s_x, geometry, gemm = _k4_inputs(name)
    want32 = k4.int8_conv_plain(x, w, s_x, b, gemm[-2], gemm[-1])
    for xin in (x, x.to(F16)):
        s = k4.dynamic_scale(xin)
        y = k4.int8_conv(xin, w, s, b, gemm[-2], gemm[-1], out_dtype=F16)
        assert y.dtype == F16
        if xin.dtype == torch.float32:
            assert torch.equal(y, want32.to(F16))
        xq = torch.ops.when2com.int8_quantize(xin, s, geometry.route, geometry.gemm[2])
        assert torch.equal(k4.conv_nhwc(xq, w, s, b, geometry, F16), y)
        checks.check_int8_conv(xin, weight, b, gemm[-2], gemm[-1], None, F16)
        checks.check_int8_conv(xin, weight, b, gemm[-2], gemm[-1], None, F16, ops=True)


def test_int8_conv_refuses_float64():
    """float16 is taken now; a float64 input or output is refused by name."""
    w = k4.prepare_weight(torch.randn(8, 4, 3, 3))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16 input"):
        k4.int8_conv(torch.randn(1, 4, 6, 6, dtype=torch.float64), w, padding=1)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16 or int32"):
        k4.int8_conv(torch.randn(1, 4, 6, 6), w, padding=1, out_dtype=torch.float64)


# ----------------------------------------------------------------- the ops at float16


def _f16_op_calls():
    """(op, args) of each custom op on float16 CPU tensors (the GEMM writing
    float16)."""
    logits = torch.randn(3, 11, 4, 4, generator=torch.Generator().manual_seed(3)).to(F16)
    (q, _), (k, _), (v, _) = _comm_inputs(seed=9, dtype="float16")
    calls = {"upsample_argmax": (torch.ops.when2com.upsample_argmax.default, (logits, 64, 48)),
             "comm_fusion": (torch.ops.when2com.comm_fusion.default,
                             (q, k, v, "activated", 0.001, 0.2))}
    for name in ("s2d", "gather16_1x1s2"):
        x, _, _, _, _, geometry, gemm = _k4_inputs(name)
        x16 = x.to(F16)
        s_x = k4.dynamic_scale(x16)
        calls[f"int8_quantize_{name}"] = (torch.ops.when2com.int8_quantize.default,
                                          (x16, s_x, geometry.route, geometry.gemm[2]))
        calls[f"int8_gemm_{name}"] = (torch.ops.when2com.int8_gemm.default, (*gemm, F16))
    return calls


OP_CALLS = ("upsample_argmax", "comm_fusion", "int8_quantize_s2d", "int8_gemm_s2d",
            "int8_quantize_gather16_1x1s2", "int8_gemm_gather16_1x1s2")


@pytest.mark.parametrize("name", OP_CALLS)
def test_opcheck_at_float16(name):
    """``torch.library.opcheck`` of each op on float16 CPU tensors: the
    schema, the fake implementation and the registrations agree with the
    CPU implementation (the plain version), whose outputs keep float16
    where the function's do."""
    op, args = _f16_op_calls()[name]
    torch.library.opcheck(op, args)
    out = op(*args)
    out = out if isinstance(out, tuple) else (out,)
    want = {"upsample_argmax": [torch.int32], "comm_fusion": [F16, torch.float32, torch.float32]}
    assert [t.dtype for t in out] == want.get(name, [torch.int8] if "quantize" in name else [F16])


# ----------------------------------------------------------------- blocks


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_takes_float16_with_float32_statistics(train):
    """``nn.BatchNorm2d`` with float32 parameters takes a float16 input in
    both modes and returns float16: the float32 normalization of the upcast
    input, rounded once (the JAX ``TorchBatchNorm`` with ``dtype``,
    blocks.py:61-77); its running statistics stay float32."""
    g = torch.Generator().manual_seed(1)
    bn = torch.nn.BatchNorm2d(8).train(train)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(8, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(8, generator=g))
        bn.running_mean.copy_(torch.randn(8, generator=g))
        bn.running_var.copy_(torch.rand(8, generator=g) + 0.5)
    ref = torch.nn.BatchNorm2d(8).train(train)
    ref.load_state_dict(bn.state_dict())
    x = (torch.randn(4, 8, 5, 5, generator=g) * 3).to(F16)
    y = bn(x)
    want = ref(x.float())
    assert y.dtype == F16 and bn.running_var.dtype == torch.float32
    torch.testing.assert_close(y.float(), want, rtol=2 ** -10, atol=1e-3)
    torch.testing.assert_close(bn.running_mean, ref.running_mean, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("hw,stride", [(1, 2), (2, 2), (4, 1)])
def test_cpu_f16_conv_is_the_float32_conv_of_rounded_operands(hw, stride):
    """On the CPU a float16 ``Conv2d`` is the float32 convolution of the
    float16-rounded input and weights, rounded once, forward and backward,
    with float32 parameter gradients; ``Linear`` and ``ConvTranspose2d``
    compute in float16 with float32 parameters."""
    gen = torch.Generator().manual_seed(hw)
    conv = Conv2d(64, 64, 3, stride, 1, bias=True, compute_dtype=F16)
    ref = torch.nn.Conv2d(64, 64, 3, stride, 1, bias=True)
    with torch.no_grad():
        for p in (conv.weight, conv.bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        ref.weight.copy_(conv.weight.to(F16).float())
        ref.bias.copy_(conv.bias.to(F16).float())
    x = torch.randn(3, 64, hw, hw, generator=gen)
    y = conv(x)
    want = ref(x.to(F16).float()).to(F16)
    assert y.dtype == F16 and torch.equal(y, want)
    go = torch.randn(y.shape, generator=gen).to(F16)
    y.backward(go)
    want.float().backward(go.float())
    assert conv.weight.grad.dtype == torch.float32
    torch.testing.assert_close(conv.weight.grad, ref.weight.grad.to(F16).float(),
                               rtol=0, atol=0)
    lin = Linear(16, 4, compute_dtype=F16)
    deconv = ConvTranspose2d(8, 4, 3, 2, 1, output_padding=1, compute_dtype=F16)
    assert lin(torch.randn(2, 16)).dtype == F16 and lin.weight.dtype == torch.float32
    assert deconv(torch.randn(1, 8, 4, 4)).dtype == F16 and deconv.weight.dtype == torch.float32
