"""The port's int8 quantization (``quantize.py`` and the plain version of K4,
``ops/kernels/int8_conv``) against the JAX package's ``quantize.py`` on the
same arrays, on the CPU.

- The quantizers equal JAX's to the bit (both divide exactly: JAX's eager
  division by a scalar, the port's by a tensor).
- One convolution through the swap (``quantized_apply`` on a one-conv
  model) against JAX's ``quantized_apply`` on a one-conv flax module, for
  every configuration the flagship has (7x7/2 with Cin 3, 3x3/1, 3x3/2,
  1x1/2, with and without bias), static and dynamic scales: the int8
  operands and the int32 sums equal; the float32 output within 1 ulp (XLA
  on the CPU may contract the rescale's multiply and add into one FMA; run
  eagerly it did not, and the outputs are equal here); bf16 outputs equal
  after their one rounding.
- Calibration on the same batches gives JAX's scales through
  ``convert.scales_from_flax`` within 1e-6 relative (the two frameworks'
  float32 activations differ by their sums' order); max-reduced across
  batches; the JSON round trip; ``model.remat`` gives the same scales.
- The swap routes as many conv calls as JAX's interceptor swaps.
- ``per_frame_links`` equals JAX's in every mode it ports.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax import lax

from multiagentperception_tpu import quantize as jq
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.ops.comm import num_connect_offdiag as jax_num_connect
from multiagentperception_tpu.ops.comm import per_frame_links as jax_per_frame_links
from multiagentperception_tpu_torch import quantize as tq
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import scales_from_flax, state_dict_from_flax
from multiagentperception_tpu_torch.models import get_model
from multiagentperception_tpu_torch.models.blocks import Conv2d
from multiagentperception_tpu_torch.ops.comm import num_connect_offdiag, per_frame_links
from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

B, N, IMG = 2, 3, 64


# ------------------------------------------------------------------ quantizers

@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (7, 7, 3, 64), (1, 1, 64, 128)],
                         ids=["3x3", "7x7_cin3", "1x1"])
def test_quantize_weight_matches_jax_to_the_bit(shape):
    rng = np.random.default_rng(sum(shape))
    hwio = rng.normal(size=shape).astype(np.float32)
    hwio[..., 0] = 0.0  # an all-zero output channel takes the eps scale
    j_w, j_s = jq.quantize_weight(jnp.asarray(hwio))
    t_w, t_s = tq.quantize_weight(torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy()))
    assert t_w.dtype == torch.int8 and t_s.dtype == torch.float32
    np.testing.assert_array_equal(t_w.numpy().transpose(2, 3, 1, 0), np.asarray(j_w))
    np.testing.assert_array_equal(t_s.numpy().view(np.int32), np.asarray(j_s).view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 37.0, 1e-3])
def test_quantize_activation_matches_jax_to_the_bit(dtype, scale):
    rng = np.random.default_rng(int(scale * 10))
    x = (rng.normal(size=(2, 8, 9, 16)) * scale).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    j_q, j_s = jq.quantize_activation(jx)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(getattr(torch, dtype))
    t_q, t_s = tq.quantize_activation(tx)
    np.testing.assert_array_equal(t_q.numpy().transpose(0, 2, 3, 1), np.asarray(j_q))
    assert np.float32(t_s.item()).view(np.int32) == np.asarray(j_s).view(np.int32)


def test_quantize_activation_of_zeros():
    q, s = tq.quantize_activation(torch.zeros(2, 3, 4, 4))
    assert float(s) == np.float32(1e-8) and not q.any()


# ------------------------------------------------------------------ one conv

class _OneConv(fnn.Module):
    features: int
    kernel: int
    stride: int
    pad: int
    bias: bool
    dtype: object = None

    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(self.features, (self.kernel, self.kernel), (self.stride, self.stride),
                        padding=[(self.pad, self.pad)] * 2, use_bias=self.bias,
                        dtype=self.dtype)(x)


# (Cin, Cout, side, kernel, stride, padding, bias): the flagship's configurations
CONVS = {"stem_7x7s2_cin3": (3, 64, 33, 7, 2, 3, False),
         "3x3s1": (64, 64, 12, 3, 1, 1, False),
         "3x3s2": (64, 128, 12, 3, 2, 1, False),
         "1x1s2": (64, 128, 12, 1, 2, 0, False),
         "3x3s1_bias": (64, 32, 9, 3, 1, 1, True),
         "3x3s2_bias": (32, 32, 7, 3, 2, 1, True)}


def _jax_int32(x_nhwc: np.ndarray, w_hwio: np.ndarray, stride: int, pad: int) -> np.ndarray:
    dn = lax.conv_dimension_numbers(x_nhwc.shape, w_hwio.shape, ("NHWC", "HWIO", "NHWC"))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x_nhwc), jnp.asarray(w_hwio), (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=dn, preferred_element_type=jnp.int32))


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONVS))
def test_one_conv_matches_jax(name, dtype, static):
    one_conv_against_jax(name, dtype, static)


def one_conv_against_jax(name: str, dtype: str, static: bool) -> None:
    """The port's int8 conv ``CONVS[name]`` in a ``dtype`` network against
    JAX's ``_int8_conv`` (``quantized_apply`` on one flax conv): the int8
    operands and int32 sums equal; the output within one float32 ulp
    (float32), equal (bfloat16), or within one float16 ulp (float16: both
    round one float32 rescale; equal in practice)."""
    cin, cout, side, k, stride, pad, bias = CONVS[name]
    rng = np.random.default_rng(len(name) + 7 * static)
    x = rng.normal(size=(2, side, side, cin)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    fm = _OneConv(cout, k, stride, pad, bias, None if dtype == "float32" else jdt)
    variables = fm.init(jax.random.PRNGKey(k), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    if bias:
        params["Conv_0"]["bias"] = rng.normal(size=cout).astype(np.float32)
    # the stem reads float32 frames, every other conv its network dtype
    jx = jnp.asarray(x, jnp.float32 if cin == 3 else jdt)
    j_scales = {("Conv_0",): float(np.abs(np.asarray(jx, np.float32)).max()) * 0.8 / 127} \
        if static else None
    j_y = np.asarray(jq.quantized_apply(fm, {"params": params}, jx, act_scales=j_scales)
                     .astype(jnp.float32))

    conv = Conv2d(cin, cout, k, stride, pad, bias=bias,
                  compute_dtype=None if dtype == "float32" else getattr(torch, dtype))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            params["Conv_0"]["kernel"].transpose(3, 2, 0, 1))))
        if bias:
            conv.bias.copy_(torch.from_numpy(params["Conv_0"]["bias"]))
    model = torch.nn.Sequential(conv)
    tx = torch.from_numpy(np.asarray(jx, np.float32).transpose(0, 3, 1, 2).copy()).to(
        torch.float32 if cin == 3 else getattr(torch, dtype))
    t_scales = {"0": j_scales[("Conv_0",)]} if static else None
    swap = tq.Int8Convs(model, t_scales)
    with swap, torch.inference_mode():
        t_y = model(tx)
    assert swap.calls == 1 and t_y.dtype == getattr(torch, dtype)
    assert t_y.shape[1:] == (cout,) + j_y.shape[1:3]

    # operands and int32 sums
    s_x = torch.tensor(t_scales["0"], dtype=torch.float32) if static else k4.dynamic_scale(tx)
    t_q = k4.quantize_input(tx, s_x)
    j_s = jnp.float32(j_scales[("Conv_0",)]) if static else jq.quantize_activation(jx)[1]
    j_q = np.asarray(jnp.round(jnp.clip(jx.astype(jnp.float32) / j_s, -127, 127))
                     .astype(jnp.int8))
    np.testing.assert_array_equal(t_q.numpy().transpose(0, 2, 3, 1), j_q)
    w_i8 = np.asarray(jq.quantize_weight(jnp.asarray(params["Conv_0"]["kernel"]))[0])
    t_acc = k4.int8_conv(tx, k4.prepare_weight(conv.weight), s_x, None, stride, pad,
                         out_dtype=torch.int32)
    np.testing.assert_array_equal(t_acc.numpy().transpose(0, 2, 3, 1),
                                  _jax_int32(j_q, w_i8, stride, pad))

    got = t_y.float().numpy().transpose(0, 2, 3, 1)
    if dtype == "float32":
        np.testing.assert_array_max_ulp(got, j_y, maxulp=1)
    elif dtype == "float16":  # j_y holds float16 values: exact back in float16
        np.testing.assert_array_max_ulp(got.astype(np.float16), j_y.astype(np.float16),
                                        maxulp=1)
    else:
        np.testing.assert_array_equal(got, j_y)


def test_conv_refusals():
    w = k4.prepare_weight(torch.randn(8, 4, 3, 3))
    x = torch.randn(1, 4, 6, 6)
    with pytest.raises(ValueError, match="groups"):
        k4.int8_conv(x, w, groups=2)
    with pytest.raises(ValueError, match="dilation"):
        k4.int8_conv(x, w, dilation=2)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):  # float16 is taken
        k4.int8_conv(x.double(), w)
    with pytest.raises(ValueError, match="explicit padding"):
        k4.int8_conv(x, w, padding="same")


def test_skip_keeps_the_head_float():
    model = torch.nn.Sequential(Conv2d(4, 16, 3, 1, 1), Conv2d(16, 11, 1))
    assert [name for name, _ in tq.eligible_convs(model)] == ["0"]
    assert [name for name, _ in tq.eligible_convs(model, skip=None)] == ["0", "1"]
    # only the port's Conv2d is swapped, as JAX swaps only nn.Conv
    plain = torch.nn.Sequential(torch.nn.Conv2d(4, 16, 3, 1, 1))
    assert tq.eligible_convs(plain) == []


def test_swap_leaves_the_model_as_it_was():
    torch.manual_seed(0)
    model = torch.nn.Sequential(Conv2d(3, 16, 3, 1, 1), torch.nn.ReLU(), Conv2d(16, 16, 3, 2, 1))
    x = torch.randn(2, 3, 10, 10)
    with torch.inference_mode():
        before = model(x)
        q = tq.quantized_apply(model, x)
        after = model(x)
    assert torch.equal(before, after) and not torch.equal(before, q)
    assert "forward" not in vars(model[0])
    rel = (q - before).abs().max() / before.abs().max()
    assert rel < 0.05, rel


# ------------------------------------------------------------------ whole models

def _mimo_cfg(pallas_comm: bool, remat: bool = False) -> dict:
    return {"model": {"arch": "MIMOcom", "agent_num": N, "query_size": 8, "key_size": 64,
                      "multiple_output": True, "pallas_comm": pallas_comm, "remat": remat},
            "data": {"img_rows": IMG, "img_cols": IMG, "commun_label": "mimo"}}


@pytest.fixture(scope="module")
def mimocom():
    """JAX MIMOcom variables with seeded BatchNorm statistics, its port
    twin, and three calibration batches of growing amplitude."""
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(B, N, IMG, IMG, 3)) * s).astype(np.float32)
               for s in (0.5, 1.0, 1.5)]
    cfg = jax_normalize_config(_mimo_cfg(True))
    jm = jax_get_model(cfg, 11)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]), train=False,
                inference="softmax")
    v = jax.tree_util.tree_map(np.asarray, v)

    def stats(tree):
        if "mean" in tree:
            return {"mean": (rng.standard_normal(tree["mean"].shape) * 0.1).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, tree["var"].shape).astype(np.float32)}
        return {k: stats(t) for k, t in tree.items()}

    v = {"params": v["params"], "batch_stats": stats(v["batch_stats"])}
    tcfg = normalize_config(_mimo_cfg(True))
    model = get_model(tcfg, 11)
    model.load_state_dict(state_dict_from_flax(tcfg, v), strict=True)
    return jm, v, model.eval(), tcfg, batches


def test_calibration_matches_jax(mimocom):
    jm, v, model, tcfg, batches = mimocom
    j_scales = jq.calibrate_activations(jm, v, [jnp.asarray(b) for b in batches],
                                        train=False, mo_flag=True, inference="activated")
    mapped = scales_from_flax(tcfg, j_scales)
    t_scales = tq.calibrate_activations(model, [torch.from_numpy(b) for b in batches],
                                        inference="activated")
    assert set(mapped) == set(t_scales) == {n for n, _ in tq.eligible_convs(model)}
    assert len(t_scales) == 48
    for name, s in t_scales.items():
        assert s == pytest.approx(mapped[name], rel=1e-6), name


def test_calibration_max_reduces_across_batches(mimocom):
    _, _, model, _, batches = mimocom
    xs = [torch.from_numpy(b) for b in batches]
    up = tq.calibrate_activations(model, xs, inference="activated")
    down = tq.calibrate_activations(model, xs[::-1], inference="activated")
    last = tq.calibrate_activations(model, xs[:1], inference="activated")
    assert up == down
    stem = "u_encoder.feature_backbone.feature_backbone.conv1"
    assert up[stem] == float(np.abs(batches[-1]).max()) / 127 > last[stem]
    assert all(up[k] >= last[k] for k in up)


def test_scales_json_round_trip(mimocom):
    import json

    _, _, model, _, batches = mimocom
    scales = tq.calibrate_activations(model, [torch.from_numpy(batches[0])],
                                      inference="activated")
    assert tq.scales_from_json(json.loads(json.dumps(tq.scales_to_json(scales)))) == scales


def test_remat_gives_the_same_scales(mimocom):
    _, _, model, tcfg, batches = mimocom
    remat = get_model(normalize_config(_mimo_cfg(True, remat=True)), 11)
    remat.load_state_dict(model.state_dict(), strict=True)
    assert remat.remat
    xs = [torch.from_numpy(b) for b in batches[:2]]
    assert tq.calibrate_activations(remat.train(), xs, inference="activated") == \
        tq.calibrate_activations(model, xs, inference="activated")
    assert remat.training  # calibration ran in eval mode and put the mode back


def test_scales_from_flax_refuses_unknown_paths(mimocom):
    _, _, _, tcfg, _ = mimocom
    with pytest.raises(KeyError, match="no conv"):
        scales_from_flax(tcfg, {("u_encoder", "ResnetEncoder_0", "Conv_99"): 0.1})


@pytest.mark.parametrize("pallas_comm", [True, False], ids=["fused_comm", "dense_comm"])
def test_swap_count_equals_the_jax_interceptor(mimocom, pallas_comm):
    """The port routes as many conv calls through K4 as the JAX interceptor
    swaps with its fused comm step (the port's path). JAX's dense pruned
    modes decode the soft fusion too, a call XLA then drops: one more."""
    _, v, model, _, batches = mimocom
    jm = jax_get_model(jax_normalize_config(_mimo_cfg(pallas_comm)), 11)
    inner = jq.int8_interceptor()
    count = [0]

    def counting(next_fun, args, kwargs, context):
        mod = context.module
        if (type(mod) is fnn.Conv and context.method_name == "__call__"
                and not jq.default_skip(mod)):
            count[0] += 1
        return inner(next_fun, args, kwargs, context)

    with fnn.intercept_methods(counting):
        jax.eval_shape(lambda x: jm.apply(v, x, train=False, mo_flag=True,
                                          inference="activated"), jnp.asarray(batches[0]))
    swap = tq.Int8Convs(model)
    with swap, torch.inference_mode():
        model(torch.from_numpy(batches[0]), inference="activated", full_res=False)
    assert swap.calls == 48
    assert count[0] == swap.calls + (0 if pallas_comm else 1)


# ------------------------------------------------------------------ per_frame_links

@pytest.mark.parametrize("mode", ["activated", "argmax_test", "softmax"])
def test_per_frame_links_matches_jax(mode):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 4, 4)).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    prob = prob + 0.001 * np.eye(4, dtype=np.float32)
    got = per_frame_links(torch.from_numpy(prob), mode, 4).numpy()
    want = np.asarray(jax_per_frame_links(jnp.asarray(prob), mode, 4))
    np.testing.assert_array_equal(got, want)
    if mode == "activated":
        coef = np.where(prob > 0.2, prob, 0).astype(np.float32)
        assert got.mean() == pytest.approx(float(num_connect_offdiag(torch.from_numpy(coef), 4)))
        assert got.mean() == pytest.approx(float(jax_num_connect(jnp.asarray(coef), 4)))


def test_per_frame_links_refuses_topk():
    """``topk`` is ported (tests/test_torch_topk.py); a budget beyond the
    keys, which JAX's ``lax.top_k`` cannot take either, is refused by name."""
    with pytest.raises(ValueError, match="topk"):
        per_frame_links(torch.rand(2, 3, 3), "topk", 3, topk_k=4)
