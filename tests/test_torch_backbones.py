"""The SegNet and FCN backbones, ``feat_squeezer`` and the transposed-conv
block against the JAX package, on the CPU; the int8 path and K4's plan
over their convolutions.

- ``DeconvBNRelu`` against the JAX block on a one-hot input and a random
  one, through the weight bridge's kernel flip: the same x2 geometry,
  pixel for pixel (flax ``SAME`` would move every output by one pixel,
  JAX blocks.py:121-129), to 1e-5.
- Each new encoder, decoder and squeezer in a whole model against the JAX
  model on shared weights (``convert.state_dict_from_flax``, loaded with
  ``strict=True``), in every mode the architecture has, with
  tests/test_torch_zoo.py's tolerances (``pred`` rtol 1e-3 / atol 2e-3,
  graphs 1e-5, actions and bandwidth exact); 64x64 frames, B=2, N=3.
- ``Evaluator.predict`` takes K1 where the decoder has pre-upsample logits
  and the argmax of the full-resolution ones where it has none (SegNet),
  as JAX's eval step does (trainer.py:512-517).
- The SegNet MIMOcom in int8 against JAX's (static scales carried across
  by ``convert.scales_from_flax``; JAX's fused comm step, ``pallas_comm``,
  as tests/test_torch_int8_eval.py compares): every transposed conv stays
  float, each plain conv of 16 channels or more is swapped. Tolerances as
  tests/test_torch_int8_eval.py's static case, for its reason (an ulp of
  the float layers flips an int8 value, and the flip travels): logits
  within 2e-2 of their largest magnitude, class maps on 99.5% of the
  pixels, graph 1e-4, bandwidth equal (measured on the CPU: 1.03e-2 and
  99.88%, the graph within 5.6e-6: the full-resolution logits of the
  SegNet decoder carry its 12 layers of flips).
- ``int8_conv.plan`` at every eligible conv of each new model at the
  flagship's 512x512 and batch 2 x 6 (the fits of
  tests/test_torch_int8_routes.py), and the GEMM op's CPU version against
  the plain int8 convolution at the new geometries (stride 4, Cin 3 on
  the halo route).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from test_torch_int8_routes import _assert_fits
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import (
    assert_outputs_match,
    jax_forward,
    jax_kwargs,
    model_inputs,
    port_forward,
    port_model,
    raw_cfg,
    shared_variables,
)

from multiagentperception_tpu import quantize as jq
from multiagentperception_tpu.models.blocks import DeconvBNRelu as JaxDeconvBNRelu
from multiagentperception_tpu_torch import quantize as tq
from multiagentperception_tpu_torch.config import load_config, normalize_config
from multiagentperception_tpu_torch.convert import scales_from_flax, state_dict_from_flax
from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.models import get_model
from multiagentperception_tpu_torch.models.blocks import ConvTranspose2d, DeconvBNRelu
from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "configs" / "multi-request-multi-support" / "mrms_when2com.yml"
B, N, IMG = 2, 3, 64
SEGNET = {"enc_backbone": "n_segnet_encoder", "dec_backbone": "n_segnet_decoder"}


def _jax_deconv(x_nhwc: np.ndarray, features: int, seed: int):
    block = JaxDeconvBNRelu(features)
    v = block.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc), False)
    rng = np.random.default_rng(seed)
    stats = v["batch_stats"]["BatchNorm_0"]
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": {"BatchNorm_0": {
             "mean": (rng.standard_normal(stats["mean"].shape) * 0.1).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)}}}
    v["params"]["ConvTranspose_0"]["bias"] = rng.standard_normal(features).astype(np.float32)
    return np.asarray(block.apply(v, jnp.asarray(x_nhwc), False)), v


def _port_deconv(v, cin: int, features: int) -> DeconvBNRelu:
    """The port's block with JAX's weights, through the bridge's own layer
    names (a one-layer SegNet-decoder walk would do the same)."""
    from multiagentperception_tpu_torch.convert import _dcbr, _Out

    out = _Out()
    _dcbr(out, "blk", v["params"], v["batch_stats"])
    block = DeconvBNRelu(cin, features)
    block.load_state_dict({k.removeprefix("blk."): t for k, t in out.sd.items()}, strict=True)
    return block.eval()


@pytest.mark.parametrize("kind", ["one_hot", "random"])
def test_deconv_block_is_jax_pixel_for_pixel(kind):
    cin, feats, h, w = 4, 6, 5, 7
    x = np.zeros((1, h, w, cin), np.float32)
    if kind == "one_hot":
        x[0, 2, 3, 1] = 1.0  # one pixel: every output tap shows where it lands
    else:
        x = np.random.default_rng(2).standard_normal((2, h, w, cin)).astype(np.float32)
    want, v = _jax_deconv(x, feats, seed=3)
    block = _port_deconv(v, cin, feats)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (x.shape[0], 2 * h, 2 * w, feats)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kind == "one_hot":  # flax SAME padding would place the taps a pixel off
        same = fnn.ConvTranspose(feats, (3, 3), strides=(2, 2), padding="SAME")
        moved = np.asarray(same.apply({"params": v["params"]["ConvTranspose_0"]},
                                      jnp.asarray(x)))
        conv = np.asarray(fnn.ConvTranspose(feats, (3, 3), strides=(2, 2), padding=((1, 2),) * 2)
                          .apply({"params": v["params"]["ConvTranspose_0"]}, jnp.asarray(x)))
        assert not np.allclose(moved, conv)


def test_transposed_conv_computes_in_bf16_with_float32_parameters():
    conv = ConvTranspose2d(8, 4, 3, 2, 1, output_padding=1, compute_dtype=torch.bfloat16)
    x = torch.randn(2, 8, 5, 5)
    y = conv(x)
    assert y.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    want = torch.nn.functional.conv_transpose2d(
        x.bfloat16(), conv.weight.bfloat16(), conv.bias.bfloat16(), 2, 1, 1)
    assert torch.equal(y, want)


# id: (arch, model keys, modes): each encoder, decoder and squeezer in a model
CASES = {
    "segnet_mimocom": ("MIMOcom", SEGNET, ("activated", "argmax_test", "topk", "softmax")),
    "fcn_mimocom": ("MIMOcom", {"dec_backbone": "FCN_decoder"}, ("activated", "softmax")),
    "squeezer2_mimocom": ("MIMOcom", {"feat_squeezer": 2}, ("activated", "argmax_test")),
    "squeezer4_fcn_mimocom": ("MIMOcom", {"feat_squeezer": 4, "dec_backbone": "FCN_decoder"},
                              ("activated", "topk")),
    "segnet_encoder_single": ("Single_agent", {"enc_backbone": "n_segnet_encoder"}, (None,)),
    "segnet_decoder_squeezer2_all": ("All_agents", {"dec_backbone": "n_segnet_decoder",
                                                    "feat_squeezer": 2}, (None,)),
    "squeezer4_segnet_mimo_all": ("MIMO_All_agents", {**SEGNET, "feat_squeezer": 4,
                                                      "shuffle_features": "ComNet"}, (None,)),
    "fcn_squeezer2_when2com": ("LearnWhen2Com", {"dec_backbone": "FCN_decoder",
                                                 "feat_squeezer": 2, "shared_img_encoder":
                                                 "unified"}, ("activated", "softmax")),
    "segnet_who2com": ("LearnWho2Com", {**SEGNET, "shared_img_encoder": "unified"},
                       ("argmax_test",)),
    "segnet_mimocomwho": ("MIMOcomWho", {"enc_backbone": "n_segnet_encoder",
                                         "feat_squeezer": 2}, ("activated",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_backbone_models_match_jax(case):
    arch, keys, modes = CASES[case]
    cfg = raw_cfg(arch, N, (IMG, IMG), **keys)
    x = model_inputs(cfg, (B, N, IMG, IMG, 3), seed=11)
    variables = shared_variables(cfg, x, seed=11)
    model = port_model(cfg, variables)  # strict=True
    for mode in modes:
        want = jax_forward(cfg, variables, x, mode or "softmax")
        got = port_forward(cfg, model, x, mode or "softmax")
        assert_outputs_match(arch, mode, got, want)


@pytest.mark.parametrize("keys,k1_launches", [(SEGNET, 0), ({"dec_backbone": "FCN_decoder"}, 1)],
                         ids=["segnet", "fcn"])
def test_predict_takes_k1_only_where_the_decoder_has_pre_logits(keys, k1_launches, monkeypatch):
    """On the CPU the class map of K1's plain version (the op's CPU
    implementation counts nothing): count the wrapper's calls instead."""
    cfg = normalize_config(raw_cfg("MIMOcom", N, (IMG, IMG), **keys))
    ev = Evaluator(cfg, device="cpu")
    calls = []
    real = k1.upsample_argmax
    monkeypatch.setattr(k1, "upsample_argmax", lambda *a: calls.append(1) or real(*a))
    x = (np.random.default_rng(0).standard_normal((B, N, IMG, IMG, 3)) * 0.5).astype(np.float32)
    cls, _, _ = ev.predict(x)
    assert len(calls) == k1_launches
    with torch.inference_mode():
        logits = ev.model(torch.from_numpy(x), inference="activated")[0]
    assert cls.dtype == torch.int32 and torch.equal(cls, logits.argmax(1).to(torch.int32))


@pytest.fixture(scope="module")
def segnet_int8():
    """The SegNet MIMOcom from a JAX init (attention peaked, BatchNorm
    statistics seeded) with JAX's calibrated static scales."""
    cfg = raw_cfg("MIMOcom", N, (IMG, IMG), pallas_comm=True, **SEGNET)
    x = model_inputs(cfg, (B, N, IMG, IMG, 3), seed=12)
    variables = shared_variables(cfg, x, seed=12)
    model = port_model(cfg, variables)
    calib = [model_inputs(cfg, x.shape, seed=13 + i) for i in range(2)]
    from multiagentperception_tpu.config import normalize_config as jax_normalize_config
    from multiagentperception_tpu.models import get_model as jax_get_model

    jm = jax_get_model(jax_normalize_config(cfg), 11)
    j_scales = jq.calibrate_activations(jm, variables, [jnp.asarray(b) for b in calib],
                                        **jax_kwargs(cfg, False, "activated"))
    return cfg, x, variables, model, jm, j_scales


def test_segnet_int8_swaps_plain_convs_only(segnet_int8):
    cfg, _, _, model, _, j_scales = segnet_int8
    names = {n for n, _ in tq.eligible_convs(model)}
    transposed = [n for n, m in model.named_modules() if isinstance(m, torch.nn.ConvTranspose2d)]
    assert transposed and not names & set(transposed)
    # every plain conv of >= 16 channels: the towers' 13 + 13 + 1 + 1 + 5, the decoder's 6
    assert len(names) == 13 + 1 + 13 + 1 + 5 + 6
    assert set(scales_from_flax(normalize_config(cfg), j_scales)) <= names


def test_segnet_int8_matches_jax(segnet_int8):
    cfg, x, variables, model, jm, j_scales = segnet_int8
    out = jq.quantized_apply(jm, variables, jnp.asarray(x), act_scales=j_scales,
                             **jax_kwargs(cfg, False, "activated"))
    want_logits = np.asarray(out[0], np.float32).transpose(0, 3, 1, 2)
    scales = scales_from_flax(normalize_config(cfg), j_scales)
    swap = tq.Int8Convs(model, scales)
    with swap, torch.inference_mode():
        got = model(torch.from_numpy(x), inference="activated", full_res=False)
    assert swap.calls == len(swap.convs)  # SegNet decodes once: every conv once
    logits = got[0].numpy()
    assert logits.shape[-2:] == (IMG, IMG)  # no pre-upsample logits
    gap = np.abs(logits - want_logits).max() / np.abs(want_logits).max()
    assert gap <= 2e-2, gap
    agree = (logits.argmax(1) == np.asarray(out[0]).argmax(-1)).mean()
    assert agree >= 0.995, agree
    np.testing.assert_allclose(got[1].numpy(), np.asarray(out[1]), rtol=0, atol=1e-4)
    assert float(got[3]) == float(out[3])


def _model_geometries(keys: dict) -> list[tuple]:
    cfg = load_config(str(FLAGSHIP))
    cfg["model"].update(keys)
    with torch.device("meta"):
        model = get_model(cfg, 11)
    shapes = tq.conv_input_shapes(model, (2, 6, 512, 512, 3), inference="activated",
                                  full_res=False)
    mods = dict(tq.eligible_convs(model))
    return sorted({(*shapes[n], m.out_channels, m.kernel_size[0], m.stride[0], m.padding[0])
                   for n, m in mods.items()})


NEW_MODELS = {"segnet": SEGNET, "fcn": {"dec_backbone": "FCN_decoder"},
              "squeezer2": {"feat_squeezer": 2}, "squeezer4": {"feat_squeezer": 4}}


@pytest.mark.parametrize("name", list(NEW_MODELS))
def test_plan_for_every_conv_of_the_new_models(name):
    geometries = _model_geometries(NEW_MODELS[name])
    assert geometries
    for n, cin, h, w, cout, k, stride, pad in geometries:
        g = k4.plan(n, cin, h, w, cout, k, k, stride, pad)
        _assert_fits(g)
        want = "s2d" if (cin <= 4 and stride == 2) else (
            "halo" if (k, stride) == (3, 1) else "gather16")
        assert g.route == want, (cin, h, cout, k, stride, g.route)
        w_i8 = torch.zeros(cout, cin, k, k, dtype=torch.int8)
        assert k4.Int8Weight(w_i8, torch.ones(cout), k4.pack_weight(w_i8)).operand(g).shape == \
            (g.slices, g.stages, 4, g.nb, 16)
    if name == "segnet":  # the stem at Cin 3 on the halo, 3x3 stride 2 from 64 to 512 channels
        assert (12, 3, 512, 512, 64, 3, 1, 1) in geometries
        assert {c for (_, c, _, _, _, _, s, _) in geometries if s == 2} == {64, 128, 256, 512}
    if name == "squeezer4":
        assert (12, 512, 16, 16, 512, 3, 4, 1) in geometries


@pytest.mark.parametrize("cin,cout,side,k,stride,pad,route", [
    (3, 64, 12, 3, 1, 1, "halo"), (64, 64, 12, 3, 2, 1, "gather16"),
    (512, 512, 8, 3, 4, 1, "gather16"), (512, 512, 8, 3, 2, 1, "gather16")],
    ids=["segnet_stem_cin3", "3x3s2_64", "squeezer_3x3s4", "squeezer_3x3s2"])
def test_gemm_op_cpu_version_at_the_new_geometries(cin, cout, side, k, stride, pad, route):
    """The ops' CPU implementations (scratch, then the exact sums of the
    operand the plan packs) equal ``int8_conv_plain`` to the bit."""
    gen = torch.Generator().manual_seed(cin + side)
    x = torch.randn(2, cin, side, side, generator=gen)
    w = k4.prepare_weight(torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5)
    bias = torch.randn(cout, generator=gen)
    s_x = k4.dynamic_scale(x)
    assert k4.plan(2, cin, side, side, cout, k, k, stride, pad).route == route
    got = k4.int8_conv(x, w, s_x, bias, stride, pad)
    want = k4.int8_conv_plain(x, w, s_x, bias, stride, pad)
    assert torch.equal(got, want)
