"""The port's int8 eval path against the JAX package's, on the CPU: whole
models through ``quantize.make_int8_eval_fn`` / ``Int8Convs``, the
``Evaluator``'s calibration, and the ``test --int8`` CLI.

Tolerances. With static scales (JAX's carried across by
``convert.scales_from_flax``) both packages quantize every conv's input on
the same grid, but their float32 layers between the int8 convs
(BatchNorm, ReLU, the residual adds, the attention) round at other places.
Where a value lies within a float32 rounding of a half-step of the grid,
the two sides round it to neighbouring int8 values, and that one step of
``s_x`` travels on through the towers. So the pre-upsample logits are held
within 2e-2 of their largest magnitude (measured: 4.7e-7, no value flipped
at this input), the class maps on at least 99.5% of the pixels, the graph
within 1e-4 and the per-frame bandwidth exactly.

With dynamic scales each side's scale is the max |x| of its own
activation, an extreme value: one flipped int8 value upstream moves it by
~1e-3 (measured: 6.6e-4 at layer3 of the value tower, 1.7e-2 at
PolicyNet4's conv3), which moves the whole next grid, so many values flip
from there on. Measured on this input: logits 4.8e-2 of their largest
magnitude apart, class maps 98.0% equal, the graph within 1e-11. The
dynamic mode is held to 1e-1 and 97% (each conv alone is bit-exact against
JAX's in both modes: tests/test_torch_quantize.py), the graph and the
bandwidth as above.

LearnWho2Com (static scales) meets the flip in its value tower's layer1
(measured: the input of ``layer1.1.conv2`` 8.6e-4 of its max apart, from
one value of ``layer1.1.conv1``'s input 1.4e-7 apart), and the flips
spread from there: logits 2.3e-2 of their largest magnitude apart, class
maps 98.1% equal. It predicts for agent 0 only, so its class map is 2
frames of 4x4 logit cells, each covering 32x32 pixels: one cell's argmax
flipped moves 3% of a frame. It is held to 5e-2 and 97%, the graph to
1e-4 (measured 1.7e-9).

The port's int8 agrees with its own float32 eval on more than 95% of the
pixels, JAX's rule for its own (tests/test_quantize.py
``test_mimocom_int8_agrees_with_f32``).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as fnn
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import jax_kwargs, raw_cfg, seeded_stats

from multiagentperception_tpu import quantize as jq
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.data.synthetic import generate_fixture
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.ops.comm import per_frame_links as jax_per_frame_links
from multiagentperception_tpu.ops.pallas.upsample_argmax import find_pre_logits
from multiagentperception_tpu_torch import quantize as tq
from multiagentperception_tpu_torch import test as port_cli
from multiagentperception_tpu_torch.config import load_config, normalize_config
from multiagentperception_tpu_torch.convert import scales_from_flax, state_dict_from_flax
from multiagentperception_tpu_torch.data import DataLoader, get_loader
from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.export import make_eval_fn
from multiagentperception_tpu_torch.models import get_model, init_weights
from multiagentperception_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax_plain

B, N, IMG = 2, 3, 128
# by case (module docstring): of the logits' largest magnitude, and of the pixels
LOGITS_TOL = {"static": 2e-2, "dynamic": 1e-1, "who2com": 5e-2}
CLASS_AGREEMENT = {"static": 0.995, "dynamic": 0.97, "who2com": 0.97}
GRAPH_ATOL = 1e-4
PROJ_SCALE = 10.0  # a peaked graph: `activated` prunes some links, keeps others


def _jax_setup(cfg: dict, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, N, IMG, IMG, 3)) * 0.5).astype(np.float32)
    jm = jax_get_model(jax_normalize_config(cfg), 11)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(seed), "action": jax.random.PRNGKey(seed + 1)},
        jnp.asarray(x), **jax_kwargs(cfg, False)))
    params = v["params"]
    for name in ("MIMOGeneralDotAttention_0", "GeneralDotAttention_0"):
        if name in params:
            dense = params[name]["proj" if "proj" in params[name] else "Dense_0"]
            dense["kernel"] = dense["kernel"] * PROJ_SCALE
    v = {"params": params, "batch_stats": seeded_stats(v["batch_stats"], rng)}
    tcfg = normalize_config(cfg)
    model = get_model(tcfg, 11)
    model.load_state_dict(state_dict_from_flax(tcfg, v), strict=True)
    calib = [(rng.standard_normal(x.shape) * 0.5).astype(np.float32) for _ in range(2)]
    return jm, v, model.eval(), tcfg, x, calib


@pytest.fixture(scope="module")
def mimocom():
    cfg = raw_cfg("MIMOcom", N, (IMG, IMG), pallas_comm=True)
    jm, v, model, tcfg, x, calib = _jax_setup(cfg)
    j_scales = jq.calibrate_activations(jm, v, [jnp.asarray(b) for b in calib],
                                        **jax_kwargs(cfg, False, "activated"))
    return jm, v, model, tcfg, x, j_scales


def _jax_int8(jm, v, x, cfg, inference, j_scales):
    """JAX's int8 forward (eager, as ``quantized_apply`` runs it): the
    pre-upsample logits NCHW, the class map, the graph, the bandwidth."""
    out, mut = jq.quantized_apply(jm, v, jnp.asarray(x), act_scales=j_scales,
                                  mutable=["intermediates"],
                                  **jax_kwargs(cfg, False, inference))
    pre = np.asarray(find_pre_logits(mut["intermediates"]), np.float32).transpose(0, 3, 1, 2)
    cls = np.asarray(jnp.argmax(out[0], axis=-1))
    return pre, cls, np.asarray(out[1]), np.asarray(out[3]) if len(out) > 3 else None


def _port_int8(model, x, inference, scales):
    swap = tq.Int8Convs(model, scales)
    with swap, torch.inference_mode():
        out = model(torch.from_numpy(x), inference=inference, full_res=False)
    pre = out[0]
    return (pre.float().numpy(), upsample_argmax_plain(pre, IMG, IMG).numpy(),
            out[1].numpy(), out[3] if len(out) > 3 else None, swap.calls)


def _assert_agrees(got_pre, want_pre, got_cls, want_cls, mode: str = "static") -> None:
    gap = np.abs(got_pre - want_pre).max() / np.abs(want_pre).max()
    assert gap <= LOGITS_TOL[mode], gap
    agree = (got_cls == want_cls).mean()
    assert agree >= CLASS_AGREEMENT[mode], agree


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_mimocom_int8_matches_jax(mimocom, static):
    jm, v, model, tcfg, x, j_scales = mimocom
    j_scales = j_scales if static else None
    want_pre, want_cls, want_prob, want_nc = _jax_int8(
        jm, v, x, raw_cfg("MIMOcom", N, (IMG, IMG)), "activated", j_scales)
    scales = scales_from_flax(tcfg, j_scales) if static else None
    got_pre, got_cls, got_prob, got_nc, calls = _port_int8(model, x, "activated", scales)
    assert calls == 48
    mode = "static" if static else "dynamic"
    _assert_agrees(got_pre, want_pre, got_cls.reshape(want_cls.shape), want_cls, mode)
    np.testing.assert_allclose(got_prob, want_prob, rtol=0, atol=GRAPH_ATOL)
    assert float(got_nc) == float(want_nc)

    # the serving function: per-frame bandwidth equal to JAX's, its mean the model's
    # (JAX's make_int8_eval_fn returns argmax(pred) and per_frame_links(graph)
    # of this same forward: quantize.py:222-248, export.py:38-45)
    cls, prob, per_frame = tq.make_int8_eval_fn(model, act_scales=scales)(torch.from_numpy(x))
    assert cls.dtype == torch.int32 and cls.shape == (B * N, IMG, IMG)
    assert (cls.numpy() == want_cls.reshape(cls.shape)).mean() >= CLASS_AGREEMENT[mode]
    np.testing.assert_array_equal(per_frame.numpy(), np.asarray(
        jax_per_frame_links(jnp.asarray(want_prob), "activated", N)))
    assert float(per_frame.mean()) == pytest.approx(float(want_nc))
    assert 0 < float(want_nc) < N - 1  # a real pruning: some links kept, some not


def test_mimocom_int8_agrees_with_its_float32(mimocom):
    _, _, model, tcfg, x, j_scales = mimocom
    x = torch.from_numpy(x)
    cls32 = make_eval_fn(model)(x)[0]
    for scales in (scales_from_flax(tcfg, j_scales), None):
        cls8 = make_eval_fn(model, apply_fn=lambda images, **kw: tq.quantized_apply(
            model, images, act_scales=scales, **kw))(x)[0]
        assert (cls8 == cls32).float().mean().item() > 0.95


def test_learnwho2com_int8_matches_jax():
    cfg = raw_cfg("LearnWho2Com", N, (IMG, IMG), shared_img_encoder="unified",
                  attention="general", query=True)
    jm, v, model, tcfg, x, calib = _jax_setup(cfg, seed=3)
    kw = jax_kwargs(cfg, False, "argmax_test")
    j_scales = jq.calibrate_activations(jm, v, [jnp.asarray(b) for b in calib], **kw)
    scales = scales_from_flax(tcfg, j_scales)
    assert scales == pytest.approx(tq.calibrate_activations(
        model, [torch.from_numpy(b) for b in calib], inference="argmax_test"), rel=1e-6)
    want_pre, want_cls, want_prob, _ = _jax_int8(jm, v, x, cfg, "argmax_test", j_scales)
    got_pre, got_cls, got_prob, _, calls = _port_int8(model, x, "argmax_test", scales)

    count = [0]
    inner = jq.int8_interceptor(act_scales=j_scales)

    def counting(next_fun, args, kwargs, context):
        if (type(context.module) is fnn.Conv and context.method_name == "__call__"
                and not jq.default_skip(context.module)):
            count[0] += 1
        return inner(next_fun, args, kwargs, context)

    with fnn.intercept_methods(counting):
        jax.eval_shape(lambda a: jm.apply(v, a, **kw), jnp.asarray(x))
    assert calls == count[0] == len(scales)
    _assert_agrees(got_pre, want_pre, got_cls.reshape(want_cls.shape), want_cls, "who2com")
    np.testing.assert_allclose(got_prob, want_prob, rtol=0, atol=GRAPH_ATOL)


# ------------------------------------------------------------------ Evaluator and CLI

FIX_IMG = 64


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The synthetic 6-agent fixture at 64x64, its YAML and a reference-format
    .pkl of the port's seeded init (a peaked graph)."""
    work = tmp_path_factory.mktemp("torch_int8_eval")
    root = str(work / "data")
    generate_fixture(root, target_view="6agent", img_size=FIX_IMG, frames_per_traj=2)
    cfg = {"model": {"arch": "MIMOcom", "agent_num": 6, "shared_img_encoder": "unified",
                     "attention": "general", "sparse": False, "query": True, "query_size": 8,
                     "key_size": 64, "enc_backbone": "resnet_encoder",
                     "dec_backbone": "simple_decoder", "feat_squeezer": -1,
                     "feat_channel": 512, "multiple_output": True},
           "data": {"dataset": "airsim", "train_split": "train", "val_split": "val",
                    "test_split": "test", "img_rows": FIX_IMG, "img_cols": FIX_IMG,
                    "path": root, "target_view": "6agent", "commun_label": "mimo"},
           "training": {"batch_size": 2, "n_workers": 1, "calib_batches": 2,
                        "optimizer": {"name": "adam", "lr": 1e-4},
                        "loss": {"name": "cross_entropy", "size_average": True}}}
    yml = work / "smoke.yml"
    yml.write_text(yaml.safe_dump(cfg))
    model = init_weights(get_model(load_config(str(yml)), 11), 0)
    pkl = str(work / "mimocom.pkl")
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0}, pkl)
    return str(yml), pkl


def _loader(cfg, split):
    d = cfg["data"]
    ds = get_loader(d["dataset"])(root=d["path"], split=split,
                                  img_size=(d["img_rows"], d["img_cols"]),
                                  commun_label=d["commun_label"], target_view=d["target_view"])
    return DataLoader(ds, cfg["training"]["batch_size"], num_workers=1)


def test_calibration_sources_in_jax_order(fixture, caplog):
    yml, pkl = fixture
    cfg = load_config(yml)
    ev = Evaluator(cfg, device="cpu")
    ev.load_weight(pkl)
    test, train = _loader(cfg, "test"), _loader(cfg, "train")

    def scales_of(loader):
        n = min(len(loader.dataset),
                cfg["training"]["batch_size"] * cfg["training"]["calib_batches"])
        frames = np.stack([np.asarray(loader.dataset[i][0]) for i in range(n)])
        batches = [ev._images(frames[i:i + 2]) for i in range(0, n, 2)]
        return tq.calibrate_activations(ev.model, batches, inference="activated",
                                        full_res=False)

    with caplog.at_level(logging.WARNING):
        assert ev._calibrate_int8(test, None, calib_loader=train) == scales_of(train)
        ev.trainloader = train
        assert ev._calibrate_int8(test, None) == scales_of(train)
        assert "falling back" not in caplog.text
        ev.trainloader = None
        assert ev._calibrate_int8(test, None) == scales_of(test) != scales_of(train)
    assert "falling back to the evaluation loader" in caplog.text


def test_int8_evaluate_and_load_weight_clears_the_weights(fixture):
    yml, pkl = fixture
    cfg = load_config(yml)
    ev = Evaluator(cfg, device="cpu")
    ev.load_weight(pkl)
    test = _loader(cfg, "test")
    ev.evaluate(test)
    f32 = ev.last_eval_metrics
    ev.evaluate(test, int8=True, calib_loader=_loader(cfg, "train"))
    i8 = ev.last_eval_metrics
    assert ev.int8_convs.calls == 48 * len(test) and len(ev.int8_convs._weights) == 48
    assert "forward" not in vars(ev.model.u_encoder.squeezer.cbr_unit[0])  # swap undone
    pixels = f32.confusion_matrix.sum()
    assert i8.confusion_matrix.sum() == pixels
    # int8 against float32: the class maps differ on few pixels
    assert np.abs(i8.confusion_matrix - f32.confusion_matrix).sum() / 2 < 0.05 * pixels
    ev.load_weight(pkl)
    assert not ev.int8_convs._weights


def test_cli_int8_runs_on_the_fixture(fixture, capsys):
    yml, pkl = fixture
    got = port_cli.main(["--config", yml, "--model_path", pkl, "--device", "cpu", "--int8",
                         "--calib_batches", "1"])
    out = capsys.readouterr().out
    assert got.confusion_matrix.sum() > 0 and np.isfinite(got.get_avg_bandW())
    for line in ("Bandwidth:", "Normal", "Noise", "Overall"):
        assert line in out
    port_cli.main(["--config", yml, "--model_path", pkl, "--device", "cpu", "--int8",
                   "--calib_split", "no_such_split"])
    assert "calibration split 'no_such_split' unavailable" in capsys.readouterr().out
