"""The learning proof (``python -m multiagentperception_tpu_torch.prove_learning``)
against the JAX script scripts/prove_learning.py, on the CPU.

``tradeoff_curve`` and ``int8_miou`` run on one set of weights: MIMOcom at
toy widths (query 8, key 64; 3 agents at 128x128) from the JAX init with
seeded BatchNorm statistics and a peaked graph (test_torch_zoo's
``shared_variables``), carried across by ``convert.state_dict_from_flax``,
over 2 seeded in-memory batches whose labels are the model's own
``softmax`` class maps, so each mode's mIoU says how far its fusion moves the
prediction from the full one. The JAX side gets a stub trainer holding the
state, ``_model_inputs``, ``_labels`` and ``n_classes``.

Tolerances. The tradeoff's modes and their order are equal, each
bandwidth within 1e-6 (a count of links over the frames: equal graphs give
equal counts; one known divergence: XLA's CPU flushes float32 subnormals
to zero and PyTorch keeps them, so a top-k link whose softmax weight is
subnormal counts in the port and not in JAX; at 96x96 these weights give
one such link, 3.96e-41, and topk k=3 reads 2.0 against 1.833; none at
128x128; ROADMAP.md §C), and each mIoU within 2e-3: the port's class map is K1's
(upsample + argmax of the pre-upsample logits, its plain version here),
JAX's the argmax of the full-resolution logits, and the float32 towers sum
in other orders, so a near-tie pixel may fall either way (measured: 0 on
this input). The int8 mIoU is held within 1e-3 on seeded random labels:
each side calibrates its own scales on the first batch (held equal within
relative 1e-6; measured 5.1e-7), and an ulp at a half-step of a conv's
int8 grid flips a value that travels on (tests/test_torch_int8_eval.py:
here 96-98% of the int8 class maps agree), so labels from the float32 maps
would weigh exactly the flipped pixels (measured: 0.073 apart on the
softmax labels, 6e-6 on random ones). JAX runs its ``pallas_comm: true``
model there: its plain dense model also calibrates the decoder on the soft
fusion (ROADMAP.md §C).
"""

from __future__ import annotations

import importlib.util
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import raw_cfg, shared_variables

from multiagentperception_tpu import quantize as jq
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu_torch import prove_learning
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import scales_from_flax, state_dict_from_flax
from multiagentperception_tpu_torch.evaluate import Evaluator

ROOT = Path(__file__).resolve().parents[1]
B, N, IMG, BATCHES = 2, 3, 128, 2
BANDWIDTH_ATOL = 1e-6
MIOU_ATOL = 2e-3
INT8_MIOU_ATOL = 1e-3
SCALES_RTOL = 1e-6
JAX_LABELS = ("train-set mIoU (activated):", "mimo when2com selection accuracy:",
              "who2com (noisy-agent link) accuracy:", "avg bandwidth (links/agent):",
              "train-set mIoU, int8-quantized serving path:",
              "bandwidth-vs-mIoU tradeoff (trained fixture weights):")


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_prove_learning",
                                                  ROOT / "scripts" / "prove_learning.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def shared():
    """(JAX script, JAX stub trainer, port Evaluator, raw config, batches)."""
    cfg = raw_cfg("MIMOcom", N, (IMG, IMG))
    rng = np.random.default_rng(0)
    frames = [(rng.standard_normal((B, N, IMG, IMG, 3)) * 0.5).astype(np.float32)
              for _ in range(BATCHES)]
    variables = shared_variables(cfg, frames[0])
    tcfg = normalize_config(cfg)
    ev = Evaluator(tcfg, "cpu")
    ev.model.load_state_dict(state_dict_from_flax(tcfg, variables), strict=True)
    with torch.inference_mode():
        batches = [(x, ev.model(torch.from_numpy(x), inference="softmax")[0].argmax(1)
                    .reshape(B, N, IMG, IMG).numpy().astype(np.int32)) for x in frames]
    stub = types.SimpleNamespace(
        state=types.SimpleNamespace(params=variables["params"],
                                    batch_stats=variables["batch_stats"]),
        _model_inputs=np.asarray,
        _labels=lambda labels: np.asarray(labels).reshape((-1,) + np.asarray(labels).shape[2:]),
        n_classes=11)
    return _jax_script(), stub, ev, cfg, batches


def test_tradeoff_curve_matches_jax(shared, capsys):
    script, stub, ev, cfg, batches = shared
    want = script.tradeoff_curve(stub, jax_normalize_config(cfg), batches)
    want_out = capsys.readouterr().out
    got = prove_learning.tradeoff_curve(ev, normalize_config(cfg), batches)
    got_out = capsys.readouterr().out
    assert [r[0] for r in got] == [r[0] for r in want] == \
        [f"topk k={k}" for k in range(1, N + 1)] + ["argmax_test", "activated", "softmax"]
    for (mode, got_bw, got_miou), (_, want_bw, want_miou) in zip(got, want):
        assert abs(got_bw - want_bw) <= BANDWIDTH_ATOL, (mode, got_bw, want_bw)
        assert abs(got_miou - want_miou) <= MIOU_ATOL, (mode, got_miou, want_miou)
    assert got_out.splitlines()[:3] == want_out.splitlines()[:3]  # the title and header
    assert len(got_out.splitlines()) == len(want_out.splitlines())
    bandwidths = {mode: bw for mode, bw, _ in got}
    assert bandwidths["softmax"] == pytest.approx(N - 1)  # every other agent's link
    assert [bandwidths[f"topk k={k}"] for k in range(1, N + 1)] == sorted(
        bandwidths[f"topk k={k}"] for k in range(1, N + 1))
    assert dict((m, v) for m, _, v in got)["softmax"] == pytest.approx(1.0, abs=MIOU_ATOL)


def test_int8_miou_matches_jax(shared, monkeypatch):
    """On seeded random labels (a chance-level mIoU, as an untrained model
    scores on the ground truth): labels from the float32 class maps would
    weigh the pixels int8 flips, which differ between the two sides."""
    script, stub, ev, cfg, batches = shared
    rng = np.random.default_rng(5)
    batches = [(x, rng.integers(0, 11, y.shape).astype(np.int32)) for x, y in batches]
    jax_cfg = {**cfg, "model": {**cfg["model"], "pallas_comm": True}}
    jax_model = jax_get_model(jax_normalize_config(jax_cfg), 11)
    calibrated = []  # the scales the JAX script calibrates
    real = jq.calibrate_activations
    monkeypatch.setattr(jq, "calibrate_activations",
                        lambda *a, **kw: calibrated.append(real(*a, **kw)) or calibrated[-1])
    want = script.int8_miou(stub, jax_model, batches)
    got = prove_learning.int8_miou(ev, batches)
    assert abs(got - want) <= INT8_MIOU_ATOL, (got, want)
    # calibrated on the first batch alone, as JAX's: its scales are JAX's
    assert len(calibrated) == 1
    assert ev.int8_convs.act_scales == pytest.approx(
        scales_from_flax(normalize_config(cfg), calibrated[0]), rel=SCALES_RTOL)
    assert ev.int8_convs.calls == 48 * BATCHES  # every eligible conv, each batch


def test_main_runs_on_the_cpu(capsys):
    result = prove_learning.main(iters=2, img=64, frames=2, device="cpu", tradeoff=True)
    out = capsys.readouterr().out
    assert len(result) == 4 and all(math.isfinite(float(v)) for v in result)
    miou, when_acc, who_acc, miou_int8 = result
    assert 0.0 <= miou <= 1.0 and 0.0 <= miou_int8 <= 1.0
    assert 0.0 <= when_acc <= 100.0 and 0.0 <= who_acc <= 100.0
    for label in JAX_LABELS:
        assert label in out, label
    assert "(always-self baseline 66.7%)" in out
    rows = [line.split() for line in out.splitlines()
            if line.strip().startswith(("topk k=", "argmax_test", "activated", "softmax"))]
    assert len(rows) == 6 + 3


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_learning.main(iters=1)
