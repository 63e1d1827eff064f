"""The eval loop's pipeline depth (``Evaluator._pipelined(loader, depth)``,
JAX ``Trainer._pipelined_eval``) and the bench that times it
(``python -m multiagentperception_tpu_torch.bench_eval_pipeline``,
scripts/bench_eval_pipeline.py's port), on the CPU.

At every depth the evaluator yields the same results in the same order;
at depth d the result of batch k is handed over once batches up to k + d
have been dispatched (and no more), so depth 0 reads each batch back
before the next one is dispatched. The bench runs both legs (float32
frames and raw uint8 ones normalized on the device) through its test hook
(``--tiny``) and raises where the depths' tallies differ.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import raw_cfg

from multiagentperception_tpu_torch import bench_eval_pipeline as bep
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.evaluate import PIPELINE_DEPTH, Evaluator
from multiagentperception_tpu_torch.models import init_weights

B, N, IMG, BATCHES = 2, 3, 64, 4
DEPTHS = (0, 1, PIPELINE_DEPTH)


class CountingLoader:
    """A list of batches that counts how many have been taken."""

    def __init__(self, batches):
        self.batches, self.taken = batches, 0

    def __iter__(self):
        for batch in self.batches:
            self.taken += 1
            yield batch


@pytest.fixture(scope="module")
def evaluator():
    cfg = raw_cfg("MIMOcom", N, (IMG, IMG))
    cfg["data"].update(commun_label="mimo", target_view="6agent")
    ev = Evaluator(normalize_config(cfg), "cpu")
    init_weights(ev.model, 0)
    return ev, bep.seeded_batches(B, IMG, N, BATCHES, raw_uint8=False)


def _pass(ev: Evaluator, batches, depth: int) -> tuple[list, list]:
    """Each batch's results as numpy, and how many batches the loader had
    given when each was handed over."""
    loader = CountingLoader(batches)
    results, taken = [], []
    for res, commun_label in ev._pipelined(loader, depth=depth, inference="activated"):
        taken.append(loader.taken)
        results.append(({k: v.numpy() for k, v in res.items()}, commun_label))
    return results, taken


@pytest.mark.parametrize("depth", DEPTHS)
def test_every_depth_yields_the_same_results_in_order(evaluator, depth):
    ev, batches = evaluator
    want, _ = _pass(ev, batches, PIPELINE_DEPTH)
    got, taken = _pass(ev, batches, depth)
    assert len(got) == len(want) == BATCHES
    for (g, g_cl), (w, w_cl), batch in zip(got, want, batches):
        assert sorted(g) == sorted(w) == ["action", "hist", "hist_neg", "hist_pos",
                                          "num_connect"]
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert g_cl is batch[2] and w_cl is batch[2]
    assert taken == [min(k + 1 + depth, BATCHES) for k in range(BATCHES)]


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
def test_bench_runs_both_legs(uint8, capsys):
    assert bep._cli(["--tiny", "--device", "cpu"] + (["--uint8"] if uint8 else [])) == 0
    lines = capsys.readouterr().out.splitlines()
    tag = "uint8+device-norm" if uint8 else "f32"
    assert lines[0].startswith(f"[{tag}] sync  (depth=0): ")
    assert lines[1].startswith(f"[{tag}] async (depth=2): ")
    assert lines[2].startswith(f"[{tag}] speedup: ") and lines[2].endswith("x")
    r = json.loads(lines[3])
    frames = bep.TINY["batch"] * 6 * bep.TINY["n_batches"]
    assert (r["tag"], r["raw_uint8"], r["frames"], r["device"], r["card"]) == (
        tag, uint8, frames, "cpu", None)
    assert r["sync_frames_per_s"] == pytest.approx(frames / r["sync_s"])
    assert r["async_frames_per_s"] == pytest.approx(frames / r["async_s"])
    assert r["speedup"] == pytest.approx(r["sync_s"] / r["async_s"])
    # the plain versions run on the CPU and count nothing
    assert r["launches_per_pass"] == {f"depth{d}": {"upsample_argmax": 0, "comm_fusion": 0}
                                      for d in (0, PIPELINE_DEPTH)}


def test_bench_raises_where_the_depths_differ(monkeypatch):
    real = bep.run_pass

    def off_by_one(ev, batches, depth):
        seconds, tallies, launches = real(ev, batches, depth)
        if depth == 0:
            tallies = {**tallies, "count": tallies["count"] + 1}
        return seconds, tallies, launches

    monkeypatch.setattr(bep, "run_pass", off_by_one)
    with pytest.raises(AssertionError, match="different metrics"):
        bep.measure(batch=1, img=IMG, agents=2, n_batches=2, reps=1, device="cpu")


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bep._cli(["--tiny"])
