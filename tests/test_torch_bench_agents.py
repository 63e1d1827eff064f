"""The agent-count sweep (``python -m multiagentperception_tpu_torch.bench_agents``)
on the CPU through its test hook (``--tiny``: 64x64 frames, N = 2 and 17).

It prints the JAX script's table (scripts/bench_agents.py) with K1's and
K2's launches a step and K2's design, the cluster design up to 16 agents
and the wide one above; an N that fails prints its line, the sweep goes
on, and the exit code is 1. Without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import pytest
import torch
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

from multiagentperception_tpu_torch import bench, bench_agents


def _rows(out: str) -> dict:
    """The table's rows by N: the whitespace-split fields of each."""
    return {int(line.split()[0]): line.split() for line in out.splitlines()
            if line[:4].strip().isdigit()}


def test_tiny_sweep_prints_every_row(capsys):
    assert bench_agents.main(["--tiny", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# MIMOcom eval, 64^2, B*N=17, bfloat16, activated, cpu")
    rows = _rows(out)
    assert sorted(rows) == [2, 17]
    assert rows[2][1] == "8" and rows[17][1] == "1"  # batch max(17 // N, 1)
    assert rows[2][-1] == "cluster" and rows[17][7] == "wide"
    assert "per-frame cost vs N=2" in out
    for fields in rows.values():
        assert float(fields[2]) > 0 and float(fields[3]) > 0  # step ms, frames/s


def test_a_failing_agent_count_fails_the_sweep(monkeypatch, capsys):
    """No swallowed failure: N = 17 raises, its line says so, N = 2 still
    runs, and the exit code is 1."""
    real = bench_agents.bench_n

    def flaky(agents, *args, **kwargs):
        if agents == 17:
            raise RuntimeError("injected failure at N=17")
        return real(agents, *args, **kwargs)

    monkeypatch.setattr(bench_agents, "bench_n", flaky)
    assert bench_agents.main(["--tiny", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    rows = _rows(captured.out)
    assert rows[2][-1] == "cluster"
    assert rows[17][2] == "failed:" and "injected failure at N=17" in captured.out
    assert "N = [17] failed" in captured.err


def test_sweep_rows_and_design(monkeypatch):
    """``sweep`` returns a row per N with the launches counted over every
    step run (0 on the CPU: the plain versions launch nothing) and the
    design ``comm_fusion.plan`` names."""
    rows = bench_agents.sweep(img=64, frames=4, agents=(3, 20), dtype="float32",
                              device="cpu", k_lo=1, k_hi=2)
    assert [(r["agents"], r["batch"], r["design"], r["ok"]) for r in rows] == [
        (3, 1, "cluster", True), (20, 1, "wide", True)]
    for r in rows:
        assert r["steps"] == 1 + 2 + bench.TIMED_PAIRS * 3  # warm-up, then the pairs
        assert r["launches"] == {"upsample_argmax": 0, "comm_fusion": 0}
        assert r["ms_per_frame"] == pytest.approx(r["step_ms"] / (r["batch"] * r["agents"]))


def test_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_agents.main(["--tiny"])
