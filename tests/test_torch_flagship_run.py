"""The flagship run through the train CLI
(``python -m multiagentperception_tpu_torch.run_flagship_512``) against the
JAX script scripts/run_flagship_512.py, on the CPU.

- ``derive_config`` equals the YAML the JAX script's ``main`` writes for
  the same flags (its ``subprocess.call`` patched to return 0, ``--root``
  an existing directory so no fixture is made), but for the paths under
  each run's own ``--workdir``.
- ``report`` prints what the JAX script prints for the same log: the
  port's own CLI log of the run below, handed to the JAX ``main`` by the
  patched ``subprocess.call``; and that log with ``Time/Image`` lines in
  the trainer's format added (the run below is too short to print one:
  ``print_interval`` is 50).
- The port's script at 64x64, 4 iterations, ``val_interval`` 2, 2 frames a
  trajectory and ``steps_per_call`` 2 on the CPU: rc 0, two validations,
  a best checkpoint, the post-train test with its bandwidth, the memory
  line at each validation.
"""

from __future__ import annotations

import glob
import importlib.util
import io
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch
import yaml

from multiagentperception_tpu_torch import run_flagship_512 as port

ROOT = Path(__file__).resolve().parents[1]
CPU_RUN = ["--img", "64", "--iters", "4", "--val_interval", "2", "--frames", "2",
           "--steps_per_call", "2", "--device", "cpu"]
RUN_THREADS = "2"  # the CLI subprocess's torch threads, beside the test runner's workers


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_run_flagship_512",
                                                  ROOT / "scripts" / "run_flagship_512.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_main(monkeypatch, argv: list[str], log_text: str = "") -> str:
    """The JAX script's ``main`` with ``argv``; its ``subprocess.call``
    writes ``log_text`` as the CLI's output and returns 0. Returns what it
    printed."""
    def fake_call(cmd, stdout=None, stderr=None, cwd=None, **kw):
        stdout.write(log_text)
        return 0

    monkeypatch.setattr(subprocess, "call", fake_call)
    monkeypatch.setattr(sys, "argv", ["run_flagship_512.py"] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        assert _jax_script().main() == 0
    return out.getvalue()


def _without(value, workdir: str):
    """``value`` with ``workdir`` in its strings replaced by a marker."""
    if isinstance(value, dict):
        return {k: _without(v, workdir) for k, v in value.items()}
    return value.replace(workdir, "<workdir>") if isinstance(value, str) else value


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """The port's script on the CPU (``CPU_RUN``): (rc, what it printed,
    the CLI log, the workdir). The checkpoints go with the module."""
    base = tmp_path_factory.mktemp("flagship")
    workdir = base / "work"
    argv = CPU_RUN + ["--root", str(base / "data"), "--workdir", str(workdir)]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, redirect_stdout(out):
        mp.setenv("OMP_NUM_THREADS", RUN_THREADS)
        rc = port.main(argv)
    log = (workdir / port.LOG_NAME).read_text()
    yield rc, out.getvalue(), log, workdir
    shutil.rmtree(base, ignore_errors=True)


@pytest.mark.parametrize("resume", [False, True], ids=["fresh", "resume"])
@pytest.mark.parametrize("rss", ["100", "0"])
@pytest.mark.parametrize("steps", ["10", "1"])
def test_derive_config_matches_jax(tmp_path, monkeypatch, steps, rss, resume):
    (tmp_path / "data").mkdir()
    argv = ["--iters", "300", "--img", "256", "--val_interval", "100",
            "--root", str(tmp_path / "data"), "--steps_per_call", steps, "--rss_limit_gb", rss]
    if resume:
        argv += ["--resume", str(tmp_path / "MIMOcom_airsim_latest.pkl")]
    jax_work, port_work = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_main(monkeypatch, argv + ["--workdir", jax_work])
    with open(os.path.join(jax_work, port.CONFIG_NAME)) as fp:
        want = yaml.safe_load(fp)
    got = port.derive_config(port.parse_args(argv + ["--workdir", port_work]))
    assert _without(got, port_work) == _without(want, jax_work)
    assert got["data"]["cache_decoded"] == os.path.join(port_work, "cache")
    assert ("steps_per_call" in got["training"]) == (steps == "10")
    assert ("rss_limit_gb" in got["training"]) == (rss == "100")
    assert (got["training"]["resume"] is not None) == resume  # the stock YAML holds null


def _report_lines(text: str) -> list[str]:
    """The lines ``report`` prints, but for the log's own path."""
    return [line for line in text.splitlines()
            if line.startswith(("sustained end-to-end", "val Overall mIoU",
                                "when2com selection accuracy trajectory", "full CLI log:"))]


@pytest.mark.parametrize("timed", [False, True], ids=["cli_log", "with_time_image"])
def test_report_matches_jax_on_the_same_log(cpu_run, tmp_path, monkeypatch, timed):
    _, _, log, _ = cpu_run
    if timed:  # readings in the trainer's format (trainer.py's print-interval line)
        lines = [f"Iter [{50 * (j + 1)}/300]  Loss: 1.0000  Time/Image: {t:.4f}"
                 for j, t in enumerate((0.9, 0.05, 0.0625, 0.04, 0.05))]
        log = "\n".join(lines) + "\n" + log
    (tmp_path / "data").mkdir()
    jax_out = _jax_main(monkeypatch, ["--root", str(tmp_path / "data"),
                                      "--workdir", str(tmp_path / "jax")], log)
    out = io.StringIO()
    with redirect_stdout(out):
        port.print_report(port.report(log), str(tmp_path / "jax" / "train_cli.log"))
    want, got = _report_lines(jax_out), _report_lines(out.getvalue())
    assert got == want
    assert any(line.startswith("val Overall mIoU") for line in got)
    assert any(line.startswith("sustained end-to-end") for line in got) == timed
    if timed:  # the median of the readings after the first: 6 / 0.05 frames/s
        assert port.report(log)["sustained"] == pytest.approx(6 / 0.05)


def test_cpu_run_trains_validates_and_tests(cpu_run):
    rc, out, log, workdir = cpu_run
    assert rc == 0, log[-3000:]
    r = port.report(log)
    # the JAX trajectories hold the two validations and the test eval's table
    assert len(r["overall"]) == len(r["when2com"]) == 3
    assert len(r["val_overall"]) == len(r["val_when2com"]) == 2
    assert len(r["val_normal"]) == len(r["val_noise"]) == 2
    assert None not in (r["test"]["normal"], r["test"]["noise"])
    assert r["overall"][:2] == r["val_overall"] and r["test"]["overall"] == r["overall"][2]
    assert r["test"]["bandwidth"] >= 0.0 and "Bandwidth: " in log
    assert [m[0] for m in r["memory"]] == [2, 4]
    assert all(m[1] > 0 and m[2] is None for m in r["memory"])  # the CPU: no device line
    runs = glob.glob(str(workdir / "runs" / "mrms_when2com_512_run" / "*"))
    assert len(runs) == 1
    for name in ("best_model", "latest"):
        assert os.path.isfile(os.path.join(runs[0], f"MIMOcom_airsim_{name}.pkl")), name
    assert os.path.isfile(workdir / port.CONFIG_NAME)
    assert os.listdir(workdir / "cache")  # data.cache_decoded
    for line in ("derived config: ", "train CLI exited rc=0", "val Overall mIoU trajectory",
                 "when2com selection accuracy trajectory", "post-train test: "):
        assert line in out, line


def test_relative_paths_reach_the_cli_whole(monkeypatch, tmp_path):
    """The CLI runs in ``--workdir``: relative ``--root``, ``--workdir``
    and ``--resume`` reach it, and its config, as absolute paths."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    calls = []

    def fake_call(cmd, stdout=None, stderr=None, cwd=None, env=None):
        calls.append((cmd, cwd))
        return 0

    monkeypatch.setattr(subprocess, "call", fake_call)
    with redirect_stdout(io.StringIO()):
        assert port.main(["--root", "data", "--workdir", "w", "--resume", "latest.pkl",
                          "--device", "cpu"]) == 0
    (cmd, cwd), = calls
    config = cmd[cmd.index("--config") + 1]
    assert cwd == str(tmp_path / "w") and config == str(tmp_path / "w" / port.CONFIG_NAME)
    with open(config) as fp:
        derived = yaml.safe_load(fp)
    assert derived["data"]["path"] == str(tmp_path / "data")
    assert derived["data"]["cache_decoded"] == str(tmp_path / "w" / "cache")
    assert derived["training"]["resume"] == str(tmp_path / "latest.pkl")


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(subprocess, "call", lambda *a, **kw: called.append(a) or 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--root", str(tmp_path / "data"), "--workdir", str(tmp_path / "w")])
    assert not called and not (tmp_path / "w").exists()
