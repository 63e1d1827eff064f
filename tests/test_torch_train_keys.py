"""The training loop's keys in the port, on the CPU (the JAX package's tests
of each, mirrored: tests/test_device_prefetch.py, tests/test_trainer.py's
watchdog and rss_limit_gb classes, tests/test_cli.py's re-exec handshake,
tests/test_joint_ops.py's resumed twin):

- ``device_prefetch``: the same losses at depth 0 and 2 (order kept), no
  producer thread at depth 0, a loader error raised in the loop, a
  producer that never wedges on a consumer that left, and
  ``_shutdown_input_pipeline`` stopping it;
- the stall watchdog: one dump per stall, re-armed by ``beat``, the
  first-chunk grace, ``beat(expected_secs=...)``, and the loop's beats
  (none before the first chunk ends, each with the chunk's expected time);
- ``rss_limit_gb``: the crossing checkpoints ``latest`` and calls the
  re-exec hook at a chunk's end with the input pipeline stopped; a limit
  below the working RSS is disabled; the resumed run ends where an
  uninterrupted one ends, exactly; the train CLI started with the
  handshake's environment rejoins its run directory and continues;
  ``reexec_self`` execs the interpreter's own command line;
- ``profile_dir``: one Chrome trace holding the profiled chunks, and no
  other iteration, at K = 1 and K = 4;
- the TensorBoard writer's tags through the train CLI (where the
  ``tensorboard`` package imports);
- ``model.remat`` with ``steps_per_call``: the same parameters as without
  remat, exactly;
- every ported key at once through the train CLI.

The models are MIMOcom with 2 agents at 64x64, batch 1 (the CLI runs: the
fixture of tests/test_torch_train_cli.py, 6 agents at 128x128), trained by
SGD: a checkpoint of these 34M parameters is ~135 MB (Adam's state would
triple it), and each test's files go when it ends, as the test runner's
workers share one disk. Tests whose subject is not the checkpoint write
none.
"""

from __future__ import annotations

import glob
import itertools
import json
import logging
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

import multiagentperception_tpu_torch.trainer as trainer_mod
from multiagentperception_tpu_torch import train as port_train
from multiagentperception_tpu_torch import utils
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.models import init_weights
from multiagentperception_tpu_torch.trainer import Trainer, _StallWatchdog
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_train_cli import _cfg, _Repeat, _write, fixture_root  # noqa: F401

IMG = 64
SGD = {"name": "sgd", "lr": 1.0e-4}


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _batches(count: int, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((1, 2, IMG, IMG, 3)) * 0.5).astype(np.float32),
             rng.integers(0, 11, (1, 2, IMG, IMG)).astype(np.int32),
             np.stack([rng.integers(0, 2, (1, 2)), rng.integers(0, 2, (1, 2))], axis=1))
            for _ in range(count)]


def _trainer(logdir, loader=None, remat: bool = False, checkpoints: bool = False,
             **training) -> Trainer:
    raw = _cfg("unused", batch_size=1, watchdog_secs=0, **training)
    raw["training"]["optimizer"] = SGD
    raw["model"].update(agent_num=2, remat=remat)
    raw["data"]["img_rows"] = raw["data"]["img_cols"] = IMG
    cfg = normalize_config(raw)
    val = _batches(1, seed=9)
    trainer = Trainer(cfg, logging.getLogger("test"), get_loss_function(cfg),
                      loader if loader is not None else _Repeat(_batches(1)[0]), val,
                      device="cpu", logdir=str(logdir))
    init_weights(trainer.model, 0)
    if not checkpoints:
        trainer._save_ckpt = lambda name, i, best_iou: None
    return trainer


def _cli_cfg(root, **training) -> dict:
    cfg = _cfg(root, n_workers=0, **training)
    cfg["training"]["optimizer"] = SGD
    return cfg


def _losses(trainer) -> list:
    got = []
    base = trainer.loss_fn

    def recording(**kw):
        loss = base(**kw)
        if torch.is_grad_enabled():
            got.append(float(loss.detach()))
        return loss

    trainer.loss_fn = recording
    trainer.train()
    return got


# ------------------------------------------------------------------ device_prefetch

def test_prefetch_keeps_the_order(tmp_path):
    batches = _batches(4)
    runs = {}
    for depth in (0, 2):
        trainer = _trainer(tmp_path / str(depth), batches, train_iters=6, val_interval=100,
                           device_prefetch=depth)
        runs[depth] = _losses(trainer)
        assert (trainer._prefetch_thread is None) == (depth == 0)
    assert len(runs[0]) == 6 and runs[0] == runs[2]


class _Failing:
    def __iter__(self):
        yield from _batches(2)
        raise RuntimeError("loader died")


@pytest.mark.parametrize("depth", [0, 2])
def test_loader_error_is_raised_in_the_loop(tmp_path, depth):
    trainer = _trainer(tmp_path, _Failing(), train_iters=6, val_interval=100,
                       device_prefetch=depth)
    with pytest.raises(RuntimeError, match="loader died"):
        trainer.train()
    assert trainer.step == 2


def test_producer_error_does_not_wedge_when_consumer_left():
    trainer = Trainer.__new__(Trainer)  # _prefetched needs no trainer state
    release = threading.Event()

    def gen():
        yield 1
        yield 2
        release.wait(5.0)  # let the consumer fill the queue and leave
        raise RuntimeError("loader died")

    stream = trainer._prefetched(gen(), depth=1)
    assert next(stream) == 1
    stream.close()  # consumer gone; the queue still holds item 2
    release.set()
    trainer._prefetch_thread.join(timeout=5.0)
    assert not trainer._prefetch_thread.is_alive(), "producer wedged on the error's put"


def test_shutdown_input_pipeline_stops_producer():
    class FakeLoader:
        shutdown_called = False

        def shutdown(self):
            self.shutdown_called = True

    trainer = Trainer.__new__(Trainer)
    trainer._prefetch_stop = trainer._prefetch_thread = None
    trainer.trainloader = FakeLoader()
    stream = trainer._prefetched(itertools.count(), depth=2)
    assert next(stream) == 0
    trainer._shutdown_input_pipeline()
    assert trainer.trainloader.shutdown_called
    assert not trainer._prefetch_thread.is_alive()


# ------------------------------------------------------------------ the watchdog

class _Rec:
    def __init__(self):
        self.msgs = []

    def warning(self, msg, *args):
        self.msgs.append(msg % args)


def test_watchdog_dumps_once_per_stall_and_rearms_on_beat(capfd):
    log = _Rec()
    wd = _StallWatchdog(0.3, log)
    try:
        time.sleep(1.0)  # before the first beat: FIRST_GRACE (6x)
        assert log.msgs == [], log.msgs
        wd.beat()
        time.sleep(1.0)
        assert len(log.msgs) == 1, log.msgs  # once per stall, not per tick
        assert "no training progress" in log.msgs[0]
        wd.beat()
        time.sleep(1.0)
        assert len(log.msgs) == 2
    finally:
        wd.stop()
    err = capfd.readouterr().err
    assert "Current thread" in err or "Thread 0x" in err


def test_watchdog_expected_secs_raises_the_threshold():
    log = _Rec()
    wd = _StallWatchdog(0.2, log)
    try:
        wd.beat(expected_secs=1.0)  # threshold max(0.2, 3.0) = 3 s
        time.sleep(1.0)
        assert log.msgs == [], log.msgs
        wd.beat()  # a plain beat: the base threshold again
        time.sleep(0.8)
        assert len(log.msgs) == 1, log.msgs
    finally:
        wd.stop()


@pytest.mark.parametrize("k,iters,beats", [(1, 3, 2), (2, 4, 1)])
def test_loop_beats_after_the_first_chunk(tmp_path, monkeypatch, k, iters, beats):
    seen = []

    class FakeWd:
        def __init__(self, timeout_s, logger):
            seen.append(("timeout", timeout_s))

        def beat(self, expected_secs=None):
            seen.append(("beat", expected_secs))

        def stop(self):
            seen.append(("stop", None))

    monkeypatch.setattr(trainer_mod, "_StallWatchdog", FakeWd)
    trainer = _trainer(tmp_path, train_iters=iters, val_interval=100, steps_per_call=k)
    trainer.cfg["training"]["watchdog_secs"] = 60
    trainer.train()
    assert seen[0] == ("timeout", 60.0) and seen[-1] == ("stop", None)
    expected = [e for kind, e in seen if kind == "beat"]
    assert len(expected) == beats and all(e is not None and e > 0 for e in expected)
    assert expected[0] == pytest.approx(k * trainer.iter_seconds[0])


def test_watchdog_zero_disables(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "_StallWatchdog",
                        lambda *a: pytest.fail("watchdog started with watchdog_secs 0"))
    _trainer(tmp_path, train_iters=1, val_interval=100).train()


# ------------------------------------------------------------------ rss_limit_gb

def _fake_rss(values):
    it, last = iter(values), [values[-1]]

    def fake():
        last[0] = next(it, last[0])
        return last[0]

    return fake


def test_rss_trigger_checkpoints_and_calls_reexec(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "host_rss_gb", _fake_rss([0.5, 2.0]))
    trainer = _trainer(tmp_path, train_iters=8, val_interval=100, steps_per_call=2,
                       rss_limit_gb=1.0, checkpoints=True)
    calls = []
    trainer._reexec_fn = calls.append
    trainer.train()
    (ckpt,) = calls
    assert ckpt.endswith("_latest.pkl") and os.path.exists(ckpt)
    assert trainer.step == 4  # the second check, at the second chunk's end
    assert torch.load(ckpt, weights_only=True)["epoch"] == 4
    assert not trainer._prefetch_thread.is_alive()


def test_rss_limit_below_working_set_disables(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "host_rss_gb", _fake_rss([2.0]))
    trainer = _trainer(tmp_path, train_iters=3, val_interval=100, rss_limit_gb=1.0)
    calls = []
    trainer._reexec_fn = calls.append
    trainer.train()
    assert calls == [] and trainer.step == 3


def test_resumed_run_equals_the_uninterrupted_one(tmp_path, monkeypatch):
    keys = dict(train_iters=8, val_interval=100, steps_per_call=2, rss_limit_gb=1.0)
    monkeypatch.setattr(trainer_mod, "host_rss_gb", _fake_rss([0.5]))
    whole = _trainer(tmp_path / "whole", **keys)
    whole.train()
    assert whole.step == 8

    monkeypatch.setattr(trainer_mod, "host_rss_gb", _fake_rss([0.5, 2.0]))
    cut = _trainer(tmp_path / "cut", checkpoints=True, **keys)
    calls = []
    cut._reexec_fn = calls.append
    cut.train()
    assert cut.step == 4 and len(calls) == 1

    monkeypatch.setattr(trainer_mod, "host_rss_gb", _fake_rss([0.5]))
    resumed = _trainer(tmp_path / "cut", resume=calls[0], **keys)
    resumed.train()
    assert resumed.step == 8 and len(resumed.iter_seconds) == 4
    for name, value in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name


def test_reexec_self_execs_the_same_command(monkeypatch):
    calls = []
    monkeypatch.setattr(os, "execv", lambda exe, argv: calls.append((exe, argv)))
    monkeypatch.delenv("MAP_REEXEC_RESUME", raising=False)
    utils.reexec_self("ck.pkl")
    assert os.environ.pop("MAP_REEXEC_RESUME") == "ck.pkl"
    assert calls == [(sys.executable, [sys.executable] + sys.orig_argv[1:])]
    assert 0.0 < utils.host_rss_gb() < 1024.0


def test_cli_rejoins_its_run_after_a_reexec(fixture_root, tmp_path, monkeypatch, capsys):
    for key in ("MAP_REEXEC_RESUME", "MAP_REEXEC_LOGDIR", "MAP_REEXEC_RUN_IDX"):
        monkeypatch.setenv(key, "")  # restored after the test; the CLI sets them
        monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    cfg = _cli_cfg(fixture_root, train_iters=2, val_interval=100, save_interval=1)
    yml = _write(tmp_path / "rss.yml", cfg)
    port_train.main(["--config", yml, "--device", "cpu"])
    out = capsys.readouterr().out
    logdir = out.split("RUNDIR: ")[1].splitlines()[0].strip()
    latest = os.path.join(str(tmp_path), logdir, "MIMOcom_airsim_latest.pkl")
    assert os.path.exists(latest)

    cfg["training"]["train_iters"] = 4  # the same command line after the exec
    _write(tmp_path / "rss.yml", cfg)
    monkeypatch.setenv("MAP_REEXEC_RESUME", latest)
    monkeypatch.setenv("MAP_REEXEC_LOGDIR", logdir)
    monkeypatch.setenv("MAP_REEXEC_RUN_IDX", "0")
    port_train.main(["--config", yml, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"RUNDIR: {logdir}" in out and "Loaded checkpoint" in out
    assert "Iter [4/4]" in out and "Iter [1/4]" not in out and "Iter [3/4]" not in out
    assert "MAP_REEXEC_RESUME" not in os.environ
    assert len(glob.glob(str(tmp_path / "runs" / "rss" / "*"))) == 1


# ------------------------------------------------------------------ profile_dir

@pytest.mark.parametrize("k,iters,traced", [
    (1, 16, [f"train_iters {n}-{n}" for n in range(10, 16)]),
    (4, 20, ["train_iters 9-12", "train_iters 13-16"])])
def test_profile_dir_traces_the_range(tmp_path, k, iters, traced):
    prof = tmp_path / "prof"
    trainer = _trainer(tmp_path, train_iters=iters, val_interval=100, steps_per_call=k,
                       profile_dir=str(prof), print_interval=100)
    trainer.train()
    (trace,) = os.listdir(prof)
    assert trace == "train_iters_10-15.pt.trace.json"
    events = json.load(open(prof / trace))["traceEvents"]
    names = sorted({e["name"] for e in events if e.get("name", "").startswith("train_iters ")},
                   key=lambda s: int(s.split()[1].split("-")[0]))
    assert names == traced
    assert any(e.get("name", "").startswith("aten::convolution") for e in events)


# ------------------------------------------------------------------ the writer

def test_writer_tags_through_the_cli(fixture_root, tmp_path, monkeypatch, capsys):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.chdir(tmp_path)
    yml = _write(tmp_path / "tb.yml", _cli_cfg(fixture_root))
    port_train.main(["--config", yml, "--device", "cpu"])
    logdir = capsys.readouterr().out.split("RUNDIR: ")[1].splitlines()[0].strip()
    acc = EventAccumulator(str(tmp_path / logdir))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    want = {"loss/train_loss", "lr", "loss/val_loss", "val_metrics/Mean IoU :",
            "val_metrics/Overall Acc:", "val_metrics/cls_0", "val_metrics/cls_10",
            "val_metrics/when_com_accuacy", "val_metrics/who_com_accuracy"}
    assert want <= tags, want - tags
    assert [e.step for e in acc.Scalars("loss/train_loss")] == [2, 3, 4, 5]
    assert [e.step for e in acc.Scalars("loss/val_loss")] == [2, 4]
    assert all(e.value == pytest.approx(1e-4) for e in acc.Scalars("lr"))


# ------------------------------------------------------------------ remat, and all the keys

def test_remat_with_steps_per_call_equals_no_remat(tmp_path):
    runs = {}
    for remat in (False, True):
        trainer = _trainer(tmp_path / str(remat), _batches(3), remat=remat, train_iters=4,
                           val_interval=100, steps_per_call=2)
        runs[remat] = (_losses(trainer), trainer.model.state_dict())
    assert runs[True][0] == runs[False][0]
    for name, value in runs[False][1].items():
        assert torch.equal(runs[True][1][name], value), name


def test_every_ported_key_through_the_cli(fixture_root, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = _cli_cfg(fixture_root, steps_per_call=3, device_prefetch=1, nan_guard=2,
               profile_dir=str(tmp_path / "prof"), profile_range=[1, 3], watchdog_secs=60,
               rss_limit_gb=1e6, save_interval=2)
    port_train.main(["--config", _write(tmp_path / "keys.yml", cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Iter [4/4]" in out and "Bandwidth:" in out
    assert os.listdir(tmp_path / "prof") == ["train_iters_1-3.pt.trace.json"]
    (latest,) = glob.glob(str(tmp_path / "runs" / "keys" / "*" / "*_latest.pkl"))
    blob = torch.load(latest, weights_only=True)
    assert blob["epoch"] == 4 and blob["nan_guard"]["applied"] == 4
