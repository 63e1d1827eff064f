"""The port's ``test`` and ``train`` CLIs over ranks on the CPU
(``--device cpu``: gloo ranks spawned by the CLI, a ``file://`` rendezvous)
on a 64x64 AirSim fixture of 6 agents whose test split is 3 frames: at
batch 2 a full batch and a tail of 1 that does not divide over 2 ranks.

- ``test --data_parallel 2``, ``--agent_parallel 2`` (3 agents a rank) and
  both (2 rings of 2) print exactly the score tables and the bandwidth one
  process prints: the ranks' confusion matrices, bandwidth and selection
  counts combine exactly.
- ``train --data_parallel 2`` trains, validates, writes one run directory
  (rank 0's) with one best checkpoint, and evaluates the test split.
- No fallback: a rank without a card raises, NCCL on shared cards or the
  CPU raises, gloo with ``steps_per_call > 1`` on the card raises, more
  ranks than cards raise, and a failing rank fails the launch.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch
import yaml

from multiagentperception_tpu_torch import test as port_test
from multiagentperception_tpu_torch import train as port_train
from multiagentperception_tpu_torch.data.synthetic import generate_fixture
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.models import get_model, init_weights
from multiagentperception_tpu_torch.parallel import init_distributed, spawn
from multiagentperception_tpu_torch.parallel.mesh import pick_backend
from multiagentperception_tpu_torch.trainer import Trainer
from torch_parallel_helpers import ROOT, failing_rank, fake_layout, toy_cfg

IMG = 64
TIMEOUT_S = 120


def _cfg(root: str) -> dict:
    return {
        "model": {"arch": "MIMOcom", "agent_num": 6, "shared_img_encoder": "unified",
                  "query_size": 8, "key_size": 64, "multiple_output": True},
        "data": {"dataset": "airsim", "train_split": "train", "val_split": "val",
                 "test_split": "test", "img_rows": IMG, "img_cols": IMG, "path": root,
                 "target_view": "6agent", "commun_label": "mimo"},
        "training": {"train_iters": 2, "batch_size": 2, "val_interval": 2, "n_workers": 1,
                     "print_interval": 1, "watchdog_secs": 0,
                     "optimizer": {"name": "adam", "lr": 1e-4},
                     "loss": {"name": "cross_entropy", "size_average": True}},
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_cli")
    root = str(work / "data")
    generate_fixture(root, target_view="6agent", img_size=IMG, frames_per_traj=3)
    cfg = _cfg(root)
    yml = work / "cli.yml"
    yml.write_text(yaml.safe_dump(cfg))
    from multiagentperception_tpu_torch.config import normalize_config

    model = init_weights(get_model(normalize_config(cfg), 11), 0)
    # a sharper graph than the seeded init's: some links above the threshold
    with torch.no_grad():
        model.attention_net.linear.weight.mul_(8.0)
    torch.save({"model_state": model.state_dict()}, work / "model.pkl")
    yield work, yml
    shutil.rmtree(work)  # ~130 MB of weights


def _cli(module: str, *args: str, cwd) -> str:
    proc = subprocess.run([sys.executable, "-m", f"multiagentperception_tpu_torch.{module}",
                           *args, "--device", "cpu"], capture_output=True, text=True,
                          timeout=TIMEOUT_S, cwd=cwd,
                          env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _scores(out: str) -> list[str]:
    """The printed tables and bandwidth, without the ranks' set-up line."""
    return [line for line in out.splitlines() if not line.startswith("parallel:")]


@pytest.fixture(scope="module")
def one_process(files):
    work, yml = files
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_test.main(["--config", str(yml), "--model_path", str(work / "model.pkl"),
                        "--device", "cpu"])
    return buf.getvalue()


@pytest.mark.parametrize("ranks", [["--data_parallel", "2"], ["--agent_parallel", "2"],
                                   ["--agent_parallel", "2", "--data_parallel", "2"]],
                         ids=["data2", "agent2", "data2xagent2"])
def test_test_cli_over_ranks_prints_one_process_scores(files, one_process, ranks):
    work, yml = files
    out = _cli("test", "--config", str(yml), "--model_path", str(work / "model.pkl"), *ranks,
               cwd=work)
    assert "backend gloo" in out.splitlines()[0]
    assert "Bandwidth:" in one_process
    assert _scores(out) == _scores(one_process)


def test_train_cli_data_parallel(files, tmp_path):
    _, yml = files
    out = _cli("train", "--config", str(yml), "--data_parallel", "2", cwd=tmp_path)
    assert out.startswith("parallel: 2 rank(s), data 2 x agent 1, backend gloo")
    assert out.count("RUNDIR:") == 1
    runs = list((tmp_path / "runs" / "cli").iterdir())
    assert len(runs) == 1
    assert (runs[0] / "MIMOcom_airsim_best_model.pkl").is_file()
    assert out.count("Bandwidth:") == 1 and "Overall" in out
    shutil.rmtree(tmp_path / "runs")  # the checkpoints, ~130 MB each


# ------------------------------------------------------------------ no fallback

@pytest.mark.parametrize("device,local_world,cards,asked,want", [
    ("cuda", 2, 1, None, "gloo"), ("cuda", 1, 1, None, "nccl"), ("cuda", 4, 8, None, "nccl"),
    ("cpu", 2, 0, None, "gloo"), ("cuda", 2, 1, "nccl", RuntimeError),
    ("cpu", 1, 0, "nccl", RuntimeError)])
def test_backend_is_decided_from_the_layout(device, local_world, cards, asked, want):
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="NCCL takes one rank per card"):
            pick_backend(device, local_world, cards, asked)
    else:
        assert pick_backend(device, local_world, cards, asked)[0] == want


def test_a_rank_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="rank 0: no CUDA device"):
        init_distributed(rank=0, world=1, init_method=f"file://{tmp_path / 'r'}")


def test_more_ranks_than_cards_raise(monkeypatch, files):
    _, yml = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        port_train.main(["--config", str(yml), "--data_parallel", "2"])
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards, have 1"):
        spawn(failing_rank, 2)


def test_gloo_refuses_steps_per_call_on_the_card():
    cfg = toy_cfg(4)
    cfg["training"]["steps_per_call"] = 2
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device="cpu",
                      layout=fake_layout(agent=1, world=1))
    trainer.device = torch.device("cuda")  # the check runs before anything touches it
    with pytest.raises(RuntimeError, match="backend gloo"):
        trainer.train()


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank[01] of 2 failed"):
        spawn(failing_rank, 2, device="cpu", timeout_s=TIMEOUT_S)
