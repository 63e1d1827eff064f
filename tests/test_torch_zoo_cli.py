"""The port's ``train`` CLI on the CPU (``--device cpu``) for each of the
nine reference YAMLs that MIMOcom's (tests/test_torch_train_cli.py) leaves,
at toy size on the synthetic AirSim fixture (tests/test_torch_zoo_eval.py's
``toy_yaml``: 128x128, the YAML's own agents, batch size and labels): two
iterations, a validation, a reference-format ``<arch>_airsim_best_model.pkl``,
and the test split evaluated from it in the architecture's eval mode. The
``test`` CLI runs on every one of these YAMLs in tests/test_torch_zoo_eval.py.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from multiagentperception_tpu_torch import train as port_train
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.evaluate import Evaluator
from test_torch_train import drop_files, few_threads  # noqa: F401 (autouse fixtures)
from test_torch_zoo_eval import ZOO_YAMLS, fixture_roots, toy_yaml  # noqa: F401


@pytest.mark.parametrize("yml", ZOO_YAMLS, ids=lambda p: p.stem)
def test_train_cli_runs(yml, fixture_roots, tmp_path, monkeypatch, capsys):  # noqa: F811
    path = toy_yaml(yml, fixture_roots, tmp_path, train_iters=2, val_interval=2,
                    print_interval=1)
    monkeypatch.chdir(tmp_path)
    (result,) = port_train.main(["--config", path, "--device", "cpu"])
    out = capsys.readouterr().out
    cfg = load_config(path)
    arch = cfg["model"]["arch"]
    for line in ("Iter [2/2]", "Overall"):
        assert line in out, line
    assert ("Bandwidth:" in out) == (arch in ("MIMOcomWho", "LearnWhen2Com"))
    if cfg["data"]["commun_label"] != "None":
        assert "Validation when2com accuracy:" in out and "Noise" in out.splitlines()
    score, _ = result
    assert all(np.isfinite(v) for v in score.values())
    (pkl,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "runs") for f in fs
              if f == f"{arch}_airsim_best_model.pkl"]
    blob = torch.load(pkl, weights_only=True)
    assert blob["epoch"] == 2
    Evaluator(cfg, device="cpu").model.load_state_dict(blob["model_state"], strict=True)


def test_selection_draws_follow_the_seed():
    """The selection baselines' partners come from the run's seed alone:
    two evaluators with one seed draw alike (on any device: the generator
    is the CPU's), each draw advances the stream, and each evaluation pass
    restarts the eval stream."""
    cfg = load_config(str(next(p for p in ZOO_YAMLS if p.stem == "mrms_randcom")))
    a, b = Evaluator(cfg, device="cpu", seed=3), Evaluator(cfg, device="cpu", seed=3)
    first = [a.draw_ids("eval") for _ in range(3)]
    assert all(torch.equal(x, b.draw_ids("eval")) for x in first)
    assert first[0].shape == (6,) and int(first[0].max()) < 6
    assert not all(torch.equal(x, first[0]) for x in first[1:])
    list(a._pipelined([]))
    assert torch.equal(a.draw_ids("eval"), first[0])


def test_all_agents_draws_one_supporter_per_step():
    cfg = load_config(str(next(p for p in ZOO_YAMLS if p.stem == "srms_randcom")))
    ev = Evaluator(cfg, device="cpu", seed=0)
    ids = torch.stack([ev.draw_ids("train") for _ in range(20)])
    assert ids.shape == (20,) and set(ids.tolist()) <= set(range(5))
    assert len(set(ids.tolist())) > 1
