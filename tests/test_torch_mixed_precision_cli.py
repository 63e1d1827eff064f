"""The port's ``train`` and ``test`` CLIs on the CPU (``--device cpu``) with
mixed precision, at toy size on the synthetic AirSim fixture
(tests/test_torch_zoo_eval.py's ``toy_yaml``: 128x128, the YAML's own
agents, batch size and labels), as tests/test_torch_zoo_cli.py runs them
in float32: the flagship and one YAML of each other family with
``training.mixed_precision: true`` train two iterations, validate, write a
``.pkl`` of float32 tensors and evaluate the test split; the ``test`` CLI
then evaluates that ``.pkl`` with ``model.dtype: bfloat16``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import yaml

from multiagentperception_tpu_torch import test as port_test
from multiagentperception_tpu_torch import train as port_train
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.evaluate import Evaluator
from test_torch_train import drop_files, few_threads  # noqa: F401 (autouse fixtures)
from test_torch_zoo_eval import ROOT, fixture_roots, toy_yaml  # noqa: F401

YAMLS = [ROOT / "configs" / d / f for d, f in (
    ("multi-request-multi-support", "mrms_when2com.yml"),
    ("single-request-multiple-support", "srms_when2com.yml"),
    ("multi-request-multi-support", "mrms_randcom.yml"))]


@pytest.mark.parametrize("yml", YAMLS, ids=lambda p: p.stem)
def test_mixed_precision_train_and_test_cli(yml, fixture_roots, tmp_path, monkeypatch,  # noqa: F811
                                            capsys):
    path = toy_yaml(yml, fixture_roots, tmp_path, train_iters=2, val_interval=2,
                    print_interval=1, mixed_precision=True)
    monkeypatch.chdir(tmp_path)
    (result,) = port_train.main(["--config", path, "--device", "cpu"])
    out = capsys.readouterr().out
    cfg = load_config(path)
    arch = cfg["model"]["arch"]
    for line in ("Iter [2/2]", "Overall"):
        assert line in out, line
    assert ("Bandwidth:" in out) == (arch in ("MIMOcom", "LearnWhen2Com"))
    score, _ = result
    assert all(np.isfinite(v) for v in score.values())
    (pkl,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "runs") for f in fs
              if f == f"{arch}_airsim_best_model.pkl"]
    blob = torch.load(pkl, weights_only=True)
    floats = [v for v in blob["model_state"].values() if v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)
    ev = Evaluator(cfg, device="cpu")
    ev.load_weight(pkl)
    assert next(iter(ev.model.parameters())).dtype == torch.float32

    raw = yaml.safe_load(open(path))
    del raw["training"]["mixed_precision"]
    raw["model"]["dtype"] = "bfloat16"
    bf16_yml = tmp_path / f"{yml.stem}_bf16.yml"
    bf16_yml.write_text(yaml.safe_dump(raw))
    metrics = port_test.main(["--config", str(bf16_yml), "--model_path", pkl,
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Overall" in out.splitlines()
    assert int(metrics.confusion_matrix.sum()) > 0
    score, _ = metrics.get_scores()
    assert all(np.isfinite(v) for v in score.values())
    if arch in ("MIMOcom", "LearnWhen2Com"):
        assert "Bandwidth:" in out and 0.0 <= metrics.get_avg_bandW() <= cfg["model"][
            "agent_num"] - 1
