"""The port's training loop and ``train`` CLI on the CPU, on the synthetic
AirSim fixture (128x128, 6 agents):

- ``python -m multiagentperception_tpu_torch.train --device cpu`` trains 4
  iterations, validates every 2 and writes the best ``.pkl``; the JAX
  ``Trainer.load_weight`` loads that file (compat.load_reference_checkpoint)
  and its softmax-mode forward equals the port's within the tolerances of
  tests/test_torch_model.py (``pred`` rtol 1e-3 / atol 2e-3 and actions
  exact in float32, the graph 1e-5 in float64 in both frameworks);
- a run resumed from a 'latest' ``.pkl`` continues at the saved iteration
  and ends where an uninterrupted run ends;
- ``model.remat: true`` trains through the CLI, and its checkpoint equals
  that of the same run without remat (the recompute is bit-identical on
  the CPU, tests/test_torch_remat.py);
- the keys the port does not carry yet are refused, naming the key
  (``shard_data_by_process`` alone since the loader's port).
"""

from __future__ import annotations

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multiagentperception_tpu.config import load_config as jax_load_config
from multiagentperception_tpu.data.synthetic import generate_fixture
from multiagentperception_tpu.loss import get_loss_function as jax_get_loss
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.optimizers import get_optimizer as jax_get_optimizer
from multiagentperception_tpu.trainer import get_trainer
from multiagentperception_tpu_torch import train as port_train
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.models import init_weights
from multiagentperception_tpu_torch.trainer import UNPORTED, Trainer, refuse_unported
from test_torch_train import drop_files, few_threads  # noqa: F401 (autouse fixtures)
from test_torch_train_parts import _jax_float64

IMG = 128


def _cfg(root: str, **training) -> dict:
    return {
        "model": {"arch": "MIMOcom", "agent_num": 6, "shared_img_encoder": "unified",
                  "attention": "general", "sparse": False, "query": True,
                  "query_size": 8, "key_size": 64, "enc_backbone": "resnet_encoder",
                  "dec_backbone": "simple_decoder", "feat_squeezer": -1,
                  "feat_channel": 512, "multiple_output": True},
        "data": {"dataset": "airsim", "train_split": "train", "val_split": "val",
                 "test_split": "test", "img_rows": IMG, "img_cols": IMG, "path": root,
                 "target_view": "6agent", "commun_label": "mimo"},
        "training": {"train_iters": 4, "batch_size": 2, "val_interval": 2,
                     "n_workers": 2, "print_interval": 1,
                     "optimizer": {"name": "adam", "lr": 1.0e-4},
                     "loss": {"name": "cross_entropy", "size_average": True}, **training},
    }


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train") / "data")
    generate_fixture(root, target_view="6agent", img_size=IMG, frames_per_traj=2)
    return root


def _write(path, cfg) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_cli_checkpoint_predicts_the_same_in_jax(fixture_root, tmp_path, monkeypatch, capsys):
    yml = _write(tmp_path / "smoke.yml", _cfg(fixture_root))
    monkeypatch.chdir(tmp_path)
    port_train.main(["--config", yml, "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("Iter [4/4]", "Validation when2com accuracy:", "Bandwidth:", "Overall"):
        assert line in out
    (pkl,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "runs") for f in fs
              if f == "MIMOcom_airsim_best_model.pkl"]
    blob = torch.load(pkl, weights_only=True)
    assert set(blob) == {"epoch", "model_state", "optimizer_state", "best_iou"}
    assert blob["epoch"] in (2, 4)

    cfg = jax_load_config(yml)
    jtrainer = get_trainer(cfg)(cfg, None, logging.getLogger("test"), jax_get_model(cfg, 11),
                                jax_get_loss(cfg), None, None, jax_get_optimizer(cfg))
    x = (np.random.default_rng(0).standard_normal((2, 6, IMG, IMG, 3)) * 0.5).astype(np.float32)
    jtrainer.state = jtrainer._abstract_state(x)  # shapes only: load_weight fills it
    jtrainer.load_weight(pkl)
    variables = {"params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats}
    j_pred, j_prob, j_act, _ = jax.jit(functools.partial(
        jtrainer.model.apply, train=False, mo_flag=True, inference="softmax"))(
        variables, jnp.asarray(x))

    ev = Evaluator(load_config(yml), device="cpu")
    ev.load_weight(pkl)
    with torch.inference_mode():
        t_pred, t_prob, t_act, _ = ev.model(torch.from_numpy(x), inference="softmax")
    np.testing.assert_allclose(t_pred.permute(0, 2, 3, 1).numpy(), np.asarray(j_pred),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(jax.device_get(j_act)))
    # the graph in float64 in both frameworks, the whole batch: on this
    # checkpoint each framework's float32 graph lies ~1.1e-5 from its
    # float64 one (in opposite directions), more than the bound, while the
    # weights mean the same in both (float64 graphs 2e-14 apart)
    x64 = x.astype(np.float64)
    with _jax_float64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_prob64 = jtrainer.model.apply(v64, jnp.asarray(x64), train=False, mo_flag=True,
                                        inference="softmax")[1]
    with torch.inference_mode():
        t_prob64 = ev.model.double()(torch.from_numpy(x64), inference="softmax")[1]
    np.testing.assert_allclose(t_prob64.numpy(), np.asarray(j_prob64), rtol=0, atol=1e-5)


class _Repeat:
    """The same batch forever: two runs see the same data whatever their
    start."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch


def _trainer(logdir, **training):
    """A small MIMOcom (2 agents, 128x128, batch 1) on one repeated batch."""
    raw = _cfg("unused", batch_size=1, **training)
    raw["model"]["agent_num"] = 2
    cfg = load_config(_write(os.path.join(logdir, "cfg.yml"), raw))
    rng = np.random.default_rng(1)
    batch = ((rng.standard_normal((1, 2, IMG, IMG, 3)) * 0.5).astype(np.float32),
             rng.integers(0, 11, (1, 2, IMG, IMG)).astype(np.int32),
             np.stack([rng.integers(0, 2, (1, 2)), rng.integers(0, 2, (1, 2))], axis=1))
    trainer = Trainer(cfg, None, get_loss_function(cfg), _Repeat(batch), [batch],
                      device="cpu", logdir=str(logdir))
    init_weights(trainer.model, 0)
    return trainer


def test_resume_continues_at_the_saved_iteration(tmp_path):
    """Two Adam steps in one run end where one step, a 'latest' save and a
    resumed step end: model, optimizer state and iteration come back."""
    whole = _trainer(tmp_path, train_iters=2, val_interval=100)
    whole.train()
    assert whole.step == 2

    first = _trainer(tmp_path, train_iters=1, save_interval=1, val_interval=100)
    first.train()
    latest = os.path.join(str(tmp_path), "MIMOcom_airsim_latest.pkl")
    assert torch.load(latest, weights_only=True)["epoch"] == 1

    resumed = _trainer(tmp_path, train_iters=2, resume=latest, val_interval=100)
    resumed.train()
    assert resumed.step == 2 and len(resumed.iter_seconds) == 1
    for (name, a), b in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("section,key,value",
                         [(s, k, v) for s, k, v in (
                             ("training", "data_backend", "grain"),
                             ("training", "augmentations", {"hflip": 0.5}),
                             ("training", "shard_data_by_process", True),
                             ("data", "cache_decoded", "cache"))],
                         ids=lambda v: str(v))
def test_unported_keys_are_refused(fixture_root, tmp_path, section, key, value):
    """No key of the JAX loop is refused any more: the loader's keys since
    the loader was ported, ``shard_data_by_process`` since data parallel
    was (one process reads the whole stream, as JAX's single process;
    tests/test_torch_parallel_train.py runs it over ranks)."""
    cfg = _cfg(fixture_root)
    cfg[section][key] = value
    assert UNPORTED == ()
    refuse_unported(load_config(_write(tmp_path / "x.yml", cfg)))


def _cli_checkpoint(tmp_path, monkeypatch, name: str, cfg: dict) -> dict:
    run_dir = tmp_path / name
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    port_train.main(["--config", _write(run_dir / "cfg.yml", cfg), "--device", "cpu"])
    (pkl,) = [os.path.join(d, f) for d, _, fs in os.walk(run_dir / "runs") for f in fs
              if f == "MIMOcom_airsim_best_model.pkl"]
    return torch.load(pkl, weights_only=True)


def test_remat_trains_through_the_cli(fixture_root, tmp_path, monkeypatch, capsys):
    """``model.remat: true`` (formerly refused): 2 iterations through the
    ``train`` CLI, whose best checkpoint equals the run's without remat."""
    runs = {}
    for remat in (False, True):
        cfg = _cfg(fixture_root, train_iters=2, n_workers=0)
        cfg["model"]["remat"] = remat
        runs[remat] = _cli_checkpoint(tmp_path, monkeypatch, f"remat{int(remat)}", cfg)
        assert "Iter [2/2]" in capsys.readouterr().out
    assert runs[True]["epoch"] == runs[False]["epoch"] == 2
    for name, value in runs[False]["model_state"].items():
        assert torch.equal(runs[True]["model_state"][name], value), name
