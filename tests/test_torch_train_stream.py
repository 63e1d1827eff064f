"""The trainer's checkpointable data stream and the CLIs' data keys, on the
CPU:

- a run cut at iteration 4 (mid-epoch: 3 batches an epoch) and resumed in a
  fresh ``Trainer`` over a fresh ``GrainLoader`` sees the batches an
  uninterrupted run sees, after augmentations, gaussian noise and the
  decoded-frame cache (fingerprints of the labels the loss gets), and ends
  with its parameters, with ``device_prefetch`` 0 and 2 and with
  ``steps_per_call`` 2; the checkpoint holds the consumed position, not the
  prefetcher's; the ``rss_limit_gb`` re-exec continues the same way;
- a ``.pkl`` without the stream's key starts the stream at its beginning;
- ``shard_data_by_process`` is still refused, naming the key;
- the ``train`` CLI with every new key (``data_backend: grain`` with 2
  worker processes, augmentations, ``cache_decoded``, ``noisy_type``) next to
  prefetch and ``steps_per_call``;
- the ``test`` CLI with ``noisy_type: occlusion`` and the cache on shared
  weights against JAX's ``Trainer.evaluate`` on JAX's noisy dataset:
  selection counts equal, bandwidth within the float32 rounding of its one
  division, confusion matrices within 0.1% of the pixels.

The trained model is ``Single_agent`` at 32x32 (batch 2, SGD), the CLIs'
MIMOcom runs at 64x64 (train) and 128x128 (test, tests/test_torch_eval.py's
fixture).
"""

from __future__ import annotations

import glob
import logging
import os
import zlib

import numpy as np
import pytest
import torch
import yaml

import multiagentperception_tpu_torch.trainer as trainer_mod
from multiagentperception_tpu.config import load_config as jax_load_config
from multiagentperception_tpu.data import AirsimDataset as JaxDataset
from multiagentperception_tpu.data import DataLoader as JaxDataLoader
from multiagentperception_tpu.data.synthetic import generate_fixture
from multiagentperception_tpu.loss import get_loss_function as jax_get_loss
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.optimizers import get_optimizer as jax_get_optimizer
from multiagentperception_tpu.trainer import get_trainer
from multiagentperception_tpu_torch import test as port_test
from multiagentperception_tpu_torch import train as port_train
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.data import AirsimDataset, get_composed_augmentations
from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.models import init_weights
from multiagentperception_tpu_torch.trainer import Trainer, refuse_unported
from test_torch_eval import IMG as EVAL_IMG
from test_torch_eval import fixture  # noqa: F401 (the shared-weights fixture)
from test_torch_train import drop_files, few_threads  # noqa: F401 (autouse fixtures)

IMG = 32
SEED = 5
TOTAL, CUT = 7, 4
AUGS = {"hflip": 0.5, "rcrop": 28, "brightness": 0.3}


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_stream") / "data")
    generate_fixture(root, target_view="6agent", img_size=IMG, frames_per_traj=3)
    return root


def _cfg(root: str, **training) -> dict:
    return normalize_config({
        "model": {"arch": "Single_agent", "agent_num": 6, "multiple_output": True},
        "data": {"dataset": "airsim", "img_rows": IMG, "img_cols": IMG, "path": root,
                 "target_view": "6agent", "commun_label": "None"},
        "training": {"batch_size": 2, "val_interval": 100, "print_interval": 100,
                     "watchdog_secs": 0, "save_interval": CUT,
                     "optimizer": {"name": "sgd", "lr": 1.0e-3},
                     "loss": {"name": "cross_entropy", "size_average": True}, **training},
    })


def _trainer(root: str, logdir, cache: str, **training) -> tuple[Trainer, list]:
    """A Trainer over a fresh shuffled GrainLoader (augmentations, gaussian
    noise, the cache) and the crc32 of each batch's labels its loss gets."""
    cfg = _cfg(root, **training)
    common = dict(root=root, img_size=(IMG, IMG), target_view="6agent", seed=SEED,
                  noisy_type="gaussian", cache_decoded=cache)
    train = GrainLoader(AirsimDataset(split="train", augmentations=get_composed_augmentations(
        AUGS), **common), 2, shuffle=True, drop_last=True, seed=SEED)
    val = GrainLoader(AirsimDataset(split="val", **common), 2)
    seen, base = [], get_loss_function(cfg)

    def recording(**kw):
        if torch.is_grad_enabled():
            seen.append(zlib.crc32(kw["target"].numpy().tobytes()))
        return base(**kw)

    trainer = Trainer(cfg, logging.getLogger("test"), recording, train, val, device="cpu",
                      logdir=str(logdir))
    init_weights(trainer.model, 0)
    return trainer, seen


@pytest.fixture(scope="module")
def uninterrupted(fixture_root, tmp_path_factory):
    """The whole run: its label fingerprints, final parameters and stream."""
    work = tmp_path_factory.mktemp("whole")
    trainer, seen = _trainer(fixture_root, work / "run", str(work / "cache"),
                             train_iters=TOTAL, device_prefetch=0)
    trainer.train()
    assert trainer.step == TOTAL and len(seen) == TOTAL
    assert len(set(seen[:3])) == 3  # three distinct batches an epoch
    return seen, {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _assert_same_run(trainer, seen, uninterrupted) -> None:
    want_seen, want_state = uninterrupted
    assert seen == want_seen
    for name, value in want_state.items():
        assert torch.equal(trainer.model.state_dict()[name], value), name


@pytest.mark.parametrize("prefetch,k", [(0, 1), (2, 1), (2, 2)],
                         ids=["sync", "prefetch2", "prefetch2_steps_per_call2"])
def test_resume_mid_epoch_equals_the_uninterrupted_run(fixture_root, tmp_path,
                                                       uninterrupted, prefetch, k):
    keys = dict(device_prefetch=prefetch, steps_per_call=k)
    cut, seen = _trainer(fixture_root, tmp_path / "run", str(tmp_path / "cache"),
                         train_iters=CUT, **keys)
    cut.train()
    (latest,) = glob.glob(str(tmp_path / "run" / "*_latest.pkl"))
    blob = torch.load(latest, weights_only=True)
    # after 4 batches of 3 an epoch: the second epoch's first, whatever the
    # prefetcher had pulled ahead
    assert blob["epoch"] == CUT and blob["data_stream"] == {"seed": SEED, "epoch": 1,
                                                           "consumed": 1}
    resumed, seen_after = _trainer(fixture_root, tmp_path / "run", str(tmp_path / "cache"),
                                   train_iters=TOTAL, resume=latest, **keys)
    resumed.train()
    assert resumed.step == TOTAL and len(seen_after) == TOTAL - CUT
    _assert_same_run(resumed, seen + seen_after, uninterrupted)


def test_rss_reexec_continues_mid_epoch(fixture_root, tmp_path, uninterrupted, monkeypatch):
    rss = iter([0.5, 2.0])
    monkeypatch.setattr(trainer_mod, "host_rss_gb", lambda: next(rss, 2.0))
    cut, seen = _trainer(fixture_root, tmp_path / "run", str(tmp_path / "cache"),
                         train_iters=TOTAL, rss_limit_gb=1.0, save_interval=None)
    calls = []
    cut._reexec_fn = calls.append
    cut.train()
    (latest,) = calls
    assert cut.step == 2 and torch.load(latest, weights_only=True)["data_stream"] == \
        {"seed": SEED, "epoch": 0, "consumed": 2}
    monkeypatch.setattr(trainer_mod, "host_rss_gb", lambda: 0.5)
    resumed, seen_after = _trainer(fixture_root, tmp_path / "run", str(tmp_path / "cache"),
                                   train_iters=TOTAL, resume=latest, save_interval=None)
    resumed.train()
    _assert_same_run(resumed, seen + seen_after, uninterrupted)


def test_a_pkl_without_the_stream_starts_it_fresh(fixture_root, tmp_path, uninterrupted):
    cut, _ = _trainer(fixture_root, tmp_path / "run", str(tmp_path / "cache"),
                      train_iters=CUT)
    cut.train()
    (latest,) = glob.glob(str(tmp_path / "run" / "*_latest.pkl"))
    blob = torch.load(latest, weights_only=True)
    del blob["data_stream"]  # as compat.save_reference_checkpoint writes it
    torch.save(blob, latest)
    resumed, seen_after = _trainer(fixture_root, tmp_path / "run", str(tmp_path / "cache"),
                                   train_iters=CUT + 2, resume=latest)
    resumed.train()
    assert resumed.step == CUT + 2
    assert seen_after == uninterrupted[0][:2]  # the stream's first two batches


def test_shard_data_by_process_is_still_refused(fixture_root):
    """No longer refused: data parallel is ported (its stream over ranks is
    tests/test_torch_parallel_train.py's)."""
    refuse_unported(_cfg(fixture_root, shard_data_by_process=True))
    refuse_unported(_cfg(fixture_root, data_backend="grain", grain_workers=2,
                         augmentations=AUGS))


def _mimocom(root: str, img: int, **data) -> dict:
    return {
        "model": {"arch": "MIMOcom", "agent_num": 6, "query_size": 8, "key_size": 64,
                  "multiple_output": True},
        "data": {"dataset": "airsim", "train_split": "train", "val_split": "val",
                 "test_split": "test", "img_rows": img, "img_cols": img, "path": root,
                 "target_view": "6agent", "commun_label": "mimo", **data},
        "training": {"train_iters": 4, "batch_size": 2, "val_interval": 2, "n_workers": 0,
                     "print_interval": 1, "optimizer": {"name": "sgd", "lr": 1.0e-4},
                     "loss": {"name": "cross_entropy", "size_average": True}},
    }


def test_train_cli_runs_every_data_key(tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "data")
    generate_fixture(root, target_view="6agent", img_size=64, frames_per_traj=2)
    cache = tmp_path / "cache"
    cfg = _mimocom(root, 64, noisy_type="occlusion", cache_decoded=str(cache),
                   on_device_normalize=True)
    cfg["training"].update(data_backend="grain", grain_workers=2, device_prefetch=2,
                           steps_per_call=2, save_interval=2, seed=SEED,
                           augmentations={"hflip": 0.5, "vflip": 0.5, "rotate": 5,
                                          "brightness": 0.2})
    monkeypatch.chdir(tmp_path)
    with open(tmp_path / "keys.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    try:
        port_train.main(["--config", str(tmp_path / "keys.yml"), "--device", "cpu"])
        out = capsys.readouterr().out
        assert "Iter [4/4]" in out and "Bandwidth:" in out
        cached = sorted(p.name.split("_")[0] for p in cache.iterdir())
        assert cached == ["test"] * 2 + ["train"] * 4 + ["val"] * 2  # every split's frames
        (latest,) = glob.glob(str(tmp_path / "runs" / "keys" / "*" / "*_latest.pkl"))
        blob = torch.load(latest, weights_only=True)
        # 4 train frames, 2 batches an epoch: iteration 4 ends the second
        assert blob["epoch"] == 4 and blob["data_stream"] == {"seed": SEED, "epoch": 1,
                                                             "consumed": 2}
    finally:
        for pkl in glob.glob(str(tmp_path / "runs" / "**" / "*.pkl"), recursive=True):
            os.remove(pkl)


def _jax_noisy_evaluate(yml: str, pkl: str):
    cfg = jax_load_config(yml)
    d = cfg["data"]
    ds = JaxDataset(root=d["path"], split=d["test_split"], img_size=(EVAL_IMG, EVAL_IMG),
                    commun_label=d["commun_label"], target_view=d["target_view"],
                    noisy_type=d["noisy_type"])
    loader = JaxDataLoader(ds, cfg["training"]["batch_size"], num_workers=2)
    trainer = get_trainer(cfg)(cfg, None, logging.getLogger("test"), jax_get_model(cfg, 11),
                               jax_get_loss(cfg), None, loader, jax_get_optimizer(cfg))
    trainer.load_weight(pkl)
    trainer.evaluate(loader)
    return trainer.last_eval_metrics


def test_test_cli_noisy_matches_jax(fixture, tmp_path):  # noqa: F811
    ymls, pkl = fixture
    with open(ymls[False]) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(noisy_type="occlusion", cache_decoded=str(tmp_path / "cache"))
    yml = str(tmp_path / "noisy.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(cfg, f)
    want = _jax_noisy_evaluate(yml, pkl)
    got = port_test.main(["--config", yml, "--model_path", pkl, "--device", "cpu"])
    clean = port_test.main(["--config", ymls[False], "--model_path", pkl, "--device", "cpu"])
    assert len(os.listdir(tmp_path / "cache")) == len(
        AirsimDataset(cfg["data"]["path"], split="test", target_view="6agent"))
    assert got.total_agent == want.total_agent > 0
    assert (got.correct_when2com, got.correct_who2com) == \
        (want.correct_when2com, want.correct_who2com)
    np.testing.assert_allclose(got.get_avg_bandW(), want.get_avg_bandW(), rtol=1e-6)
    assert not np.array_equal(np.asarray(got.confusion_matrix),
                              np.asarray(clean.confusion_matrix))  # the noise reached the model
    for attr in ("confusion_matrix", "confusion_matrix_pos", "confusion_matrix_neg"):
        g = np.asarray(getattr(got, attr), np.int64)
        w = np.asarray(getattr(want, attr)).astype(np.int64)
        assert g.sum() == w.sum()
        assert np.abs(g - w).sum() / 2 <= 0.001 * w.sum(), attr
