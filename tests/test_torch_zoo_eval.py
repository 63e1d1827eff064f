"""The port's ``test`` CLI against the JAX ``Trainer.evaluate`` for each of
the nine reference YAMLs that MIMOcom's (tests/test_torch_eval.py) leaves,
at toy size on the synthetic AirSim fixture: 128x128, query_size 8,
key_size 64, the YAML's own agents, batch size and labels (6 agents with
``mimo`` labels for ``mrms_*``, 5 with ``when2com`` labels or none for
``srms_*``). One reference-format ``.pkl`` per YAML, written from seeded
JAX weights by ``compat.save_reference_checkpoint``, feeds both.

The selection baselines (``*_randcom``) draw their partners in each
framework; the port is handed the ids the JAX evaluation drew, batch by
batch (its actions), since the generators cannot agree bit for bit.

Selection accuracy and bandwidth must be equal. The confusion matrices
hold the same total and differ on at most 0.1% of the pixels.
"""

from __future__ import annotations

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multiagentperception_tpu.compat import save_reference_checkpoint
from multiagentperception_tpu.config import load_config as jax_load_config
from multiagentperception_tpu.data import AirsimDataset, DataLoader
from multiagentperception_tpu.data.synthetic import generate_fixture
from multiagentperception_tpu.loss import get_loss_function
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.optimizers import get_optimizer
from multiagentperception_tpu.trainer import get_trainer
from multiagentperception_tpu_torch import test as port_cli
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.evaluate import Evaluator
from test_torch_zoo import jax_kwargs, seeded_stats
from test_torch_zoo import _scale_attention as scale_attention
from test_torch_train import drop_files, few_threads  # noqa: F401 (autouse fixtures)

ROOT = Path(__file__).resolve().parents[1]
IMG = 128
ZOO_YAMLS = [p for p in sorted((ROOT / "configs").glob("*-*/*.yml"))
             if p.name != "mrms_when2com.yml"]
COMM_KEYS = {"query_size": 8, "key_size": 64}


@pytest.fixture(scope="module")
def fixture_roots(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_zoo_eval")
    roots = {}
    for view in ("6agent", "target"):
        roots[view] = str(work / view)
        generate_fixture(roots[view], target_view=view, img_size=IMG, frames_per_traj=4)
    return roots


def toy_yaml(yml: Path, roots: dict, out_dir: Path, **training) -> str:
    """The YAML at toy size on the fixture of its view; nothing else changed."""
    cfg = yaml.safe_load(yml.read_text())
    cfg["data"].update(img_rows=IMG, img_cols=IMG, path=roots[cfg["data"]["target_view"]])
    if "query_size" in cfg["model"]:
        cfg["model"].update(COMM_KEYS)
    cfg["training"].update(n_workers=2, **training)
    path = out_dir / yml.name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def reference_pkl(yml: str, path: str, seed: int = 0) -> str:
    """Seeded JAX weights (attention scaled, BatchNorm statistics seeded) as a
    reference-format ``.pkl``."""
    cfg = jax_load_config(yml)
    m = cfg["model"]
    shape = (2, m["agent_num"], IMG, IMG, 3)
    if m["arch"] == "Single_agent":
        shape = (2 * m["agent_num"] if m["multiple_output"] else 2, IMG, IMG, 3)
    rngs = {"params": jax.random.PRNGKey(seed), "action": jax.random.PRNGKey(seed + 1)}
    variables = jax.tree_util.tree_map(np.asarray, jax_get_model(cfg, 11).init(
        rngs, jnp.zeros(shape, jnp.float32), **jax_kwargs(cfg, False)))
    scale_attention(variables["params"])
    save_reference_checkpoint(cfg, {
        "params": variables["params"],
        "batch_stats": seeded_stats(variables["batch_stats"], np.random.default_rng(seed))},
        path)
    return path


def jax_evaluate(yml: str, pkl: str):
    """The JAX evaluation's metrics, and the actions it recorded per batch."""
    cfg = jax_load_config(yml)
    d = cfg["data"]
    ds = AirsimDataset(root=d["path"], split=d["test_split"], img_size=(IMG, IMG),
                       commun_label=d["commun_label"], target_view=d["target_view"])
    loader = DataLoader(ds, cfg["training"]["batch_size"], num_workers=2)
    trainer = get_trainer(cfg)(cfg, None, logging.getLogger("test"), jax_get_model(cfg, 11),
                               get_loss_function(cfg), None, loader, get_optimizer(cfg))
    actions = []
    update = trainer._update_selection

    def recording(metrics, commun_label, action):
        actions.append(np.array(action))
        return update(metrics, commun_label, action)

    trainer._update_selection = recording
    trainer.load_weight(pkl)
    trainer.evaluate(loader)
    return trainer.last_eval_metrics, actions


def assert_metrics_match(got, want) -> None:
    assert got.total_agent == want.total_agent
    assert (got.correct_when2com, got.correct_who2com) == \
        (want.correct_when2com, want.correct_who2com)
    assert got.count == want.count
    if want.count:
        assert got.get_avg_bandW() == want.get_avg_bandW()
    for attr in ("confusion_matrix", "confusion_matrix_pos", "confusion_matrix_neg"):
        g = np.asarray(getattr(got, attr), np.int64)
        w = np.asarray(getattr(want, attr)).astype(np.int64)
        assert g.sum() == w.sum(), attr
        assert np.abs(g - w).sum() / 2 <= 0.001 * w.sum(), attr


@pytest.mark.parametrize("yml", ZOO_YAMLS, ids=lambda p: p.stem)
def test_port_cli_matches_jax_evaluate(yml, fixture_roots, tmp_path, monkeypatch, capsys):
    path = toy_yaml(yml, fixture_roots, tmp_path)
    pkl = reference_pkl(path, str(tmp_path / "ref.pkl"))
    want, actions = jax_evaluate(path, pkl)
    arch = jax_load_config(path)["model"]["arch"]
    if arch in ("All_agents", "MIMO_All_agents") and actions:  # the JAX draws, in order
        ids = [torch.from_numpy(np.asarray(a[0], np.int64)) for a in actions]
        monkeypatch.setattr(Evaluator, "draw_ids", lambda self, stream: ids.pop(0))
    capsys.readouterr()
    got = port_cli.main(["--config", path, "--model_path", pkl, "--device", "cpu"])
    out = capsys.readouterr().out
    assert_metrics_match(got, want)
    assert "Overall" in out.splitlines()
    if arch in ("MIMOcomWho", "LearnWhen2Com"):
        assert "Bandwidth:" in out and want.count > 0
    if arch in ("All_agents", "MIMO_All_agents", "MIMOcomWho", "LearnWho2Com"):
        assert got.total_agent > 0  # selection accuracy was recorded
    if arch == "LearnWhen2Com":  # skipped in evaluation, as the reference does
        assert got.total_agent == 0


def test_learnwhen2com_drops_the_reference_argmax_decoder(fixture_roots, tmp_path, caplog):
    """A reference LearnWhen2Com ``.pkl`` also holds ``argmax_decoder.*``:
    the port drops those keys with one logged line and loads the rest
    strictly."""
    yml = next(p for p in ZOO_YAMLS if p.stem == "srms_when2com")
    path = toy_yaml(yml, fixture_roots, tmp_path)
    pkl = reference_pkl(path, str(tmp_path / "ref.pkl"))
    blob = torch.load(pkl, weights_only=True)
    blob["model_state"]["argmax_decoder.output_decoder.pred.0.weight"] = torch.zeros(1)
    torch.save(blob, pkl)
    ev = Evaluator(load_config(path), device="cpu")
    with caplog.at_level(logging.INFO, logger="multiagentperception_tpu_torch"):
        ev.load_weight(pkl)
    assert "argmax_decoder" in caplog.text
