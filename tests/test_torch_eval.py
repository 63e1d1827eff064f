"""The port's evaluation CLI against the JAX ``Trainer.evaluate`` on the
synthetic AirSim fixture (128x128, 6 agents), from one reference-format
``.pkl`` written by ``compat.save_reference_checkpoint``.

Selection accuracy must be equal. Bandwidth too, up to the float32 rounding
of its one division (rtol 1e-6): the JAX step is compiled, and XLA turns
the division by ``agent_num * B`` into a product with the reciprocal, one
ulp away from the port's eager division. The confusion matrices hold the
same total and differ on at most 0.1% of the pixels (class flips at
near-ties, the decoder's convolutions summing in another order).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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

IMG = 128
PROJ_SCALE = 30.0  # a peaked graph: `activated` keeps links on untrained weights


def _smoke_cfg(root: str, pallas_comm: bool, on_device_normalize: bool) -> dict:
    return {
        "model": {"arch": "MIMOcom", "agent_num": 6, "shared_img_encoder": "unified",
                  "attention": "general", "sparse": False, "query": True,
                  "query_size": 8, "key_size": 64, "enc_backbone": "resnet_encoder",
                  "dec_backbone": "simple_decoder", "feat_squeezer": -1,
                  "feat_channel": 512, "multiple_output": True,
                  "pallas_comm": pallas_comm},
        "data": {"dataset": "airsim", "train_split": "train", "val_split": "val",
                 "test_split": "test", "img_rows": IMG, "img_cols": IMG, "path": root,
                 "target_view": "6agent", "commun_label": "mimo",
                 "on_device_normalize": on_device_normalize},
        "training": {"train_iters": 4, "batch_size": 2, "val_interval": 2,
                     "n_workers": 2, "print_interval": 1,
                     "optimizer": {"name": "adam", "lr": 1.0e-4},
                     "loss": {"name": "cross_entropy", "size_average": True}},
    }


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The fixture dataset, one YAML per ``pallas_comm`` setting (the fused
    one also normalizes on the device), and one checkpoint of seeded
    weights with non-trivial BatchNorm statistics."""
    work = tmp_path_factory.mktemp("torch_eval")
    root = str(work / "data")
    generate_fixture(root, target_view="6agent", img_size=IMG, frames_per_traj=4)
    ymls = {}
    for pallas in (False, True):
        ymls[pallas] = str(work / f"smoke_{int(pallas)}.yml")
        with open(ymls[pallas], "w") as f:
            yaml.safe_dump(_smoke_cfg(root, pallas, on_device_normalize=pallas), f)
    cfg = jax_load_config(ymls[False])
    x = jnp.zeros((2, 6, IMG, IMG, 3), jnp.float32)
    variables = jax_get_model(cfg, 11).init(jax.random.PRNGKey(0), x, train=False,
                                            inference="softmax")
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)

    def stats(tree):
        if "mean" in tree:
            return {"mean": (rng.standard_normal(tree["mean"].shape) * 0.1).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, tree["var"].shape).astype(np.float32)}
        return {k: stats(v) for k, v in tree.items()}

    params = variables["params"]
    proj = params["MIMOGeneralDotAttention_0"]["proj"]
    proj["kernel"] = proj["kernel"] * PROJ_SCALE
    pkl = str(work / "mimocom.pkl")
    save_reference_checkpoint(cfg, {"params": params,
                                    "batch_stats": stats(variables["batch_stats"])}, pkl)
    return ymls, pkl


def _jax_evaluate(yml: str, pkl: str):
    cfg = jax_load_config(yml)
    d = cfg["data"]
    ds = AirsimDataset(root=d["path"], split=d["test_split"], img_size=(IMG, IMG),
                       commun_label=d["commun_label"], target_view=d["target_view"],
                       raw_images=bool(d["on_device_normalize"]))
    loader = DataLoader(ds, cfg["training"]["batch_size"], num_workers=2)
    trainer = get_trainer(cfg)(cfg, None, logging.getLogger("test"), jax_get_model(cfg, 11),
                               get_loss_function(cfg), None, loader, get_optimizer(cfg))
    trainer.load_weight(pkl)
    trainer.evaluate(loader)
    return trainer.last_eval_metrics


def _printed(text: str, prefix: str) -> str:
    return [line for line in text.splitlines() if line.startswith(prefix)][-1]


@pytest.mark.parametrize("pallas_comm", [False, True],
                         ids=["plain", "fused_comm_device_normalize"])
def test_port_cli_matches_jax_evaluate(fixture, pallas_comm, capsys):
    ymls, pkl = fixture
    want = _jax_evaluate(ymls[pallas_comm], pkl)
    jax_out = capsys.readouterr().out
    got = port_cli.main(["--config", ymls[pallas_comm], "--model_path", pkl,
                         "--device", "cpu"])
    port_out = capsys.readouterr().out

    assert got.total_agent == want.total_agent > 0
    assert (got.correct_when2com, got.correct_who2com) == \
        (want.correct_when2com, want.correct_who2com)
    assert got.count == want.count
    np.testing.assert_allclose(got.get_avg_bandW(), want.get_avg_bandW(), rtol=1e-6)
    assert want.get_avg_bandW() > 0  # the graph keeps links: a real fusion ran
    assert _printed(port_out, "Bandwidth:")
    for prefix in ("Validation when2com accuracy:", "Validation who2com accuracy:"):
        assert _printed(port_out, prefix) == _printed(jax_out, prefix)
    for title in ("Normal", "Noise", "Overall"):
        assert title in port_out.splitlines()
    for attr in ("confusion_matrix", "confusion_matrix_pos", "confusion_matrix_neg"):
        g = np.asarray(getattr(got, attr), np.int64)
        w = np.asarray(getattr(want, attr)).astype(np.int64)
        assert g.sum() == w.sum()
        assert np.abs(g - w).sum() / 2 <= 0.001 * w.sum(), attr
