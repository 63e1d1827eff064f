"""The port's ``visual.py`` against the JAX package's: each numpy function
on the same seeded inputs gives the same array, the port dataset's
``decode_segmap`` equals JAX's, and ``python -m
multiagentperception_tpu_torch.visualize`` writes panels and a comm graph
from a toy checkpoint on the CPU."""

from __future__ import annotations

import os

import cv2
import numpy as np
import pytest
import torch
import yaml
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

from multiagentperception_tpu import visual as jv
from multiagentperception_tpu.data.airsim import AirsimDataset as JaxAirsimDataset
from multiagentperception_tpu.data.synthetic import generate_fixture
from multiagentperception_tpu_torch import visual as tv
from multiagentperception_tpu_torch import visualize as cli
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.data.airsim import AirsimDataset
from multiagentperception_tpu_torch.models import get_model, init_weights

RNG_SEED = 11


@pytest.fixture
def rng():
    return np.random.default_rng(RNG_SEED)


@pytest.mark.parametrize("n_classes", [11, 300])
def test_class_palette_matches_jax(n_classes):
    np.testing.assert_array_equal(tv.class_palette(n_classes), jv.class_palette(n_classes))


def test_colorize_segmap_matches_jax(rng):
    labels = rng.integers(0, 12, size=(33, 17))
    labels[rng.random(labels.shape) < 0.1] = 0  # the ignore index
    got = tv.colorize_segmap(labels)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jv.colorize_segmap(labels))


@pytest.mark.parametrize("img_norm", [True, False])
def test_denormalize_image_matches_jax(rng, img_norm):
    img = rng.normal(scale=0.5 if img_norm else 100.0, size=(9, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(tv.denormalize_image(img, img_norm),
                                  jv.denormalize_image(img, img_norm))


def test_draw_bounding_matches_jax(rng):
    img = rng.integers(0, 256, size=(40, 30, 3)).astype(np.uint8)
    boxes = [(2, 3, 20, 25), (-5, 10, 50, 12), (28, 38, 1, 0)]
    for thickness in (1, 3):
        got = tv.draw_bounding(img, boxes, color=(9, 8, 7), thickness=thickness)
        np.testing.assert_array_equal(got, jv.draw_bounding(img, boxes, color=(9, 8, 7),
                                                            thickness=thickness))
    assert not np.shares_memory(got, img)


@pytest.mark.parametrize("uint8", [False, True])
def test_prediction_panel_matches_jax(rng, uint8):
    image = (rng.integers(0, 256, size=(24, 24, 3)).astype(np.uint8) if uint8
             else rng.normal(size=(24, 24, 3)).astype(np.float32))
    gt = rng.integers(0, 11, size=(24, 24))
    pred = rng.integers(0, 11, size=(24, 24))
    got = tv.prediction_panel(image, gt, pred, pad=3)
    np.testing.assert_array_equal(got, jv.prediction_panel(image, gt, pred, pad=3))


@pytest.mark.parametrize("with_action", [False, True])
def test_comm_graph_image_matches_jax(rng, with_action):
    prob = rng.random((5, 5))
    action = np.eye(5)[rng.integers(0, 5, size=5)].T if with_action else None
    np.testing.assert_array_equal(tv.comm_graph_image(prob, action, cell=12),
                                  jv.comm_graph_image(prob, action, cell=12))


def test_comm_graph_image_refuses_a_batch():
    with pytest.raises(ValueError, match="N_keys"):
        tv.comm_graph_image(np.zeros((2, 3, 3)))


def test_decode_segmap_matches_jax(rng):
    labels = rng.integers(0, 11, size=(16, 20))
    # the method reads only the class tables: call it unbound on both
    np.testing.assert_array_equal(AirsimDataset.decode_segmap(None, labels),
                                  JaxAirsimDataset.decode_segmap(None, labels))


def test_visualize_cli_writes_panels_and_a_graph(tmp_path):
    """From a seeded toy checkpoint on the fixture: up to 8 panels per
    batch (input | ground truth | prediction) and the batch's (N, N)
    comm graph."""
    h = 64
    root = str(tmp_path / "data")
    generate_fixture(root, target_view="6agent", img_size=h, frames_per_traj=2)
    yml = str(tmp_path / "viz.yml")
    with open(yml, "w") as f:
        yaml.safe_dump({
            "model": {"arch": "MIMOcom", "agent_num": 6, "query_size": 8, "key_size": 64,
                      "multiple_output": True},
            "data": {"dataset": "airsim", "path": root, "img_rows": h, "img_cols": h,
                     "target_view": "6agent", "commun_label": "mimo", "test_split": "test"},
            "training": {"batch_size": 2, "n_workers": 0}}, f)
    model = init_weights(get_model(load_config(yml), 11), 0)
    pkl = str(tmp_path / "toy.pkl")
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0}, pkl)
    out = str(tmp_path / "viz")
    paths = cli.main(["--config", yml, "--model_path", pkl, "--out_dir", out,
                      "--device", "cpu"])
    panels = [p for p in paths if "panel" in os.path.basename(p)]
    graphs = [p for p in paths if "comm_graph" in os.path.basename(p)]
    assert len(panels) == 8 and len(graphs) == 1
    panel = cv2.imread(panels[0])
    assert panel is not None and panel.shape == (h, 3 * h + 8, 3)
    g = cv2.imread(graphs[0])
    assert g is not None and g.shape[:2] == (6 * 48, 6 * 48)
