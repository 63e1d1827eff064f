"""The port's export and serve CLIs (``python -m
multiagentperception_tpu_torch.export_serving`` / ``.serve``) on the CPU,
on the repo's synthetic AirSim fixture (6 agents, as tests/test_serve.py
builds it, at 64x64): the artifact and its ``.meta.json``, one class map
per frame and camera equal to the eager serving function's, the padded
tail left out of the bandwidth, ``--colorize``, and the config check."""

from __future__ import annotations

import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch
import yaml
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

from multiagentperception_tpu.data.synthetic import generate_fixture
from multiagentperception_tpu_torch import export_serving as export_cli
from multiagentperception_tpu_torch import serve as serve_cli
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.data import AirsimDataset
from multiagentperception_tpu_torch.export import make_eval_fn
from multiagentperception_tpu_torch.models import get_model, init_weights

H = 64
BATCH = 2
ATTN_SCALE = 20.0  # the seeded attention scaled: `activated` keeps some links here
META_KEYS = {"input_shape", "input_dtype", "inference", "mo_flag", "int8", "config",
             "config_sha256", "model_path", "arch"}  # scripts/export_serving.py:114-129


def _cfg(root: str, size: int = H) -> dict:
    return {
        "model": {"arch": "MIMOcom", "agent_num": 6, "query_size": 8, "key_size": 64,
                  "multiple_output": True},
        "data": {"dataset": "airsim", "path": root, "img_rows": size, "img_cols": size,
                 "target_view": "6agent", "commun_label": "None", "test_split": "test"},
        "training": {"batch_size": BATCH, "n_workers": 0},
    }


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The fixture, its YAML, a seeded reference-format ``.pkl``, and the
    artifact the export CLI writes from it at batch 2."""
    work = tmp_path_factory.mktemp("torch_serve")
    root = str(work / "data")
    generate_fixture(root, target_view="6agent", img_size=H, frames_per_traj=5)
    yml = str(work / "serve.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(_cfg(root), f)
    cfg = load_config(yml)
    model = init_weights(get_model(cfg, 11), 0).eval()
    with torch.no_grad():
        model.attention_net.linear.weight.mul_(ATTN_SCALE)
    pkl = str(work / "mimocom.pkl")
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0}, pkl)
    artifact = str(work / "model.pt2")
    export_cli.main(["--config", yml, "--model_path", pkl, "--out", artifact,
                     "--batch", str(BATCH), "--device", "cpu"])
    ds = AirsimDataset(root, split="test", img_size=(H, H), target_view="6agent")
    return {"work": work, "root": root, "yml": yml, "artifact": artifact, "model": model,
            "ds": ds}


def test_export_cli_writes_the_artifact_and_its_meta(served):
    assert os.path.getsize(served["artifact"]) > 0
    with open(served["artifact"] + ".meta.json") as f:
        meta = json.load(f)
    assert set(meta) == META_KEYS
    assert meta["input_shape"] == [BATCH, 6, H, H, 3] and meta["input_dtype"] == "float32"
    assert (meta["inference"], meta["int8"], meta["arch"]) == ("activated", False, "MIMOcom")


def _serve(served, out, *extra):
    return serve_cli.main(["--config", served["yml"], "--artifact", served["artifact"],
                           "--split", "test", "--out", str(out), "--device", "cpu", *extra])


def _eager(served):
    """The eager serving function over the split's frames, in the batches
    the server forms (the tail padded by repetition): per-frame class maps
    and bandwidth of the real frames."""
    ds, eval_fn = served["ds"], make_eval_fn(served["model"])
    frames = np.stack([ds[i][0] for i in range(len(ds))])
    maps, bandwidth = [], []
    for i in range(0, len(frames), BATCH):
        chunk = frames[i:i + BATCH]
        real = len(chunk)
        chunk = np.concatenate([chunk] + [chunk[-1:]] * (BATCH - real))
        cls, _, nc = eval_fn(torch.from_numpy(chunk))
        maps.append(cls.numpy().reshape(BATCH, 6, H, H)[:real])
        bandwidth.append(nc.numpy()[:real])
    return np.concatenate(maps), np.concatenate(bandwidth)


def test_serve_cli_writes_one_map_per_frame_and_camera(served, tmp_path, capsys):
    """A split whose frame count is no multiple of the batch: every frame's
    every camera written once, its ids the eager class map's."""
    n_frames = len(served["ds"])
    assert n_frames % BATCH
    stats = _serve(served, tmp_path / "preds")
    preds = sorted(glob.glob(str(tmp_path / "preds" / "*.png")))
    assert len(preds) == stats["maps"] == n_frames * 6
    want, _ = _eager(served)
    for frame in range(n_frames):
        for cam in range(6):
            ids = cv2.imread(str(tmp_path / "preds" / f"frame{frame:05d}_cam{cam}.png"),
                             cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(ids, want[frame, cam])
    assert f"wrote {n_frames * 6} prediction maps" in capsys.readouterr().out


def test_closing_line_bandwidth_leaves_out_the_padded_frames(served, tmp_path, capsys):
    """The mean per-frame bandwidth over the real frames only: the padded
    tail frame's (a copy of the last) is not counted."""
    stats = _serve(served, tmp_path / "preds")
    _, bandwidth = _eager(served)
    want = sum(float(bandwidth[i:i + BATCH].sum())
               for i in range(0, len(bandwidth), BATCH)) / len(bandwidth)
    assert stats["bandwidth"] == pytest.approx(want, rel=1e-6)
    assert 0 < want < 5  # the graph keeps some links, not all
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.endswith(f"avg bandwidth {want:.2f} links/agent"), line


def test_serve_cli_colorize_writes_rgb_panels(served, tmp_path):
    stats = _serve(served, tmp_path / "preds", "--colorize", "--limit", "1")
    rgb = sorted(glob.glob(str(tmp_path / "preds" / "*_rgb.png")))
    assert len(rgb) == stats["maps"] == 6
    img = cv2.imread(rgb[0])
    assert img.shape == (H, H, 3) and img.dtype == np.uint8


def test_serve_cli_refuses_another_image_size(served, tmp_path):
    """Frames of another size than the artifact's input (a fixture and a
    config at 32x32) stop the server before it serves."""
    root = str(tmp_path / "data32")
    generate_fixture(root, target_view="6agent", img_size=H // 2, frames_per_traj=1)
    yml = str(tmp_path / "other.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(_cfg(root, size=H // 2), f)
    with pytest.raises(SystemExit, match="config mismatch"):
        serve_cli.main(["--config", yml, "--artifact", served["artifact"], "--split", "test",
                        "--out", str(tmp_path / "preds"), "--device", "cpu"])
