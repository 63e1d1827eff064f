"""The port's ``train``, ``test``, ``export_serving`` and ``serve`` CLIs on
the CPU (``--device cpu``) with ``model.dtype: float16``, at toy size on the
synthetic AirSim fixture (tests/test_torch_zoo_eval.py's ``toy_yaml``:
128x128, the flagship YAML's agents, batch size and labels), as
tests/test_torch_mixed_precision_cli.py runs them in bf16: the flagship
trains two iterations, validates, writes a ``.pkl`` of float32 tensors and
evaluates the test split; the ``test`` CLI evaluates that ``.pkl`` in
float16, also with ``--int8``; the export CLI writes a float16 artifact and
an int8 one (float16 output) from it, and the serve CLI serves two frames
through each. The float16 artifact's class maps equal the eager float16
serving function's on the same frames (the same plain versions on the
same CPU), and the int8 one's the eager int8 serving function's
(``quantize.make_int8_eval_fn``) with the scales the export CLI calibrates
(its ``_calibration_batches``, one batch of the train split).
"""

from __future__ import annotations

import glob
import os

import cv2
import numpy as np
import torch
import yaml

from multiagentperception_tpu_torch import export_serving as export_cli
from multiagentperception_tpu_torch import serve as serve_cli
from multiagentperception_tpu_torch import test as port_test
from multiagentperception_tpu_torch import train as port_train
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.data import AirsimDataset
from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.export import make_eval_fn
from multiagentperception_tpu_torch.quantize import calibrate_activations, make_int8_eval_fn
from test_torch_train import drop_files, few_threads  # noqa: F401 (autouse fixtures)
from test_torch_zoo_eval import IMG, ROOT, fixture_roots, toy_yaml  # noqa: F401

FLAGSHIP = ROOT / "configs" / "multi-request-multi-support" / "mrms_when2com.yml"
SERVED = 2  # frames a serve run takes


def _served_maps(out_dir, frames: int, agents: int) -> np.ndarray:
    return np.stack([[cv2.imread(os.path.join(out_dir, f"frame{f:05d}_cam{c}.png"),
                                 cv2.IMREAD_GRAYSCALE) for c in range(agents)]
                     for f in range(frames)])


def test_float16_train_test_export_and_serve_cli(fixture_roots, tmp_path, monkeypatch,  # noqa: F811
                                                 capsys):
    path = toy_yaml(FLAGSHIP, fixture_roots, tmp_path, train_iters=2, val_interval=2,
                    print_interval=1)
    raw = yaml.safe_load(open(path))
    raw["model"]["dtype"] = "float16"
    raw["training"]["batch_size"] = 1
    yml = tmp_path / "f16.yml"
    yml.write_text(yaml.safe_dump(raw))
    monkeypatch.chdir(tmp_path)
    (result,) = port_train.main(["--config", str(yml), "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("Iter [2/2]", "Overall", "Bandwidth:"):
        assert line in out, line
    assert all(np.isfinite(v) for v in result[0].values())
    (pkl,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "runs") for f in fs
              if f == "MIMOcom_airsim_best_model.pkl"]
    blob = torch.load(pkl, weights_only=True)
    assert all(v.dtype == torch.float32 for v in blob["model_state"].values()
               if v.is_floating_point())

    cfg = load_config(str(yml))
    agents = cfg["model"]["agent_num"]
    for extra in ([], ["--int8", "--calib_batches", "1"]):
        metrics = port_test.main(["--config", str(yml), "--model_path", pkl,
                                  "--device", "cpu", *extra])
        out = capsys.readouterr().out
        assert "Overall" in out.splitlines() and "Bandwidth:" in out
        assert int(metrics.confusion_matrix.sum()) > 0
        assert all(np.isfinite(v) for v in metrics.get_scores()[0].values())
        assert 0.0 <= metrics.get_avg_bandW() <= agents - 1

    ev = Evaluator(cfg, device="cpu")
    ev.load_weight(pkl)
    assert ev.compute_dtype is torch.float16
    ds = AirsimDataset(cfg["data"]["path"], split="test", img_size=(IMG, IMG),
                       target_view=cfg["data"]["target_view"])
    frames = torch.from_numpy(np.stack([ds[i][0] for i in range(SERVED)]))
    model = ev.model.eval()
    calib = export_cli._calibration_batches(cfg, cfg["data"]["path"], 1, 1)
    scales = calibrate_activations(model, [torch.from_numpy(b) for b in calib],
                                   inference="activated", full_res=False)
    eager = {"f16": make_eval_fn(model), "int8": make_int8_eval_fn(model, act_scales=scales)}
    for name, extra in (("f16", []), ("int8", ["--int8", "--calib_batches", "1"])):
        artifact = str(tmp_path / f"{name}.pt2")
        export_cli.main(["--config", str(yml), "--model_path", pkl, "--out", artifact,
                         "--batch", "1", "--device", "cpu", *extra])
        stats = serve_cli.main(["--config", str(yml), "--artifact", artifact, "--split",
                                "test", "--out", str(tmp_path / name), "--limit", str(SERVED),
                                "--device", "cpu"])
        assert stats["maps"] == SERVED * agents
        assert len(glob.glob(str(tmp_path / name / "*.png"))) == SERVED * agents
        want = np.concatenate([eager[name](frames[i:i + 1])[0].numpy()
                               for i in range(SERVED)]).reshape(SERVED, agents, IMG, IMG)
        np.testing.assert_array_equal(_served_maps(tmp_path / name, SERVED, agents), want)
