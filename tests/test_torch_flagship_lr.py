"""The flagship YAML at its stock lr 1e-5, the port against the JAX package
from the same initial weights, on the CPU (slow: hours at 5000 iterations,
most of them the JAX package's XLA:CPU steps).

Both packages train the config that ``run_flagship_512.derive_config``
writes (the JAX script's, held equal to it by
tests/test_torch_flagship_run.py) with ``training.seed`` set, on the
informative fixture at ``img``², 16 frames a trajectory, at once:

- the JAX package through its train CLI, ``train.py``, from its own initial
  weights (``init_variables`` at the seed);
- the port through its train CLI (``run_flagship_512.run_train_cli``) from
  those same weights (``jax_start_state``, carried by
  ``convert.state_dict_from_flax``), resumed at iteration 0.

Each log's train loss (every 50 iterations) and validations (selection
accuracy, Normal / Noise / Overall mIoU) are printed as one JSON line a
package. Both must train (the mean of the last ``TAIL`` printed losses
under ``LOSS_DROP`` of the first), both must end above the always-self
selection baseline, ``ALWAYS_SELF`` (data/synthetic.py:122-124), and, at
the last validation, the port's selection accuracy and Overall mIoU lie
within ``SEL_POINTS`` and ``MIOU_POINTS`` of JAX's. A case runs the derived
config as it is (``mixed``: bf16 convolutions) or with
``training.mixed_precision`` off in both packages (``float32``). Both trainings are
chaotic in their float rounding and see their batches in other orders
(each package shuffles by its own rule), so the bounds are on the
learning, not on the numbers.

``test_port_in_jax_order_learns_at_lr_1e5`` trains the port alone from
JAX's weights at seed 1337 with its batches in the JAX package's order
(grain's ``IndexSampler`` in place of the port's ``default_rng(seed +
epoch)`` permutation), a step of the bisection of the two packages'
difference; it holds the same learning bounds and prints the same line.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flagship_lr.py -m slow -s -k "1337-float32"
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import yaml

from multiagentperception_tpu_torch import run_flagship_512 as flagship
from torch_flagship_lr import derived, jax_start_state, summary, write_start

ROOT = Path(__file__).resolve().parents[1]
SHAPE = [(64, 5000, 1000)]  # img, iters, val_interval
SEL_POINTS = 15.0
MIOU_POINTS = 8.0
ALWAYS_SELF = 100.0 * (6 - 2) / 6  # always oneself: (N - n_noisy) / N (synthetic.py:122-124)
TAIL = 10
LOSS_DROP = 0.2
BISECT_SEED = 1337


def _fixture(root: Path, img: int) -> None:
    from multiagentperception_tpu.data.synthetic import generate_informative_fixture

    generate_informative_fixture(str(root), target_view="6agent", img_size=img,
                                 frames_per_traj=16, n_noisy=2)


def _write(cfg: dict, workdir: Path) -> str:
    os.makedirs(workdir, exist_ok=True)
    path = workdir / flagship.CONFIG_NAME
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def _start_jax(cfg: dict, workdir: Path) -> subprocess.Popen:
    """The JAX train CLI on ``cfg`` (its own initial weights at the seed)."""
    cfg_path = _write({**cfg, "training": {**cfg["training"], "resume": None}}, workdir)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    log = open(workdir / flagship.LOG_NAME, "w")
    return subprocess.Popen([sys.executable, str(ROOT / "train.py"), "--config", cfg_path],
                            stdout=log, stderr=subprocess.STDOUT, cwd=workdir, env=env)


def _port_cfg(tmp_path: Path, img: int, iters: int, val_interval: int, seed: int) -> dict:
    """The derived config for the port, resuming from JAX's initial weights."""
    root, workdir = str(tmp_path / "data"), str(tmp_path / "port")
    os.makedirs(workdir, exist_ok=True)
    start = write_start(derived(img, iters, val_interval, root, workdir, seed),
                        jax_start_state(derived(img, iters, val_interval, root, workdir, seed),
                                        seed),
                        str(tmp_path / "start.pkl"))
    return derived(img, iters, val_interval, root, workdir, seed, start=start)


def grain_order(loader, epoch: int) -> np.ndarray:
    """``GrainLoader.order`` in the JAX package's order: epoch ``epoch`` of
    grain's endless ``IndexSampler`` at the loader's seed."""
    import grain.python as gp

    frames = loader._frames()
    if not loader.shuffle:
        return frames
    n = len(frames)
    sampler = gp.IndexSampler(num_records=n, shuffle=True, seed=loader.seed, num_epochs=None,
                              shard_options=gp.NoSharding())
    return frames[[sampler[epoch * n + i].record_key for i in range(n)]]


def port_in_grain_order(cfg_path: str) -> int:
    """The port's train CLI on the CPU with its batches in ``grain_order``."""
    from multiagentperception_tpu_torch import train
    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader

    with mock.patch.object(GrainLoader, "order", grain_order):
        train.main(["--config", cfg_path, "--device", "cpu"])
    return 0


def _run_port(cfg: dict, workdir: Path, grain: bool = False) -> tuple[int, str]:
    cfg_path = _write(cfg, workdir)
    if grain:
        code = ("import sys; sys.path.insert(0, sys.argv[2]); import test_torch_flagship_lr as t; "
                "sys.exit(t.port_in_grain_order(sys.argv[1]))")
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        with open(workdir / flagship.LOG_NAME, "w") as log:
            rc = subprocess.call([sys.executable, "-c", code, cfg_path, str(ROOT / "tests")],
                                 stdout=log, stderr=subprocess.STDOUT, cwd=workdir, env=env)
    else:
        rc = flagship.run_train_cli(cfg_path, str(workdir), "cpu")
    return rc, (workdir / flagship.LOG_NAME).read_text()


def _check_learns(name: str, r: dict, iters: int, val_interval: int) -> None:
    assert len(r["val_when2com"]) == iters // val_interval, (name, r["val_when2com"])
    first, tail = r["loss"][0][1], np.mean([v for _, v in r["loss"][-TAIL:]])
    assert tail < LOSS_DROP * first, (name, "train loss", first, tail)
    assert r["val_when2com"][-1] > ALWAYS_SELF, (name, "selection", r["val_when2com"])


@pytest.mark.slow
@pytest.mark.parametrize("seed,precision", [(1337, "mixed"), (1338, "mixed"), (1337, "float32")])
@pytest.mark.parametrize("img,iters,val_interval", SHAPE)
def test_port_learns_as_jax_at_lr_1e5(tmp_path, img, iters, val_interval, seed, precision):
    _fixture(tmp_path / "data", img)
    cfg = _port_cfg(tmp_path, img, iters, val_interval, seed)
    cfg["training"]["mixed_precision"] = precision == "mixed"
    jax_proc = _start_jax(cfg, tmp_path / "jax")
    port_rc, port_log = _run_port(cfg, tmp_path / "port")
    jax_rc = jax_proc.wait()
    runs = {"jax": summary((tmp_path / "jax" / flagship.LOG_NAME).read_text()),
            "port": summary(port_log)}
    for name, r in runs.items():
        print(json.dumps({"package": name, "img": img, "iters": iters, "seed": seed,
                          "precision": precision, **r}))
    assert (port_rc, jax_rc) == (0, 0)
    assert "Loaded checkpoint" in port_log  # the port started from JAX's weights

    for name, r in runs.items():
        _check_learns(name, r, iters, val_interval)
    jax, port = runs["jax"], runs["port"]
    assert abs(port["val_when2com"][-1] - jax["val_when2com"][-1]) <= SEL_POINTS, \
        ("selection", port["val_when2com"], jax["val_when2com"])
    assert abs(port["val_overall"][-1] - jax["val_overall"][-1]) <= MIOU_POINTS, \
        ("Overall mIoU", port["val_overall"], jax["val_overall"])


@pytest.mark.slow
@pytest.mark.parametrize("img,iters,val_interval", SHAPE)
def test_port_in_jax_order_learns_at_lr_1e5(tmp_path, img, iters, val_interval):
    _fixture(tmp_path / "data", img)
    cfg = _port_cfg(tmp_path, img, iters, val_interval, BISECT_SEED)
    rc, log = _run_port(cfg, tmp_path / "port", grain=True)
    r = summary(log)
    print(json.dumps({"package": "port", "order": "jax", "img": img, "iters": iters,
                      "seed": BISECT_SEED, **r}))
    assert rc == 0 and "Loaded checkpoint" in log
    _check_learns("port in JAX's order", r, iters, val_interval)
