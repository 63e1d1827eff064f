"""int8 eval on the agent ring against the JAX package's agent mesh, on the
CPU: 2 gloo ranks (tests/torch_parallel_helpers.py), 4 agents (2 a rank)
at 64x64, query 8, key 64, batch 2, JAX-initialized weights with a peaked
graph, 2 calibration batches.

- JAX first: ``quantize.calibrate_activations`` on the ring model (a
  2-device ``('agent',)`` mesh) returns the dense model's scales: its
  recorder takes max |x| over the global arrays. The dense model that
  decodes once, as the ring does, is the ``pallas_comm`` one: the plain
  dense pruned modes also decode the soft fusion, which the recorder reads
  (ROADMAP §C, "A difference of int8"), so against it the towers' scales
  are equal and the decoder's are not.
- The port's ranks calibrate their own agents and reduce the maxes over
  the world in one MAX collective: each conv's scale (names through
  ``convert.scales_from_flax``) within relative 1e-5 of JAX's ring scales
  (the float32 towers round at other places in the two frameworks;
  measured below 1e-6), on every rank, as ``Evaluator.evaluate(int8=True)``
  calibrates them.
- The class maps (each rank's agents) against JAX's int8 ring eval under
  tests/test_torch_int8_eval.py's static rule: at least 99.5% of pixels,
  the bandwidth exactly; 48 int8 convs a forward on each rank, JAX's ring
  count (its ring decodes the pruned fusion once).
- ``all_reduce_max`` over gloo ranks: the elementwise maximum.
- ``test --agent_parallel 2 --int8`` runs on CPU ranks and prints the
  score tables.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import jax_kwargs, seeded_stats

from multiagentperception_tpu import quantize as jq
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu_torch.convert import scales_from_flax, state_dict_from_flax
from multiagentperception_tpu_torch.data.synthetic import generate_fixture
from multiagentperception_tpu_torch.models import get_model, init_weights
from torch_parallel_helpers import IMG, ROOT, _seeded, run_ranks, toy_cfg

AGENTS, BATCH = 4, 2
PROJ_SCALE = 40.0  # a peaked graph: `activated` prunes some links, keeps others
SCALE_RTOL = 1e-5
CLASS_AGREEMENT = 0.995  # tests/test_torch_int8_eval.py, static scales
MODE = "activated"


def _raw(**model) -> dict:
    return {"model": {"arch": "MIMOcom", "agent_num": AGENTS, "query_size": 8,
                      "key_size": 64, "multiple_output": True, **model},
            "data": {"img_rows": IMG, "img_cols": IMG, "commun_label": "mimo"}}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """JAX weights (peaked graph, seeded BatchNorm statistics), 2
    calibration batches and one eval batch, the JAX dense and ring scales."""
    work = tmp_path_factory.mktemp("ring_int8")
    rng = np.random.default_rng(0)

    def frames():
        return (rng.standard_normal((BATCH, AGENTS, IMG, IMG, 3)) * 0.5).astype(np.float32)

    x = frames()
    calib = [frames(), frames()]
    labels = rng.integers(0, 11, (BATCH, AGENTS, IMG, IMG)).astype(np.int32)
    cl = np.stack([rng.integers(0, 2, (BATCH, AGENTS)), rng.integers(0, AGENTS, (BATCH, AGENTS))],
                  axis=1).astype(np.int64)
    raw = _raw()
    dense = jax_get_model(jax_normalize_config(raw), 11)
    fused = jax_get_model(jax_normalize_config(_raw(pallas_comm=True)), 11)
    v = jax.tree_util.tree_map(np.asarray, dense.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)}, jnp.asarray(x),
        **jax_kwargs(raw, False)))
    proj = v["params"]["MIMOGeneralDotAttention_0"]["proj"]
    proj["kernel"] = proj["kernel"] * PROJ_SCALE
    v = {"params": v["params"], "batch_stats": seeded_stats(v["batch_stats"], rng)}
    ring = jax_get_model(jax_normalize_config(_raw(agent_parallel=2)), 11,
                         agent_mesh=Mesh(np.asarray(jax.devices()[:2]), ("agent",)))
    kw = jax_kwargs(raw, False, MODE)
    scales = {name: jq.calibrate_activations(m, v, [jnp.asarray(b) for b in calib], **kw)
              for name, m in (("dense", dense), ("pallas_comm", fused), ("ring", ring))}
    torch.save(state_dict_from_flax(toy_cfg(AGENTS), v), work / "state.pt")
    torch.save({"calib": [(b,) for b in calib], "eval": [(x, labels, cl)]}, work / "data.pt")
    yield work, ring, v, x, labels, scales
    shutil.rmtree(work)


@pytest.fixture(scope="module")
def ranks(shared):
    work = shared[0]
    return run_ranks("ring_int8", 2, work, agent=2, agents=AGENTS,
                     state=str(work / "state.pt"), data=str(work / "data.pt"), mode=MODE)


@pytest.fixture(scope="module")
def jax_ring_int8(shared):
    """JAX's int8 ring eval with its ring scales: class maps, graph,
    bandwidth."""
    _, ring, v, x, _, scales = shared
    out = jq.quantized_apply(ring, v, jnp.asarray(x), act_scales=scales["ring"],
                             **jax_kwargs(_raw(), False, MODE))
    return np.asarray(jnp.argmax(out[0], axis=-1)), np.asarray(out[1]), float(out[3])


def test_jax_ring_calibration_is_the_dense_one(shared):
    scales = shared[-1]
    for dense in ("pallas_comm", "dense"):
        assert set(scales["ring"]) == set(scales[dense]) and len(scales["ring"]) == 48
    for path, s in scales["pallas_comm"].items():
        assert scales["ring"][path] == pytest.approx(s, rel=1e-6), path
        if path[0] != "ImgDecoder_0":  # the plain dense model decodes twice
            assert scales["ring"][path] == pytest.approx(scales["dense"][path], rel=1e-6), path


def test_ring_scales_match_jax(ranks, shared):
    want = scales_from_flax(toy_cfg(AGENTS), shared[-1]["ring"])
    for rank in ranks:
        assert set(rank["scales"]) == set(want)
        for name, s in want.items():
            assert rank["scales"][name] == pytest.approx(s, rel=SCALE_RTOL), name
    assert ranks[0]["scales"] == ranks[1]["scales"]  # one MAX over the world


def test_ring_int8_matches_jax(ranks, shared, jax_ring_int8):
    want_maps, want_prob, want_bw = jax_ring_int8
    labels = shared[4]
    # each rank's class maps are its 2 agents of each sample: (B*2, H, W)
    maps = np.concatenate([r["maps"].numpy().reshape(BATCH, AGENTS // 2, IMG, IMG)
                           for r in ranks], axis=1)
    agree = (maps == want_maps.reshape(maps.shape)).mean()
    assert agree >= CLASS_AGREEMENT, agree
    assert 0.0 < want_bw < AGENTS - 1  # the graph keeps some links and prunes others
    whole = np.bincount(11 * labels.reshape(-1).astype(np.int64) + maps.reshape(-1),
                        minlength=121).reshape(11, 11)
    for rank in ranks:
        assert rank["calls"] == 48  # JAX's ring count
        assert rank["bandwidth"] == pytest.approx(want_bw, abs=0)
        # the evaluated confusion matrix is the gathered class maps'
        np.testing.assert_array_equal(rank["hist"], whole)


def test_all_reduce_max_over_gloo_ranks(ranks):
    want = torch.maximum(_seeded(20, 3, 5), _seeded(21, 3, 5))
    for rank in ranks:
        assert torch.equal(rank["max"], want)


def test_cli_ring_int8_runs_on_cpu_ranks(tmp_path):
    """``test --agent_parallel 2 --int8`` (3 agents a rank) on a 64x64
    6-agent fixture: rank 0 prints the tables and the bandwidth."""
    root = str(tmp_path / "data")
    generate_fixture(root, target_view="6agent", img_size=IMG, frames_per_traj=2)
    cfg = {"model": {"arch": "MIMOcom", "agent_num": 6, "shared_img_encoder": "unified",
                     "query_size": 8, "key_size": 64, "multiple_output": True},
           "data": {"dataset": "airsim", "train_split": "train", "val_split": "val",
                    "test_split": "test", "img_rows": IMG, "img_cols": IMG, "path": root,
                    "target_view": "6agent", "commun_label": "mimo"},
           "training": {"batch_size": 2, "n_workers": 1, "calib_batches": 1,
                        "optimizer": {"name": "adam", "lr": 1e-4},
                        "loss": {"name": "cross_entropy", "size_average": True}}}
    yml = tmp_path / "ring.yml"
    yml.write_text(yaml.safe_dump(cfg))
    from multiagentperception_tpu_torch.config import normalize_config

    model = init_weights(get_model(normalize_config(cfg), 11), 0)
    torch.save({"model_state": model.state_dict()}, tmp_path / "model.pkl")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "multiagentperception_tpu_torch.test", "--config", str(yml),
             "--model_path", str(tmp_path / "model.pkl"), "--device", "cpu",
             "--agent_parallel", "2", "--int8"], capture_output=True, text=True, timeout=120,
            cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    finally:
        (tmp_path / "model.pkl").unlink()
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert "data 1 x agent 2" in out
    lines = out.splitlines()
    for line in ("Normal", "Noise", "Overall"):
        assert lines.count(line) == 1, line  # rank 0 alone prints
    assert sum(x.startswith("Bandwidth: ") for x in lines) == 1
