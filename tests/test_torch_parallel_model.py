"""The mesh's ``model`` axis (tensor parallel over output channels,
``parallel.tensor``) against the JAX package's ``make_mesh`` /
``param_shardings``, on the CPU.

- The rule, with no ranks: the set of parameters the port shards and the
  dim of each equal what JAX's ``param_shardings`` shards on
  ``make_mesh(n_data, M)`` for M = 2 and 4, for all seven architectures
  (and MIMOcom with the SegNet pair, whose decoder holds the transposed
  convs), names matched through ``compat.torch_export``'s name map (128x128,
  the smallest side it maps).
- Shards: a one-process ``state_dict`` cut into M shards and put back
  together is the same, bit for bit; so are Adam's moments; a sharded
  model's seeded init is the one-process init's shard; a shard's int8
  weight and scales are the slice of the whole weight's, exactly.
- The refusals: M not dividing the world, and an agent ring with a model
  axis (no JAX mesh has both).
- A 2 x 2 grid of gloo ranks (tests/torch_parallel_helpers.py ``grid_run``)
  against JAX's Trainer on ``make_mesh(2, 2)``, both in float64 (the JAX
  BatchNorm, loss and attention lifted from their float32 casts, as
  tests/test_torch_parallel_train.py's ``test_dp_train_matches_jax_mesh``
  does, with its bounds and its labels that ignore half of one data rank's
  pixels): both losses within relative 1e-5; the first step's gradients
  and each step's update within relative L2 1e-5 a tensor, BatchNorm
  statistics within 1e-5, the gradients that are 0 in exact arithmetic
  below 1e-12 and their updates below lr / 1000; the ``activated`` eval's
  confusion matrix and bandwidth (from the starting weights, whose graph
  prunes some links) equal.
- The grid's ``.pkl`` (rank 0's, the shards and their moments gathered)
  loads with ``strict=True`` into one process's model; resuming from it
  and taking step 2 again gives the uninterrupted state, bit for bit.
- The grid's int8 eval against one process's: scales within relative
  1e-5, class maps on at least 99.5% of pixels (tests/test_torch_int8_eval.py's
  static rule), the bandwidth equal, 48 int8 convs a forward on each rank.
- ``python -m multiagentperception_tpu_torch.dryrun_multichip --ranks 4
  --device cpu --img 64`` passes.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_parts import _jax_float64
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import jax_kwargs, raw_cfg

from multiagentperception_tpu.compat.torch_export import export_torch_state_dict
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.loss import get_loss_function as jax_get_loss
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.optimizers import get_optimizer as jax_get_optimizer
from multiagentperception_tpu.parallel import make_mesh
from multiagentperception_tpu.parallel.mesh import param_shardings
from multiagentperception_tpu.trainer import Trainer as JaxTrainer
from multiagentperception_tpu.trainer import TrainState
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.models import get_model, init_weights
from multiagentperception_tpu_torch.ops.kernels.int8_conv import prepare_weight
from multiagentperception_tpu_torch.parallel import init_distributed, model_parallel_ranks, tensor
from multiagentperception_tpu_torch.parallel.collectives import Group
from torch_parallel_helpers import (
    IMG,
    ROOT,
    _int8_eval,
    start_ranks,
    toy_cfg,
)

AGENTS, BATCH, LR = 2, 4, 1e-4
STATS = ("running_mean", "running_var")
ARCHS = ("Single_agent", "All_agents", "MIMO_All_agents", "LearnWho2Com", "LearnWhen2Com",
         "MIMOcom", "MIMOcomWho")
SEGNET = {"enc_backbone": "n_segnet_encoder", "dec_backbone": "n_segnet_decoder"}
CLASS_AGREEMENT = 0.995
CPU = torch.device("cpu")


# ------------------------------------------------------------------ the rule

def _marked(shardings, shapes):
    """Each parameter as an array of its shape: 0 where JAX replicates it,
    else 1 + the index along its last (sharded) dim."""
    def mark(s, leaf):
        if s.spec == jax.sharding.PartitionSpec():
            return np.zeros(leaf.shape, np.float32)
        return np.broadcast_to(np.arange(leaf.shape[-1], dtype=np.float32) + 1,
                               leaf.shape).copy()
    return jax.tree_util.tree_map(mark, shardings, shapes)


def _sharded_dims(sd: dict) -> dict:
    """{torch name: the dim the marks run along} of the marked parameters."""
    out = {}
    for name, v in sd.items():
        v = np.asarray(v)
        if not v.any():
            continue
        out[name] = [d for d in range(v.ndim) if v.shape[d] > 1 and np.array_equal(
            v, np.broadcast_to((np.arange(v.shape[d]) + 1).reshape(
                [-1 if i == d else 1 for i in range(v.ndim)]), v.shape))]
    return out


def jax_rule(raw: dict, shapes, n_model: int, export) -> dict:
    """{port parameter name: [dim]} JAX's ``param_shardings`` shards on a
    ``make_mesh(8 // M, M)``."""
    mesh = make_mesh(8 // n_model, n_model, jax.devices()[:8])
    params = _marked(param_shardings(mesh, shapes["params"]), shapes["params"])
    stats = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes.get("batch_stats", {}))
    return _sharded_dims(export(raw, {"params": params, "batch_stats": stats}))


def port_rule(model, n_model: int) -> dict:
    return {f"{name}.weight": [dim] for name, mod in model.named_modules()
            if (dim := tensor.shard_rule(mod, n_model)) is not None}


@functools.lru_cache(maxsize=None)
def _case(case: str):
    arch, _, variant = case.partition("-")
    rule_img = 128
    raw = raw_cfg(arch, 5 if arch == "All_agents" else 2, (rule_img, rule_img),
                  **(SEGNET if variant == "segnet" else {}))
    x = np.zeros((1, raw["model"]["agent_num"], rule_img, rule_img, 3), np.float32)
    if arch == "Single_agent":
        x = x.reshape((-1,) + x.shape[2:])
    jm = jax_get_model(jax_normalize_config(raw), 11)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)}, jnp.asarray(x),
        **jax_kwargs(raw, False)))
    with torch.device("meta"):  # the rule reads types and shapes alone
        return raw, shapes, get_model(normalize_config(raw), 11)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("case", ARCHS + ("MIMOcom-segnet",))
def test_shard_rule_matches_jax_param_shardings(case, n_model):
    raw, shapes, model = _case(case)
    want = jax_rule(raw, shapes, n_model,
                    lambda raw, v: export_torch_state_dict(jax_normalize_config(raw), v))
    got = port_rule(model, n_model)
    assert got == want
    assert len(got) > 10
    if case.endswith("segnet"):  # a transposed conv shards its dim 1
        assert [1] in got.values()


# ------------------------------------------------------------------ shards, no ranks

def _fake_shards(cfg: dict, n_model: int) -> list:
    """One model a rank of a model group of ``n_model`` (no process group:
    ``parallelize`` reads the group's size and rank alone)."""
    models = []
    for r in range(n_model):
        model = get_model(cfg, 11)
        tensor.parallelize(model, Group(tuple(range(n_model)), r, "gloo", CPU))
        models.append(model)
    return models


@pytest.fixture(scope="module")
def full_and_shards():
    cfg = toy_cfg(AGENTS)
    full = init_weights(get_model(cfg, 11), 3)
    return cfg, full, _fake_shards(cfg, 2)


def test_shards_round_trip_exactly(full_and_shards):
    cfg, full, shards = full_and_shards
    sd = full.state_dict()
    parts = []
    for model in shards:
        part = tensor.shard_state_dict(sd, model)
        model.load_state_dict(part, strict=True)
        parts.append(part)
    layers = tensor.sharded(shards[0])
    assert len(layers) > 40
    for name, v in sd.items():
        if name in layers:
            got = torch.cat([p[name] for p in parts], layers[name].shard_dim)
        else:
            got = parts[1][name]
        assert torch.equal(got, v), name
    # Adam's moments alike
    opt = torch.optim.Adam(full.parameters())
    for p in full.parameters():
        opt.state[p] = {"step": torch.tensor(2.0), "exp_avg": torch.randn_like(p),
                        "exp_avg_sq": torch.rand_like(p)}
    whole = opt.state_dict()
    cut = [tensor.shard_optimizer_state(whole, torch.optim.Adam(m.parameters()), m)
           for m in shards]
    names = [n for n, _ in full.named_parameters()]
    for i, name in enumerate(names):
        for key in ("exp_avg", "exp_avg_sq"):
            got = (torch.cat([c["state"][i][key] for c in cut], layers[name].shard_dim)
                   if name in layers else cut[0]["state"][i][key])
            assert torch.equal(got, whole["state"][i][key]), (name, key)


def test_seeded_init_of_a_shard_is_the_one_process_shard(full_and_shards):
    cfg, full, shards = full_and_shards
    want = init_weights(get_model(cfg, 11), 7).state_dict()
    for model in shards:
        got = init_weights(model, 7).state_dict()
        for name, v in tensor.shard_state_dict(want, model).items():
            assert torch.equal(got[name], v), name


def test_int8_weight_of_a_shard_is_a_slice(full_and_shards):
    _, full, shards = full_and_shards
    whole = dict(full.named_modules())
    checked = 0
    for r, model in enumerate(shards):
        model.load_state_dict(tensor.shard_state_dict(full.state_dict(), model))
        for name, mod in model.named_modules():
            if isinstance(mod, tensor.ColumnConv2d):
                part, ref = prepare_weight(mod.weight), prepare_weight(whole[name].weight)
                rows = slice(r * mod.local_out, (r + 1) * mod.local_out)
                assert torch.equal(part.s_w, ref.s_w[rows]), name
                assert torch.equal(part.w_i8, ref.w_i8[rows]), name
                checked += 1
    assert checked > 80


def test_refusals_as_jax(tmp_path):
    with pytest.raises(ValueError):
        make_mesh(None, 3, jax.devices()[:4])
    with pytest.raises(ValueError, match="does not divide the world"):
        model_parallel_ranks(4, 3)
    with pytest.raises(ValueError, match="does not divide the world"):
        init_distributed(rank=0, world=4, init_method=f"file://{tmp_path / 'rdv'}",
                         device="cpu", model=3)
    with pytest.raises(ValueError, match="no mesh has both"):
        model_parallel_ranks(4, 2, agent=2)
    with pytest.raises(ValueError, match="no mesh has both"):
        init_distributed(rank=0, world=4, init_method=f"file://{tmp_path / 'rdv'}",
                         device="cpu", agent=2, model=2)
    assert model_parallel_ranks(8, 2) == 2 and model_parallel_ranks(3, 1) == 1


# ------------------------------------------------------------------ the 2 x 2 grid

def _raw(batch: int = BATCH) -> dict:
    return {"model": {"arch": "MIMOcom", "agent_num": AGENTS, "query_size": 8,
                      "key_size": 64, "multiple_output": True},
            "data": {"img_rows": IMG, "img_cols": IMG, "commun_label": "mimo"},
            "training": {"batch_size": batch, "optimizer": {"name": "adam", "lr": LR},
                         "loss": {"name": "cross_entropy", "size_average": True}}}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """JAX-initialized weights (a peaked graph), 2 global train batches of
    4 whose ignored pixels fall on one data rank's rows, one eval batch of
    4 with ``commun_label``, 2 calibration batches."""
    work = tmp_path_factory.mktemp("grid")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        images = (rng.standard_normal((BATCH, AGENTS, IMG, IMG, 3)) * 0.5).astype(np.float32)
        labels = rng.integers(0, 11, (BATCH, AGENTS, IMG, IMG)).astype(np.int32)
        labels[:BATCH // 2, :, :IMG // 2] = 250
        batches.append((images, labels))
    images = (rng.standard_normal((BATCH, AGENTS, IMG, IMG, 3)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 11, (BATCH, AGENTS, IMG, IMG)).astype(np.int32)
    cl = np.stack([rng.integers(0, 2, (BATCH, AGENTS)), rng.integers(0, AGENTS, (BATCH, AGENTS))],
                  axis=1).astype(np.int64)
    calib = [((rng.standard_normal((2, AGENTS, IMG, IMG, 3)) * 0.5).astype(np.float32),)
             for _ in range(2)]
    jcfg = jax_normalize_config(_raw())
    variables = jax_get_model(jcfg, 11).init(jax.random.PRNGKey(0),
                                             jnp.asarray(batches[0][0]), train=True,
                                             mo_flag=True, inference="softmax")
    variables = jax.tree_util.tree_map(np.asarray, variables)
    proj = variables["params"]["MIMOGeneralDotAttention_0"]["proj"]
    proj["kernel"] = proj["kernel"] * 40.0  # `activated` prunes some links
    torch.save(state_dict_from_flax(toy_cfg(AGENTS, BATCH), variables), work / "state.pt")
    torch.save(batches, work / "batches.pt")
    torch.save({"eval": [(images, labels, cl)], "calib": calib}, work / "data.pt")
    yield work, jcfg, variables, batches, (images, labels, cl), calib
    shutil.rmtree(work)


@pytest.fixture(scope="module", autouse=True)
def launched(shared):
    """The grid's 4 ranks and the dry run's subprocess, started at once
    when the module starts: the tests with no ranks and JAX's run go on
    meanwhile."""
    work = shared[0]
    wait = start_ranks("grid_run", 4, work, timeout=300, model=2, agents=AGENTS, batch=BATCH,
                       state=str(work / "state.pt"), batches=str(work / "batches.pt"),
                       data=str(work / "data.pt"))
    dryrun = subprocess.Popen(
        [sys.executable, "-m", "multiagentperception_tpu_torch.dryrun_multichip",
         "--ranks", "4", "--device", "cpu", "--img", str(IMG)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    try:
        yield wait, dryrun
    finally:
        for proc in [dryrun, *wait.procs]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def grid(launched):
    ranks = launched[0]()
    yield ranks
    if os.path.exists(ranks[0]["ckpt"]):
        os.unlink(ranks[0]["ckpt"])  # ~0.8 GB: float64 weights and Adam's moments


@pytest.fixture(scope="module")
def jax_grid(shared):
    """The ``activated`` eval step with the loss, then 2 steps of the JAX
    Trainer's jitted step on ``make_mesh(2, 2)`` in float64 and the first
    step's gradients jit takes on that mesh."""
    _, jcfg, variables, batches, (images, labels, cl), _ = shared

    def to_sd(params, stats):
        return state_dict_from_flax(toy_cfg(AGENTS, BATCH), jax.tree_util.tree_map(
            np.asarray, {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}))

    with _jax_float64():
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        tx = jax_get_optimizer(jcfg)
        model, loss_fn = jax_get_model(jcfg, 11), jax_get_loss(jcfg)
        mesh = make_mesh(2, 2, jax.devices()[:4])
        trainer = JaxTrainer(jcfg, None, logging.getLogger("test"), model, loss_fn, None, None,
                             tx, mesh=mesh)
        state = trainer._place_state(TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params), rng=jax.random.PRNGKey(2)))
        kw = trainer._apply_kwargs(True)
        sharded = [leaf for leaf in jax.tree_util.tree_leaves(state.params)
                   if len(leaf.sharding.device_set) == 4 and not leaf.sharding.is_fully_replicated]
        assert sharded  # the params lie over the model axis

        def first_loss(p, x, y):
            out, _ = model.apply({"params": p, "batch_stats": stats}, x,
                                 mutable=["batch_stats"], **kw)
            return loss_fn(input=out[0], target=y)

        x, y = trainer._put_batch(images.astype(np.float64), trainer._labels(labels))
        res = trainer._eval_step_fn("activated", with_loss=True)(
            state, x, y, jax.random.PRNGKey(0), jnp.asarray(cl))
        ev = {"hist": np.asarray(res["hist"]), "num_connect": float(res["num_connect"])}
        step = trainer._train_step_fn()
        losses, states, grads = [], [], None
        for x_np, y_np in batches:
            x, y = trainer._put_batch(x_np.astype(np.float64), trainer._labels(y_np))
            if grads is None:
                grads = to_sd(jax.jit(jax.grad(first_loss))(state.params, x, y), stats)
            state, loss = step(state, x, y)
            losses.append(float(loss))
            states.append(to_sd(state.params, state.batch_stats))
    return losses, grads, states, ev


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def test_grid_shards_what_jax_shards(grid, shared):
    _, jcfg, variables, _, _, _ = shared
    shapes = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), variables)
    want = jax_rule(_raw(), shapes, 2, lambda raw, v: state_dict_from_flax(
        toy_cfg(AGENTS, BATCH), v))
    assert grid[0]["shards"] == sorted(want) and len(want) > 40


def test_grid_train_matches_jax_mesh(grid, shared, jax_grid):
    losses, grads, states, _ = jax_grid
    start = state_dict_from_flax(toy_cfg(AGENTS, BATCH), shared[2])
    zero = {"key_net.fc.4.bias"} | {n for n in grads if n.endswith("cbr_unit.0.bias")}
    for rank in grid:
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-5)
    got = grid[0]
    assert len(got["grads"]) > 150
    for name, g in got["grads"].items():
        if name in zero:
            assert max(float(g.norm()), float(torch.as_tensor(grads[name]).norm())) < 1e-12, name
        else:
            assert _rel(g, grads[name]) <= 1e-5, f"{name}: gradient {_rel(g, grads[name]):.2e}"
    for k, want in enumerate(states):
        for name, v in want.items():
            mine = got["states"][k][name]
            if name.endswith(STATS):
                np.testing.assert_allclose(mine.numpy(), v.numpy(), rtol=1e-5, atol=1e-12,
                                           err_msg=f"{name} after step {k + 1}")
            elif mine.is_floating_point():
                moved, want_moved = mine.double() - start[name].double(), v - start[name].double()
                if name in zero:
                    assert float(moved.abs().max()) < 1e-3 * LR, name
                    continue
                err = _rel(moved, want_moved)
                assert err <= 1e-5, f"{name}: update after step {k + 1} {err:.2e}"


def test_grid_checkpoint_loads_in_one_process_and_resumes(grid):
    got = grid[0]
    blob = torch.load(got["ckpt"], weights_only=True)
    one = get_model(toy_cfg(AGENTS, BATCH), 11)
    one.load_state_dict(blob["model_state"], strict=True)
    for name, v in got["states"][0].items():
        assert torch.equal(blob["model_state"][name], v), name
    shapes = [tuple(p.shape) for p in one.parameters()]
    for i, st in blob["optimizer_state"]["state"].items():
        assert tuple(st["exp_avg"].shape) == shapes[i] == tuple(st["exp_avg_sq"].shape)
    for name, v in got["states"][1].items():
        assert torch.equal(got["resumed"][name], v), name


def test_grid_eval_matches_jax_mesh(grid, jax_grid):
    want = jax_grid[3]
    assert 0.0 < want["num_connect"] < AGENTS - 1
    for rank in grid:
        np.testing.assert_array_equal(rank["eval"]["hist"], want["hist"])
        assert rank["eval"]["bandwidth"] == pytest.approx(want["num_connect"], abs=1e-7)


def test_grid_int8_matches_one_process(grid, shared):
    work, _, _, _, (images, labels, cl), calib = shared
    ev = Evaluator(toy_cfg(AGENTS, BATCH), device="cpu")
    ev.load_weight(str(work / "state.pt"))
    want = _int8_eval(ev, calib, [(images, labels, cl)], "activated")
    for rank in grid:
        got = rank["int8"]
        assert got["calls"] == want["calls"] == 48
        assert set(got["scales"]) == set(want["scales"])
        for name, s in want["scales"].items():
            assert got["scales"][name] == pytest.approx(s, rel=1e-5), name
        agree = (got["maps"] == want["maps"]).double().mean().item()
        assert agree >= CLASS_AGREEMENT, agree
        assert got["bandwidth"] == want["bandwidth"]
        pixels = want["hist"].sum()
        assert got["hist"].sum() == pixels
        assert np.abs(got["hist"] - want["hist"]).sum() / 2 <= (1 - CLASS_AGREEMENT) * pixels


def test_dryrun_multichip_on_cpu_ranks(launched):
    """``dryrun_multichip --ranks 4 --device cpu --img 64`` (started with
    the module): the grid, the ring and the combined mesh pass."""
    proc = launched[1]
    stdout, stderr = proc.communicate(timeout=240)
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    result = json.loads(stdout.strip().splitlines()[-1])
    assert result["ok"]
    assert result["grid"]["layout"] == {"data": 2, "model": 2, "agent": 1, "backend": "gloo"}
    assert result["ring"]["layout"]["agent"] == 4
    assert result["combined"]["layout"]["data"] == 2
    assert result["grid"]["hist_moved"] < 1e-3
    assert result["grid"]["steps_per_call"] == {"steps": 3}  # CPU ranks: no refusal
