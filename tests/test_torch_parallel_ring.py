"""The port's parallel package against the JAX package's: the rank-count
policies (parallel/mesh.py), the agent ring (parallel/ring.py) and MIMOcom
through it, on gloo ranks on the CPU (tests/torch_parallel_helpers.py;
a ``file://`` rendezvous in ``tmp_path``, a timeout per run).

Tolerances, and why:

- ``sharded_comm_step`` against JAX's on virtual meshes of 2 and 3
  devices: fused, coef and soft within 1e-5 (float32; the same arithmetic,
  the fusion summed shard by shard in both).
- Its gradients against the dense step's autograd in the port: 1e-5.
- MIMOcom with a ring of 2 against JAX's ``agent_mesh`` model of 2
  devices, end to end: the graphs within 2e-4 relative / 1e-6 (the towers
  run on 2 agents per rank, so their convolutions reassociate; JAX's own
  ring test allows the same), the decoder's logits 1e-4, actions and
  bandwidth equal.
- Ring training (``agent_parallel_train``) against the port's dense step
  in float64: loss, gradients (relative L2 per tensor) and BatchNorm
  statistics within 1e-9. In float32 they differ by up to ~7e-3 in the
  policy tower's first conv, since the ring's BatchNorm takes E[x²] - E[x]²
  (JAX's form) where the dense step's torch BatchNorm takes a two-pass
  variance, and chains of training-mode BatchNorms amplify it. The float32
  ring against JAX's dense step: loss 1e-5, gradients within
  tests/test_torch_train.py's float32 bounds (relative L2 3e-2, cosine
  0.9995; that file's docstring says why no tighter), BatchNorm
  statistics 1e-4.
- A ring that trains dense (no ``agent_parallel_train``): with equal
  inputs each replica's two Adam steps equal one process's, bit for bit
  (2 equal gradients average to themselves); with each rank's
  frames shifted by 1e-3 times its rank, a stand-in for a card whose
  arithmetic differs from run to run, the replicas' parameters, buffers
  and Adam moments stay equal, bit for bit.
"""

from __future__ import annotations

import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.loss import cross_entropy2d as jax_cross_entropy2d
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.parallel import agent_parallel_mesh, data_parallel_mesh
from multiagentperception_tpu.parallel.ring import sharded_comm_step as jax_sharded_comm_step
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.loss import cross_entropy2d, get_loss_function
from multiagentperception_tpu_torch.models import get_model
from multiagentperception_tpu_torch.ops.kernels.comm_fusion import comm_fusion_plain
from multiagentperception_tpu_torch.parallel import agent_parallel_ranks, data_parallel_ranks
from multiagentperception_tpu_torch.trainer import Trainer
from torch_parallel_helpers import IMG, fake_layout, run_ranks, toy_cfg

MODES = ("softmax", "activated", "argmax")
EVAL_MODES = ("softmax", "activated", "argmax_test")
B, N, D, HW, C = 2, 6, 8, 4, 8  # the comm step's shapes: 6 agents divide over 2 and 3
AGENTS = 4  # MIMOcom's agents over a ring of 2
PROJ_SCALE = 8.0  # a graph with links above the activated threshold


# ------------------------------------------------------------------ the policies

@pytest.mark.parametrize("batch,n", [(8, 0), (6, 0), (7, 0), (5, 0), (4, 2), (4, 1), (4, 3),
                                     (16, 16), (8, 8)])
def test_data_parallel_policy_matches_jax(batch, n, caplog):
    """Counts, warnings and errors of ``data_parallel_mesh`` on conftest's 8
    virtual devices."""
    available = len(jax.devices())
    try:
        mesh = data_parallel_mesh(batch, n)
    except ValueError:
        with pytest.raises(ValueError):
            data_parallel_ranks(batch, n, available)
        return
    jax_warned = "using" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        ranks = data_parallel_ranks(batch, n, available)
    assert ranks == (1 if mesh is None else mesh.shape["data"])
    assert ("using" in caplog.text) == jax_warned


@pytest.mark.parametrize("agents,n_agent,n_data,batch", [
    (4, 0, 0, 2), (4, 2, 0, 2), (6, 3, 2, 4), (4, 3, 0, 2), (4, 2, 3, 5), (4, 4, 4, 4),
    (8, 8, 1, 2), (4, 2, 2, 4)])
def test_agent_parallel_policy_matches_jax(agents, n_agent, n_data, batch):
    cfg = {"model": {"arch": "MIMOcom", "agent_num": agents},
           "training": {"batch_size": batch}}
    available = len(jax.devices())
    try:
        mesh = agent_parallel_mesh(cfg, n_agent, n_data=n_data)
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            agent_parallel_ranks(cfg, n_agent, n_data, available)
        assert str(ours.value).split()[0] == str(err).split()[0]
        return
    assert agent_parallel_ranks(cfg, n_agent, n_data, available) == (
        1 if mesh is None else mesh.shape["agent"])


def test_ring_raises_as_jax():
    """JAX models/__init__.py:102-127 and tests/test_ring.py:184-207."""
    cfg = toy_cfg(AGENTS)
    cfg["model"]["agent_parallel_train"] = True
    with pytest.raises(ValueError, match="agent_parallel_train"):
        get_model(cfg, 11)
    cfg = toy_cfg(AGENTS)
    cfg["model"]["pallas_comm"] = True
    with pytest.raises(ValueError, match="mutually exclusive"):
        get_model(cfg, 11, fake_layout())
    cfg = toy_cfg(AGENTS)
    cfg["model"]["arch"] = "MIMOcomWho"
    with pytest.raises(ValueError, match="MIMOcom feature"):
        get_model(cfg, 11, fake_layout())
    with pytest.raises(ValueError, match="not divisible"):
        agent_parallel_ranks({"model": {"arch": "MIMOcom", "agent_num": 4, "agent_parallel": 2},
                              "training": {"batch_size": 5}}, n_data=3, available=8)


# ------------------------------------------------------------------ the comm step

def _dense_comm(q, k, v, mode):
    """The dense step with MIMOcom's semantics (tests/test_ring.py): the
    masked modes fuse the biased, masked graph; softmax fuses unbiased and
    reports the biased one."""
    fused, _, _ = comm_fusion_plain(q, k, v, mode=mode,
                                    diag_bias=0.0 if mode == "softmax" else 0.001)
    _, coef, soft = comm_fusion_plain(q, k, v, mode=mode, diag_bias=0.001)
    return fused, coef, soft


@pytest.fixture(scope="module", params=[2, 3], ids=["ring2", "ring3"])
def comm_runs(request, tmp_path_factory):
    world = request.param
    out = run_ranks("comm_step", world, tmp_path_factory.mktemp(f"comm{world}"),
                    agent=world, b=B, n=N, d=D, hw=HW, c=C, modes=list(MODES))
    return world, out


def _seeded(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _cat(out, mode, key, dim):
    return torch.cat([r[mode][key] for r in out], dim=dim).numpy()


@pytest.mark.parametrize("mode", MODES)
def test_sharded_comm_step_matches_jax(comm_runs, mode):
    world, out = comm_runs
    q, k, v = _seeded(0, B, N, D), _seeded(1, B, N, D), _seeded(2, B, N, C, HW, HW)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("agent",))
    # JAX's values are NHWC per agent; the port's NCHW
    v_jax = jnp.asarray(v.permute(0, 1, 3, 4, 2).numpy())
    fused, coef, soft = jax_sharded_comm_step(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                              v_jax, mesh, mode=mode, diag_bias=0.001)
    ours_fused = np.transpose(_cat(out, mode, "fused", 1), (0, 1, 3, 4, 2))
    np.testing.assert_allclose(ours_fused, np.asarray(fused), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_cat(out, mode, "coef", 2), np.asarray(coef), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_cat(out, mode, "soft", 2), np.asarray(soft), rtol=1e-5,
                               atol=1e-6)
    # and the port's dense step
    dense = _dense_comm(q, k, v, mode)
    np.testing.assert_allclose(_cat(out, mode, "fused", 1), dense[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(_cat(out, mode, "coef", 2), dense[1].numpy(), atol=1e-6)


def test_ring_gradients_match_dense(comm_runs):
    """The fusion's reverse ring (dV), its transpose (the graph's gradient)
    and the keys' reduce-scatter against autograd through the dense step."""
    world, out = comm_runs
    q, k, v = (_seeded(s, *shape).requires_grad_(True)
               for s, shape in ((0, (B, N, D)), (1, (B, N, D)), (2, (B, N, C, HW, HW))))
    fused, coef, _ = _dense_comm(q, k, v, "softmax")
    share = N // world
    w_f = torch.cat([_seeded(3, B, share, C, HW, HW)] * world, dim=1)
    w_c = _seeded(4, B, N, N)
    ((fused * w_f).sum() + (coef * w_c).sum()).backward()
    for name, dense in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        np.testing.assert_allclose(_cat(out, "softmax", name, 1), dense.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


# ------------------------------------------------------------------ MIMOcom through the ring

@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1, AGENTS, IMG, IMG, 3)) * 0.5).astype(np.float32)
    jcfg = jax_normalize_config({"model": {"arch": "MIMOcom", "agent_num": AGENTS,
                                           "query_size": 8, "key_size": 64,
                                           "multiple_output": True},
                                 "data": {"img_rows": IMG, "img_cols": IMG}})
    variables = jax_get_model(jcfg, 11).init(jax.random.PRNGKey(0), jnp.asarray(x),
                                             train=False, mo_flag=True, inference="softmax")
    variables = jax.tree_util.tree_map(np.asarray, variables)
    proj = variables["params"]["MIMOGeneralDotAttention_0"]["proj"]
    proj["kernel"] = proj["kernel"] * PROJ_SCALE
    labels = rng.integers(0, 11, (AGENTS, IMG, IMG)).astype(np.int64)
    labels[:, :8] = 250  # ignored pixels in every agent's top rows
    return jcfg, x, variables, labels


@pytest.fixture(scope="module")
def port_files(shared, tmp_path_factory):
    jcfg, x, variables, labels = shared
    work = tmp_path_factory.mktemp("mimocom_ring")
    torch.save(state_dict_from_flax(toy_cfg(AGENTS), variables), work / "state.pt")
    torch.save(torch.from_numpy(x), work / "x.pt")
    torch.save(torch.from_numpy(labels), work / "y.pt")
    yield work
    shutil.rmtree(work)


@pytest.fixture(scope="module")
def ring_eval(port_files):
    return run_ranks("mimocom_ring", 2, port_files, agent=2, agents=AGENTS,
                     state=str(port_files / "state.pt"), frames=str(port_files / "x.pt"),
                     modes=list(EVAL_MODES))


def test_sync_bn_and_ring_add_no_state_dict_key(ring_eval, shared):
    """Every rank loaded JAX's weights through the bridge with strict=True,
    and the ring model's keys are the dense model's."""
    dense = sorted(get_model(toy_cfg(AGENTS), 11).state_dict())
    for rank in ring_eval:
        assert rank["keys"] == dense


@pytest.mark.parametrize("mode", EVAL_MODES)
def test_mimocom_ring_matches_jax_agent_mesh(ring_eval, shared, mode):
    jcfg, x, variables, _ = shared
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("agent",))
    ringed = jax_get_model(jcfg, 11, agent_mesh=mesh)
    want = ringed.apply(variables, jnp.asarray(x), train=False, mo_flag=True, inference=mode)
    # each rank predicts its 2 agents: (B*2, 11, H, W) -> agents in order
    pred = np.concatenate([r[mode]["pred"].numpy() for r in ring_eval], axis=0)
    np.testing.assert_allclose(np.transpose(pred, (0, 2, 3, 1)), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    for rank in ring_eval:
        np.testing.assert_allclose(rank[mode]["prob"].numpy(), np.asarray(want[1]),
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_array_equal(rank[mode]["action"].numpy(), np.asarray(want[2]))
        assert float(rank[mode]["num_connect"]) == float(np.float32(want[3]))
    if mode == "activated":  # the graph keeps some links and prunes others
        assert 0.0 < float(ring_eval[0][mode]["num_connect"]) < AGENTS - 1


def _grad_checks(grads: dict, want: dict, rel_max: float, cos_min: float = -1.0) -> None:
    zero = {"key_net.fc.4.bias"} | {n for n in grads if n.endswith("cbr_unit.0.bias")}
    for name, g in grads.items():
        g, w = g.double(), torch.as_tensor(want[name]).double()
        if name in zero:  # a gradient of 0 (tests/test_torch_train.py)
            assert max(g.norm(), w.norm()) < 1e-4, name
            continue
        rel = float((g - w).norm() / w.norm())
        cos = float(torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0))
        assert rel <= rel_max and cos >= cos_min, f"{name}: relative L2 {rel:.2e}, cos {cos:.6f}"


def test_ring_training_equivalence(shared, port_files):
    """``agent_parallel_train``: the loss and every gradient of a train
    forward through the ring against the port's dense step (float64) and
    JAX's dense step (float32)."""
    jcfg, x, variables, labels = shared
    kw = dict(agent=2, agents=AGENTS, state=str(port_files / "state.pt"),
              frames=str(port_files / "x.pt"), labels=str(port_files / "y.pt"))
    ring64 = run_ranks("ring_train", 2, port_files / "f64", dtype="float64", **kw)
    ring32 = run_ranks("ring_train", 2, port_files / "f32", dtype="float32", **kw)
    dense = get_model(toy_cfg(AGENTS), 11)
    dense.load_state_dict(torch.load(port_files / "state.pt", weights_only=True), strict=True)
    dense.double().train()
    loss = cross_entropy2d(dense(torch.from_numpy(x).double(), inference="softmax")[0],
                           torch.from_numpy(labels))
    loss.backward()
    dense_grads = {n: p.grad for n, p in dense.named_parameters()}
    model = jax_get_model(jcfg, 11)

    def jax_loss(p):
        out, upd = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True, mo_flag=True, inference="softmax",
                               mutable=["batch_stats"])
        return jax_cross_entropy2d(out[0], jnp.asarray(labels)), upd["batch_stats"]

    (jloss, jstats), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(variables["params"])
    to_sd = lambda p, s: state_dict_from_flax(toy_cfg(AGENTS), jax.tree_util.tree_map(  # noqa: E731
        np.asarray, {"params": p, "batch_stats": s}))
    jgrads, jstats = to_sd(jgrads, variables["batch_stats"]), to_sd(variables["params"], jstats)
    for r64, r32 in zip(ring64, ring32):
        np.testing.assert_allclose(float(r64["loss"]), float(loss.detach()), rtol=1e-9)
        _grad_checks(r64["grads"], dense_grads, 1e-9)
        for name, v in r64["stats"].items():
            np.testing.assert_allclose(v.numpy(), dense.state_dict()[name].numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=name)
        np.testing.assert_allclose(float(r32["loss"]), float(jloss), rtol=1e-5)
        _grad_checks(r32["grads"], jgrads, 3e-2, 0.9995)
        for name, v in r32["stats"].items():
            np.testing.assert_allclose(v.numpy(), jstats[name].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("jitter", [0.0, 1e-3], ids=["equal_inputs", "rank_jitter"])
def test_dense_ring_replicas_stay_equal(port_files, jitter):
    """``model.agent_parallel`` without ``agent_parallel_train``: every rank
    runs the whole train step, and the ring keeps its replicas equal
    (module docstring), so the ring's eval and rank 0's checkpoint hold one
    model."""
    kw = dict(agent=2, agents=AGENTS, state=str(port_files / "state.pt"),
              frames=str(port_files / "x.pt"), labels=str(port_files / "y.pt"), steps=2)
    ranks = run_ranks("ring_replicas", 2, port_files / f"replicas{jitter}", jitter=jitter, **kw)
    for rank in ranks:
        assert rank["gap_to_rank0"] == {"state": 0.0, "moments": 0.0}
    if jitter:
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the CPU's sums then associate alike
    try:
        cfg = toy_cfg(AGENTS, 1)
        trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device="cpu")
        trainer.model.load_state_dict(torch.load(port_files / "state.pt", weights_only=True),
                                      strict=True)
        x = torch.load(port_files / "x.pt", weights_only=True).numpy()
        y = torch.load(port_files / "y.pt", weights_only=True).numpy().reshape(
            (1, AGENTS, IMG, IMG))
        for _ in range(2):
            trainer.train_step(*trainer._batch(x, y))
    finally:
        torch.set_num_threads(threads)
    for name, v in trainer.model.state_dict().items():
        assert torch.equal(ranks[0]["state"][name], v), name
