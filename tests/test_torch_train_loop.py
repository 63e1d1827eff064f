"""The port's training loop against the JAX package's, on shared weights
(CPU): MIMOcom with 3 agents at 128x128, batch 2, ``query_size`` 8 and
``key_size`` 64, Adam at lr 1e-4.

- ``chunk_sizes`` equals JAX's over a grid of starts, totals, chunk sizes
  and boundaries.
- ``steps_per_call: 3`` over 6 iterations with ``val_interval: 4`` (chunks
  3, 1, 2): the port's loop against JAX's ``lax.scan`` loop on six seeded
  batches, with tests/test_torch_train.py's tolerances (the first loss
  rtol 1e-5, the others rtol 1e-3; parameters atol 2*K*lr + rtol 1e-4
  after K = 6 updates), and validation at the same iterations (4 and 6).
  The port's K = 3 run equals its own K = 1 run exactly (a chunk on the
  CPU is K eager steps).
- ``nan_guard: 2`` against ``optax.apply_if_finite(tx, 2)`` over nine
  scripted steps, finite (F) and not (X): F X F X X F X X X, the non-finite
  ones made by a loss that a marked label scales by inf. Exact: which
  updates apply (the last X is the third in a row, so it applies), the
  three counters after each step, and the schedule's count, which lags the
  step after a drop (a multi-step schedule, milestones 1 and 3); the lr the
  port set for each update is the schedule's at that count. Parameters
  after each step within the tolerances above; after the last, which
  applies non-finite gradients, the same tensors hold NaN.
  A ``.pkl`` written after step 5 and resumed gives the uninterrupted
  run's parameters and counters exactly.
"""

from __future__ import annotations

import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.loss import get_loss_function as jax_get_loss
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.optimizers import get_optimizer as jax_get_optimizer
from multiagentperception_tpu.schedulers import get_scheduler as jax_get_scheduler
from multiagentperception_tpu.trainer import Trainer as JaxTrainer
from multiagentperception_tpu.trainer import TrainState
from multiagentperception_tpu.trainer import chunk_sizes as jax_chunk_sizes
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.schedulers import get_scheduler
from multiagentperception_tpu_torch.trainer import Trainer, chunk_sizes
from test_torch_train import STATS, _make_shared, few_threads  # noqa: F401

B, N, IMG, LR = 2, 3, 128, 1e-4
MARK = 249  # a label pixel that makes its step's loss non-finite
SCHEDULE = {"name": "multi_step", "milestones": [1, 3], "gamma": 0.5}
GUARD_SEQ = "FXFXXFXXX"


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each test's checkpoints (~400 MB each) go when it ends: the test
    runner's workers share one disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("start,total,k,bounds", [
    (0, 10, 4, ()), (0, 20, 8, (5, 4)), (7, 20, 8, (5,)), (0, 6, 4, (None, 0)),
    (6, 6, 4, (3,)), (0, 6, 3, (4,)), (3, 17, 5, (6, 10)), (0, 12, 1, (5,)),
    (1, 9, 9, (2,)), (0, 7, 3, (7, 7)), (11, 40, 6, (9, None)), (0, 1, 4, (1,))])
def test_chunk_sizes_match_jax(start, total, k, bounds):
    got = list(chunk_sizes(start, total, k, *bounds))
    assert got == list(jax_chunk_sizes(start, total, k, *bounds))
    assert sum(got) == max(total - start, 0)


def _raw_cfg(**training) -> dict:
    return {
        "model": {"arch": "MIMOcom", "agent_num": N, "query_size": 8, "key_size": 64,
                  "multiple_output": True},
        "data": {"img_rows": IMG, "img_cols": IMG, "commun_label": "mimo"},
        "training": {"batch_size": B, "optimizer": {"name": "adam", "lr": LR},
                     "loss": {"name": "cross_entropy", "size_average": True},
                     "print_interval": 1, **training},
    }


@pytest.fixture(scope="module")
def shared():
    """JAX-initialized weights with seeded BatchNorm statistics and six
    seeded batches (normalized frames, labels with ignored pixels, mimo
    ``commun_label``)."""
    _, _, _, variables = _make_shared(B, N, img=IMG)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(len(GUARD_SEQ)):
        images = (rng.standard_normal((B, N, IMG, IMG, 3)) * 0.5).astype(np.float32)
        labels = rng.integers(0, 11, (B, N, IMG, IMG)).astype(np.int32)
        labels[rng.random(labels.shape) < 0.05] = 250
        cl = np.stack([rng.integers(0, 2, (B, N)), rng.integers(0, N, (B, N))], axis=1)
        batches.append((images, labels, cl))
    return variables, batches


def _port_trainer(raw, variables, batches, loss_fn=None, tmp=None, schedule=None):
    cfg = normalize_config(raw)
    trainer = Trainer(cfg, None, loss_fn or get_loss_function(cfg), batches, batches[:1],
                      schedule=schedule, device="cpu", logdir=str(tmp) if tmp else None)
    trainer.model.load_state_dict(state_dict_from_flax(cfg, variables), strict=True)
    return trainer


def _recording(loss_fn, into: list):
    def recording(**kw):
        loss = loss_fn(**kw)
        if torch.is_grad_enabled():
            into.append(float(loss.detach()))
        return loss
    return recording


def _jax_state(tx, variables):
    return TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(2))


def _to_sd(cfg, params, stats):
    return state_dict_from_flax(cfg, jax.tree_util.tree_map(
        np.asarray, {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}))


def _params_close(port_sd, jax_sd, steps: int, msg: str = "") -> None:
    for name, value in port_sd.items():
        if name.endswith(STATS + ("num_batches_tracked",)):
            continue
        np.testing.assert_allclose(value.numpy(), jax_sd[name], rtol=1e-4,
                                   atol=2 * steps * LR, err_msg=f"{name} {msg}")


SPC = dict(train_iters=6, val_interval=4, steps_per_call=3, device_prefetch=2,
           watchdog_secs=0)


def test_steps_per_call_matches_jax(shared, tmp_path, monkeypatch):
    variables, batches = shared
    batches = batches[:6]
    monkeypatch.chdir(tmp_path)

    cfg = jax_normalize_config(_raw_cfg(**SPC))
    tx = jax_get_optimizer(cfg)
    jt = JaxTrainer(cfg, None, logging.getLogger("test"), jax_get_model(cfg, 11),
                    jax_get_loss(cfg), batches, batches[:1], tx)
    jt.state = _jax_state(tx, variables)
    real, jax_losses, jax_chunks, jax_vals = jt._train_multi_step_fn(), [], [], []

    def recorded(state, xs, ys):
        state, losses = real(state, xs, ys)
        jax_losses.extend(np.asarray(losses).tolist())
        jax_chunks.append(int(xs.shape[0]))
        return state, losses

    jt._jitted["train_multi"] = recorded
    jt._save_best = lambda i, best_iou: None  # no checkpoint: not this test's subject
    jax_validate = jt._validate
    jt._validate = lambda i, meter: (jax_vals.append(i), jax_validate(i, meter))
    jt.train()

    runs = {}
    for k in (3, 1):
        losses, vals = [], []
        raw = _raw_cfg(**{**SPC, "steps_per_call": k})
        trainer = _port_trainer(raw, variables, batches,
                                _recording(get_loss_function(normalize_config(raw)), losses),
                                tmp_path / f"k{k}")
        trainer._save_ckpt = lambda name, i, best_iou: None
        port_validate = trainer._validate
        trainer._validate = lambda: (vals.append(trainer.step), port_validate())
        trainer.train()
        runs[k] = {"losses": losses, "vals": vals, "state": trainer.model.state_dict(),
                   "step": trainer.step}

    assert jax_chunks == [3, 1, 2] and jax_vals == [4, 6]
    assert runs[3]["vals"] == jax_vals and runs[3]["step"] == 6
    port = runs[3]
    np.testing.assert_allclose(port["losses"][0], jax_losses[0], rtol=1e-5)
    np.testing.assert_allclose(port["losses"], jax_losses, rtol=1e-3)
    _params_close(port["state"], _to_sd(cfg, jt.state.params, jt.state.batch_stats), 6)
    # the K = 3 loop on the CPU is K = 1's steps, exactly
    assert runs[3]["losses"] == runs[1]["losses"] and runs[1]["vals"] == [4, 6]
    for name, value in runs[1]["state"].items():
        assert torch.equal(port["state"][name], value), name


def _marked_torch(base):
    def loss_fn(input, target):
        hit = (target == MARK).any()
        clean = torch.where(target == MARK, 250, target)
        return base(input=input, target=clean) * torch.where(hit, torch.inf, 1.0)
    return loss_fn


def _marked_jax(base):
    def loss_fn(input, target):
        hit = jnp.any(target == MARK)
        clean = jnp.where(target == MARK, 250, target).astype(target.dtype)
        return base(input=input, target=clean) * jnp.where(hit, jnp.inf, 1.0)
    return loss_fn


def _guard_batches(batches):
    out = []
    for (images, labels, cl), kind in zip(batches, GUARD_SEQ):
        labels = labels.copy()
        if kind == "X":
            labels[0, 0, 0, 0] = MARK
        out.append((images, labels, cl))
    return out


def _jax_guard_run(shared):
    variables, batches = shared
    cfg = jax_normalize_config(_raw_cfg(nan_guard=2, lr_schedule=SCHEDULE))
    schedule = jax_get_scheduler(SCHEDULE, LR)
    tx = optax.apply_if_finite(jax_get_optimizer(cfg, learning_rate=schedule), 2)
    jt = JaxTrainer(cfg, None, logging.getLogger("test"), jax_get_model(cfg, 11),
                    _marked_jax(jax_get_loss(cfg)), None, None, tx)
    state, step = _jax_state(tx, variables), jt._train_step_fn()
    out = []
    for images, labels, _ in _guard_batches(batches):
        state, _ = step(state, jnp.asarray(images), jnp.asarray(jt._labels(labels)))
        guard = state.opt_state
        counts = {int(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(
            guard.inner_state) if jax.tree_util.keystr(path).endswith(".count")}
        assert len(counts) == 1  # Adam's count and the schedule's
        out.append({"notfinite_count": int(guard.notfinite_count),
                    "last_finite": bool(guard.last_finite),
                    "total_notfinite": int(guard.total_notfinite),
                    "applied": counts.pop(),
                    "state": _to_sd(cfg, state.params, state.batch_stats)})
    return out


def _port_guard_steps(trainer, batches, steps) -> list:
    out = []
    for t in steps:
        images, labels, _ = batches[t]
        trainer.train_step(*trainer._batch(images, labels))
        out.append({**trainer.guard.state_dict(), "applied": trainer.applied,
                    "lr": trainer.optimizer.param_groups[0]["lr"],
                    "state": {k: v.clone() for k, v in trainer.model.state_dict().items()}})
    return out


def test_nan_guard_matches_optax_apply_if_finite(shared, tmp_path):
    variables = shared[0]
    batches = _guard_batches(shared[1])
    raw = _raw_cfg(nan_guard=2, lr_schedule=SCHEDULE)
    schedule = get_scheduler(SCHEDULE, LR)
    loss_fn = _marked_torch(get_loss_function(normalize_config(raw)))
    whole = _port_trainer(raw, variables, batches, loss_fn, tmp_path, schedule)
    port = _port_guard_steps(whole, batches, range(len(GUARD_SEQ)))
    ref = _jax_guard_run(shared)

    applied = 0
    for t, (p, j, kind) in enumerate(zip(port, ref, GUARD_SEQ)):
        for key in ("notfinite_count", "last_finite", "total_notfinite", "applied"):
            assert p[key] == j[key], (t, key, p[key], j[key])
        # the lr of step t is the schedule's at the updates applied before it
        assert p["lr"] == schedule(applied), (t, p["lr"], applied)
        applied = p["applied"]
        if t < len(GUARD_SEQ) - 1:
            _params_close(p["state"], j["state"], t + 1, f"after step {t}")
    # the last update applies non-finite gradients: each framework's conv
    # backward makes its own NaN pattern (XLA multiplies the zero padding by
    # inf, oneDNN skips it), so the same tensors hold NaN, not the same elements
    for name, value in port[-1]["state"].items():
        if not name.endswith(STATS + ("num_batches_tracked",)):
            assert bool(torch.isnan(value).any()) == \
                bool(torch.isnan(torch.as_tensor(ref[-1]["state"][name])).any()), name
    assert [p["applied"] for p in port] == [1, 1, 2, 2, 2, 3, 3, 3, 4]
    assert [p["last_finite"] for p in port] == [k == "F" for k in GUARD_SEQ]
    assert port[-1]["notfinite_count"] == 3 and port[-1]["total_notfinite"] == 6
    # the drops make the schedule lag: step 5's update takes schedule(2), not schedule(5)
    assert port[5]["lr"] == schedule(2) != schedule(5)
    for t in (1, 3, 4, 6, 7):  # a dropped update leaves the parameters as they were
        for name, value in port[t]["state"].items():
            if not name.endswith(STATS + ("num_batches_tracked",)):
                assert torch.equal(value, port[t - 1]["state"][name]), (t, name)
    assert all(torch.isnan(v).any() for k, v in port[-1]["state"].items()
               if k.endswith("weight") and v.is_floating_point())

    # a .pkl round trip after step 5 resumes exactly
    first = _port_trainer(raw, variables, batches, loss_fn, tmp_path / "a", schedule)
    _port_guard_steps(first, batches, range(5))
    path = first._save_ckpt("latest", 5, 0.0)
    blob = torch.load(path, weights_only=True)
    assert blob["nan_guard"] == {"notfinite_count": 2, "last_finite": False,
                                 "total_notfinite": 3, "applied": 2}
    resumed = _port_trainer(raw, variables, batches, loss_fn, tmp_path / "b", schedule)
    resumed._restore_full(path)
    assert (resumed.step, resumed.applied) == (5, 2)
    tail = _port_guard_steps(resumed, batches, range(5, len(GUARD_SEQ)))
    for p, q in zip(tail, port[5:]):
        for key in ("notfinite_count", "last_finite", "total_notfinite", "applied", "lr"):
            assert p[key] == q[key], key
        for name, value in q["state"].items():
            torch.testing.assert_close(p["state"][name], value, rtol=0, atol=0,
                                       equal_nan=True, msg=name)
