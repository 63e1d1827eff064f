"""Data parallel in the port against one process and against the JAX
package's ('data',) mesh: the train step, BatchNorm's statistics over the
ranks, the sharded eval with a tail batch, and the multi-process dry run
(``python -m multiagentperception_tpu_torch.dryrun_multiprocess``: the
process-sharded ``grain`` slices, rank-0-only checkpoints and a mid-epoch
resume per rank). Ranks are gloo processes on the CPU with a ``file://``
rendezvous in ``tmp_path`` (tests/torch_parallel_helpers.py), each run
with its own timeout.

Tolerances, and why:

- 2 ranks against one process on the global batch, 2 Adam steps, in
  float64: losses and every parameter and BatchNorm statistic within 1e-9
  (the same arithmetic but the order of the sums; with float32 the
  ranks' E[x²] - E[x]² BatchNorm variance and torch's two-pass one part
  by ~1e-3 in the policy tower, tests/test_torch_parallel_ring.py). The
  ranks' gradients and states are equal, bit for bit.
- 2 ranks against JAX's 2-device ('data',) mesh, both in float64 (the JAX
  BatchNorm, loss and attention lifted from their float32 casts, as
  tests/test_torch_train_parts.py does; in float32 the JAX package's own
  gradients lie up to ~1.5e-2 from its float64 ones, so no float32
  comparison can hold 1e-5): both losses 1e-5 relative; the first step's
  gradients, summed over the ranks, against the gradients jit takes on
  the mesh, and each step's update (state - start) against the mesh
  step's, relative L2 1e-5 per tensor; BatchNorm statistics after each
  step 1e-5 relative. The gradients that are 0 in exact arithmetic (a
  conv bias before a training-mode BatchNorm, ``key_net``'s last bias:
  tests/test_torch_train.py) are held below 1e-12, and their updates,
  which Adam makes of rounding noise under its eps, below lr / 1000.
  Measured: gradients within 2e-13, updates within 2e-10, those updates
  below 4e-14.
- The labels ignore half of rank 0's pixels and none of rank 1's: a mean
  of per-rank means moves the gradient at the logits by over 0.1 relative
  (``test_per_rank_mean_loss_would_be_wrong``), and a step that skips the
  update, scales the gradient or normalizes it per rank misses the
  gradient or update bounds by orders of magnitude.
- ``SyncBatchNorm2d`` against JAX's ``TorchBatchNorm`` on the whole batch:
  output and running statistics within 1e-5.
- The sharded eval with a tail batch against one process: confusion
  matrices equal, bandwidth equal, selection counts equal.
"""

from __future__ import annotations

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

from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.loss import get_loss_function as jax_get_loss
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.models.blocks import TorchBatchNorm
from multiagentperception_tpu.optimizers import get_optimizer as jax_get_optimizer
from multiagentperception_tpu.parallel import make_mesh
from multiagentperception_tpu.trainer import Trainer as JaxTrainer
from multiagentperception_tpu.trainer import TrainState
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.evaluate import Evaluator
from multiagentperception_tpu_torch.loss import cross_entropy2d, get_loss_function
from multiagentperception_tpu_torch.trainer import Trainer
from test_torch_train_parts import _jax_float64
from torch_parallel_helpers import IMG, ROOT, _Batches, run_ranks, toy_cfg, train_steps

AGENTS, BATCH, LR = 2, 4, 1e-4
STATS = ("running_mean", "running_var")


def _raw(agents: int = AGENTS, batch: int = BATCH) -> dict:
    return {"model": {"arch": "MIMOcom", "agent_num": agents, "query_size": 8,
                      "key_size": 64, "multiple_output": True},
            "data": {"img_rows": IMG, "img_cols": IMG, "commun_label": "mimo"},
            "training": {"batch_size": batch, "optimizer": {"name": "adam", "lr": LR},
                         "loss": {"name": "cross_entropy", "size_average": True}}}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """JAX-initialized weights and 2 global batches of 4 whose ignored
    pixels fall unevenly: half of rank 0's rows, none of rank 1's."""
    work = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        images = (rng.standard_normal((BATCH, AGENTS, IMG, IMG, 3)) * 0.5).astype(np.float32)
        labels = rng.integers(0, 11, (BATCH, AGENTS, IMG, IMG)).astype(np.int32)
        labels[:BATCH // 2, :, :IMG // 2] = 250
        batches.append((images, labels))
    jcfg = jax_normalize_config(_raw())
    variables = jax_get_model(jcfg, 11).init(jax.random.PRNGKey(0),
                                             jnp.asarray(batches[0][0]), train=True,
                                             mo_flag=True, inference="softmax")
    variables = jax.tree_util.tree_map(np.asarray, variables)
    torch.save(state_dict_from_flax(toy_cfg(AGENTS, BATCH), variables), work / "state.pt")
    torch.save(batches, work / "batches.pt")
    yield work, jcfg, variables, batches
    shutil.rmtree(work)


@pytest.fixture(scope="module")
def dp_runs(shared):
    """Per dtype, (the 2 ranks' results, one process's on the global batches)."""
    work, _, _, _ = shared
    torch.set_num_threads(2)
    cfg = toy_cfg(AGENTS, BATCH)
    runs = {}
    for dtype in ("float64", "float32"):
        ranks = run_ranks("dp_train", 2, work / dtype, state=str(work / "state.pt"),
                          batches=str(work / "batches.pt"), agents=AGENTS, batch=BATCH,
                          dtype=dtype)
        trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device="cpu")
        single = train_steps(trainer, str(work / "state.pt"), str(work / "batches.pt"), dtype)
        single["losses"] = [float(v) for v in single["losses"]]
        runs[dtype] = ranks, single
    return runs


def test_dp_train_matches_one_process(dp_runs):
    ranks, single = dp_runs["float64"]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], single["losses"], rtol=1e-9)
        assert rank["gap_to_rank0"] == [0.0] * 3  # the gradients, then each step's state
    for got, want in zip(ranks[0]["states"], single["states"]):
        for name, v in want.items():
            if v.is_floating_point():
                np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=1e-9,
                                           atol=1e-9, err_msg=name)
            else:
                assert torch.equal(got[name], v), name
    ranks, single = dp_runs["float32"]  # the first loss; then the arithmetic parts
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"][0], single["losses"][0], rtol=1e-5)
        assert rank["gap_to_rank0"] == [0.0] * 3


def test_per_rank_mean_loss_would_be_wrong(shared):
    """With the fixture's labels a mean of per-rank means weighs rank 0's
    kept pixels 1.5x too much: its gradient misses the global loss's by far
    more than the bounds above, so the equal step needs the global count."""
    _, _, _, batches = shared
    labels = torch.from_numpy(batches[0][1]).reshape(BATCH * AGENTS, IMG, IMG)
    logits = torch.randn(BATCH * AGENTS, 11, IMG, IMG,
                         generator=torch.Generator().manual_seed(9)).requires_grad_(True)
    (g_global,) = torch.autograd.grad(cross_entropy2d(logits, labels), logits)
    half = BATCH * AGENTS // 2
    per_rank = (cross_entropy2d(logits[:half], labels[:half])
                + cross_entropy2d(logits[half:], labels[half:])) / 2
    (g_rank,) = torch.autograd.grad(per_rank, logits)
    assert float((g_rank - g_global).norm() / g_global.norm()) > 0.1


def _jax_mesh_run(jcfg, variables, batches):
    """2 steps of the JAX Trainer's jitted step on a 2-device ('data',)
    mesh in float64, and the first step's gradients jit takes on that
    mesh (the step keeps them inside)."""
    def to_sd(params, stats):
        return state_dict_from_flax(toy_cfg(AGENTS, BATCH), jax.tree_util.tree_map(
            np.asarray, {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}))

    with _jax_float64():
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        tx = jax_get_optimizer(jcfg)
        model, loss_fn = jax_get_model(jcfg, 11), jax_get_loss(jcfg)
        trainer = JaxTrainer(jcfg, None, logging.getLogger("test"), model, loss_fn, None, None,
                             tx, mesh=make_mesh(2, 1, jax.devices()[:2]))
        state = trainer._place_state(TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params), rng=jax.random.PRNGKey(2)))
        kw = trainer._apply_kwargs(True)

        def first_loss(p, images, labels):
            out, _ = model.apply({"params": p, "batch_stats": stats}, images,
                                 mutable=["batch_stats"], **kw)
            return loss_fn(input=out[0], target=labels)

        step = trainer._train_step_fn()
        losses, states, grads = [], [], None
        for images, labels in batches:
            x, y = trainer._put_batch(images.astype(np.float64), trainer._labels(labels))
            if grads is None:
                assert len(x.sharding.device_set) == 2  # the batch lies over the mesh
                grads = to_sd(jax.jit(jax.grad(first_loss))(state.params, x, y), stats)
            state, loss = step(state, x, y)
            losses.append(float(loss))
            states.append(to_sd(state.params, state.batch_stats))
    return losses, grads, states


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def test_dp_train_matches_jax_mesh(dp_runs, shared):
    """The 2 ranks' step is JAX's mesh step: the same loss, the same summed
    gradients and the same update, within 1e-5 (module docstring)."""
    ranks, _ = dp_runs["float64"]
    _, jcfg, variables, batches = shared
    losses, grads, states = _jax_mesh_run(jcfg, variables, batches)
    start = state_dict_from_flax(toy_cfg(AGENTS, BATCH), variables)
    zero = {"key_net.fc.4.bias"} | {n for n in grads if n.endswith("cbr_unit.0.bias")}
    got = ranks[0]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-5)
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


@pytest.mark.parametrize("momentum", [0.1, 0.5])
def test_sync_bn_matches_torch_batchnorm(tmp_path, momentum):
    """Statistics over 2 ranks' rows equal JAX's ``TorchBatchNorm`` over
    the whole batch (blocks.py:64-74), the running variance with the
    global n's ``n / (n - 1)``."""
    ranks = run_ranks("sync_bn_stats", 2, tmp_path, momentum=momentum)
    x = torch.randn(8, 5, 6, 6, generator=torch.Generator().manual_seed(5)) * 3.0 + 1.0
    weight = torch.randn(5, generator=torch.Generator().manual_seed(6))
    bias = torch.randn(5, generator=torch.Generator().manual_seed(7))
    bn = TorchBatchNorm(use_running_average=False, momentum=1.0 - momentum)
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    variables = bn.init(jax.random.PRNGKey(0), xj)
    variables = {"params": {"scale": jnp.asarray(weight.numpy()),
                            "bias": jnp.asarray(bias.numpy())},
                 "batch_stats": variables["batch_stats"]}
    y, upd = bn.apply(variables, xj, mutable=["batch_stats"])
    y = np.transpose(np.asarray(y), (0, 3, 1, 2))
    np.testing.assert_allclose(torch.cat([r["y"] for r in ranks]).numpy(), y, atol=1e-5)
    for rank in ranks:
        np.testing.assert_allclose(rank["mean"].numpy(), np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rank["var"].numpy(), np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)
        assert rank["tracked"] == 1


# ------------------------------------------------------------------ sharded eval

def _eval_batches():
    """3 global batches of 4, 4 and a tail of 3 (3 does not divide over 2
    ranks), mimo commun labels."""
    rng = np.random.default_rng(3)
    out = []
    for b in (BATCH, BATCH, 3):
        images = (rng.standard_normal((b, AGENTS, IMG, IMG, 3)) * 0.5).astype(np.float32)
        labels = rng.integers(0, 11, (b, AGENTS, IMG, IMG)).astype(np.int32)
        labels[rng.random(labels.shape) < 0.05] = 250
        cl = np.stack([rng.integers(0, 2, (b, AGENTS)), rng.integers(0, AGENTS, (b, AGENTS))],
                      axis=1).astype(np.int64)
        out.append((images, labels, cl))
    return out


@pytest.mark.parametrize("mode,sharded_loader", [("activated", True), ("softmax", False)],
                         ids=["activated-sharded_loader", "softmax-global_batches"])
def test_dp_eval_with_tail_matches_one_process(shared, tmp_path, mode, sharded_loader):
    work = shared[0]
    torch.save(_eval_batches(), tmp_path / "eval.pt")
    ranks = run_ranks("dp_eval", 2, tmp_path, state=str(work / "state.pt"),
                      batches=str(tmp_path / "eval.pt"), agents=AGENTS, batch=BATCH,
                      mode=mode, sharded_loader=sharded_loader)
    ev = Evaluator(toy_cfg(AGENTS, BATCH), device="cpu")
    ev.load_weight(str(work / "state.pt"))
    ev.evaluate(_Batches(_eval_batches()), inference_mode=mode)
    m = ev.last_eval_metrics
    for rank in ranks:
        np.testing.assert_array_equal(rank["hist"], m.confusion_matrix)
        assert rank["bandwidth"] == m.get_avg_bandW()
        assert rank["selection"] == m.get_selection_accuracy()
        assert rank["scores"] == m.get_scores()[0]


def test_dryrun_multiprocess(tmp_path):
    """The port's scripts/dryrun_multiprocess.py: a ``MAP_COORDINATOR``
    launch of 2 ranks (a ``file://`` rendezvous) and its six checks."""
    proc = subprocess.run(
        [sys.executable, "-m", "multiagentperception_tpu_torch.dryrun_multiprocess",
         "--coordinator", f"file://{tmp_path / 'rendezvous'}"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["disjoint"] and result["exhaustive"]
    assert result["ckpt_writes"] == [1, 0] and result["resume_param_maxdiff"] == [0.0, 0.0]
    assert [p["consumed"] for p in result["positions_per_rank"]] == [2, 2]
