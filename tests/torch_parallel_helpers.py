"""Rank workers for the port's parallel tests (tests/test_torch_parallel*.py).

``run_ranks(name, world, workdir, **kw)`` starts ``world`` processes of
this file, each of which joins a gloo group on the CPU through a
``file://`` rendezvous in ``workdir``, runs ``WORKERS[name](layout,
workdir, **kw)`` and saves what it returns to ``workdir/<name>_<rank>.pt``;
the call returns the ranks' results in rank order and deletes those files
(the toy model's weights are ~130 MB). Each run has its own timeout, and a
rank that fails fails the call with its output. The workers
import no JAX: the tests compare their results with JAX's in the test
process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

# the toy MIMOcom every worker builds (64^2, query 8, key 64)
IMG = 64


def toy_cfg(agents: int = 4, batch: int = 2, **training) -> dict:
    from multiagentperception_tpu_torch.config import normalize_config

    return normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": agents, "query_size": 8, "key_size": 64,
                  "multiple_output": True},
        "data": {"img_rows": IMG, "img_cols": IMG, "commun_label": "mimo"},
        "training": {"batch_size": batch, "optimizer": {"name": "adam", "lr": 1e-4},
                     "loss": {"name": "cross_entropy", "size_average": True},
                     "train_iters": 2, "val_interval": 100, "print_interval": 100,
                     "watchdog_secs": 0, **training},
    })


def run_ranks(name: str, world: int, workdir, timeout: float = TIMEOUT_S, **kw) -> list:
    import torch

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    rendezvous = workdir / f"rendezvous_{name}"
    rendezvous.unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, __file__, name, str(rank), str(world), str(rendezvous), str(workdir),
         json.dumps(kw)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} of {world} failed:\n{out[-6000:]}"
    results = []
    for rank in range(world):
        path = workdir / f"{name}_{rank}.pt"
        results.append(torch.load(path, weights_only=False))
        path.unlink()
    return results


def fake_layout(agent: int = 2, world: int = 2):
    """A layout whose groups move nothing: enough for the checks that raise
    before anything is exchanged."""
    import torch

    from multiagentperception_tpu_torch.parallel import Layout
    from multiagentperception_tpu_torch.parallel.collectives import Group

    cpu = torch.device("cpu")
    ring = Group(tuple(range(agent)), 0, "gloo", cpu)
    return Layout(0, world, agent, "gloo", cpu, Group(tuple(range(world)), 0, "gloo", cpu),
                  Group((0,), 0, "gloo", cpu), ring)


# ------------------------------------------------------------------ workers

def _seeded(seed: int, *shape):
    import torch

    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def comm_step(layout, workdir, b: int, n: int, d: int, hw: int, c: int, modes: list):
    """``sharded_comm_step`` on this rank's shard of seeded Q', K, V in each
    mode, with the gradients of a seeded functional of its outputs."""
    import torch

    from multiagentperception_tpu_torch.parallel.ring import sharded_comm_step

    q, k, v = _seeded(0, b, n, d), _seeded(1, b, n, d), _seeded(2, b, n, c, hw, hw)
    share = n // layout.agent
    mine = slice(layout.rank * share, (layout.rank + 1) * share)
    out = {}
    for mode in modes:
        ql, kl, vl = (t[:, mine].clone().requires_grad_(True) for t in (q, k, v))
        fused, coef, soft = sharded_comm_step(ql, kl, vl, layout.agent_group, mode=mode,
                                              diag_bias=0.001)
        res = {"fused": fused.detach(), "coef": coef.detach(), "soft": soft.detach()}
        if mode == "softmax":
            w_f, w_c = _seeded(3, *fused.shape), _seeded(4, b, n, n)[:, :, mine]
            ((fused * w_f).sum() + (coef * w_c).sum()).backward()
            res.update(dq=ql.grad, dk=kl.grad, dv=vl.grad)
        out[mode] = res
    return out


def _model(layout, cfg, state_path):
    import torch

    from multiagentperception_tpu_torch.models import get_model

    model = get_model(cfg, 11, layout)
    model.load_state_dict(torch.load(state_path, weights_only=True), strict=True)
    return model


def mimocom_ring(layout, workdir, agents: int, state: str, frames: str, modes: list):
    """The ring MIMOcom's eval outputs in each mode on shared weights."""
    import torch

    model = _model(layout, toy_cfg(agents), state).eval()
    x = torch.load(frames, weights_only=True)
    out = {"keys": sorted(model.state_dict())}
    with torch.no_grad():
        for mode in modes:
            pred, prob, action, num_connect = model(x, inference=mode)
            out[mode] = {"pred": pred, "prob": prob, "action": action,
                         "num_connect": num_connect}
    return out


def ring_train(layout, workdir, agents: int, state: str, frames: str, labels: str,
               dtype: str):
    """One training forward/backward through the ring
    (``agent_parallel_train``) in ``dtype``: the loss over the ring, the
    gradients summed over it, the BatchNorm statistics after."""
    import torch

    from multiagentperception_tpu_torch.loss import cross_entropy2d
    from multiagentperception_tpu_torch.parallel.collectives import all_reduce_sum

    cfg = toy_cfg(agents)
    cfg["model"]["agent_parallel_train"] = True
    dt = getattr(torch, dtype)
    model = _model(layout, cfg, state).to(dt).train()
    x = torch.load(frames, weights_only=True).to(dt)
    y = torch.load(labels, weights_only=True)  # (B*N, H, W) batch-major
    mine = model.local_agents(agents)
    y_local = y.reshape((-1, agents) + tuple(y.shape[1:]))[:, mine].reshape(
        (-1,) + tuple(y.shape[1:]))
    pred = model(x, inference="softmax")[0]
    loss = cross_entropy2d(pred, y_local, group=layout.agent_group)
    loss.backward()
    grads = {n: all_reduce_sum(p.grad, layout.agent_group) for n, p in model.named_parameters()}
    stats = {n: v for n, v in model.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return {"loss": all_reduce_sum(loss.detach(), layout.agent_group), "grads": grads,
            "stats": stats}


def train_steps(trainer, state: str, batches: str, dtype: str) -> dict:
    """``trainer.train_step`` over the global batches in ``batches`` (each
    rank on its rows) from the weights in ``state``, in ``dtype``: the
    rank's losses, the first step's gradients (summed over the ranks) and
    the state after each step."""
    import torch

    trainer.model.to(getattr(torch, dtype))
    trainer.model.load_state_dict(torch.load(state, weights_only=True), strict=True)
    out = {"losses": [], "states": [], "grads": None}
    for images, labels in torch.load(batches, weights_only=False):
        images, labels = trainer._train_rows((images.astype(dtype), labels))
        loss = trainer.train_step(*trainer._batch(images, labels))
        if out["grads"] is None:
            out["grads"] = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
        out["losses"].append(loss)
        out["states"].append({k: v.clone() for k, v in trainer.model.state_dict().items()})
    return out


def _gap_to_rank0(tensors: dict, group) -> float:
    """The largest difference between this rank's ``tensors`` and rank 0's."""
    from multiagentperception_tpu_torch.parallel.collectives import broadcast

    return max(float((v - broadcast(v.clone(), group)).abs().max())
               for v in tensors.values() if v.is_floating_point())


def dp_train(layout, workdir, state: str, batches: str, agents: int, batch: int,
             dtype: str):
    """``train_steps`` on this rank's rows; the losses summed over the
    ranks. Rank 0 returns its gradients and states, every rank how far its
    own lie from rank 0's."""
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.parallel.collectives import all_reduce_sum
    from multiagentperception_tpu_torch.trainer import Trainer

    cfg = toy_cfg(agents, batch)
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, layout=layout)
    out = train_steps(trainer, state, batches, dtype)
    out["rank_losses"] = [float(v) for v in out["losses"]]
    out["losses"] = [float(all_reduce_sum(v, layout.data_group)) for v in out["losses"]]
    out["gap_to_rank0"] = [_gap_to_rank0(s, layout.data_group)
                           for s in [out["grads"]] + out["states"]]
    if layout.rank:
        del out["grads"], out["states"]
    return out


def ring_replicas(layout, workdir, agents: int, state: str, frames: str, labels: str,
                  jitter: float, steps: int):
    """An agent ring that trains dense (``model.agent_parallel`` without
    ``agent_parallel_train``): ``steps`` train steps on the whole batch,
    each rank's frames shifted by ``jitter * rank`` as a stand-in for a card
    whose arithmetic differs from run to run. Every rank returns how far its
    parameters, buffers and Adam moments lie from rank 0's; rank 0 its
    state."""
    import torch

    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.trainer import Trainer

    cfg = toy_cfg(agents, 1)
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, layout=layout)
    trainer.model.load_state_dict(torch.load(state, weights_only=True), strict=True)
    x = torch.load(frames, weights_only=True).numpy() + jitter * layout.rank
    y = torch.load(labels, weights_only=True).numpy().reshape((1, agents) + x.shape[2:4])
    for _ in range(steps):
        trainer.train_step(*trainer._batch(x, y))
    sd = trainer.model.state_dict()
    moments = {f"{n}.{k}": v for n, p in trainer.model.named_parameters()
               for k, v in trainer.optimizer.state[p].items() if k != "step"}
    out = {"gap_to_rank0": {"state": _gap_to_rank0(sd, layout.agent_group),
                            "moments": _gap_to_rank0(moments, layout.agent_group)}}
    if layout.rank == 0:
        out["state"] = sd
    return out


def sync_bn_stats(layout, workdir, momentum: float):
    """``SyncBatchNorm2d`` in training mode on this rank's rows of a seeded
    (8, 5, 6, 6) batch: its output rows and running statistics."""
    import torch
    from torch import nn

    from multiagentperception_tpu_torch.parallel import sync_bn

    x = _seeded(5, 8, 5, 6, 6) * 3.0 + 1.0
    bn = nn.BatchNorm2d(5, momentum=momentum)
    with torch.no_grad():
        bn.weight.copy_(_seeded(6, 5))
        bn.bias.copy_(_seeded(7, 5))
    sync_bn.attach(bn, layout.data_group)
    share = 8 // layout.data
    y = bn.train()(x[layout.rank * share:(layout.rank + 1) * share])
    return {"y": y.detach(), "mean": bn.running_mean, "var": bn.running_var,
            "tracked": int(bn.num_batches_tracked)}


class _Batches:
    """A list of host batches, iterable again and again (a loader)."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def dp_eval(layout, workdir, state: str, batches: str, agents: int, batch: int,
            mode: str, sharded_loader: bool, frames_root: str = ""):
    """``Evaluator.evaluate`` over global batches (a tail included): the
    confusion matrices, bandwidth and selection counts every rank holds."""
    import torch

    from multiagentperception_tpu_torch.data.pipeline import ShardBatch
    from multiagentperception_tpu_torch.evaluate import Evaluator

    ev = Evaluator(toy_cfg(agents, batch), layout=layout)
    ev.load_weight(state)
    host = torch.load(batches, weights_only=False)
    if sharded_loader:  # as data.pipeline.DataLoader(shard=...) yields them
        data = []
        for b in host:
            size = len(b[0])
            if size % layout.data:
                data.append(ShardBatch(b, size))
            else:
                share = size // layout.data
                rows = slice(layout.data_index * share, (layout.data_index + 1) * share)
                data.append(ShardBatch(tuple(a[rows] for a in b), size))
        host = data
    ev.evaluate(_Batches(host), inference_mode=mode)
    m = ev.last_eval_metrics
    return {"hist": m.confusion_matrix, "bandwidth": m.get_avg_bandW(),
            "scores": m.get_scores()[0], "selection": m.get_selection_accuracy()}


def failing_rank(layout) -> None:
    """A rank that fails (``parallel.spawn`` must fail the launch)."""
    raise RuntimeError(f"rank {layout.rank} fails on purpose")


WORKERS = {f.__name__: f for f in (comm_step, mimocom_ring, ring_train, dp_train,
                                    ring_replicas, sync_bn_stats, dp_eval)}


def _main(argv) -> None:
    import torch

    from multiagentperception_tpu_torch.parallel import init_distributed

    name, rank, world, rendezvous, workdir, kw = argv
    rank, world, kw = int(rank), int(world), json.loads(kw)
    torch.set_num_threads(1)
    layout = init_distributed(rank=rank, world=world, init_method=f"file://{rendezvous}",
                              device="cpu", agent=int(kw.pop("agent", 1)))
    try:
        result = WORKERS[name](layout, workdir, **kw)
        torch.save(result, os.path.join(workdir, f"{name}_{rank}.pt"))
    finally:
        layout.close()


if __name__ == "__main__":
    _main(sys.argv[1:])
