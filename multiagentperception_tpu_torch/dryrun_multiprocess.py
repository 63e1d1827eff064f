"""A real multi-process run of the port's data parallel on the CPU (the
port's counterpart of scripts/dryrun_multiprocess.py).

    python -m multiagentperception_tpu_torch.dryrun_multiprocess [--coordinator URL]

Starts 2 ranks as a ``MAP_COORDINATOR`` launch (``MAP_NUM_PROCESSES=2``,
``MAP_PROCESS_ID``; the coordinator ``localhost:<a free port>``, or the
``file://`` URL given) under gloo on the CPU and checks, as the JAX script
does:

1. barriers: both ranks join and pass one;
2. ``GrainLoader(shard_by_process=True)`` slices are disjoint and exhaustive
   across the ranks (37 frames: each rank reads 18, one is dropped);
3. a cross-process data-parallel step: each rank's own rows of a linear
   least-squares problem, the loss as each rank's share of the global mean
   and the gradient summed once (``parallel.collectives``): both ranks hold
   the global loss and gradient of the single-process step;
4. single-writer checkpoints through ``Trainer._save_ckpt``: rank 0 writes,
   rank 1 does not, and both restore the same state;
5. per-rank confusion matrices summed across the ranks;
6. ``Trainer.train`` over the ranks with a process-sharded ``grain`` stream
   (``shard_data_by_process``: the global batch is 2 x the per-rank
   ``batch_size``), and a run cut at iteration 2 and resumed (each rank from
   its own position in the ``.pkl``) equal to the uninterrupted one, to
   the bit.

Prints one JSON line (``{"ok": ..., ...}``) and exits non-zero if a check
failed or a rank did.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np

N_PROC = 2
INDEX_FRAMES = 37  # odd: the shard drops one
TIMEOUT_S = 300


class IndexFrames:
    """Frame ``i`` is the array ``[i]``: slice bookkeeping."""

    root, split = "index", "train"

    def __len__(self) -> int:
        return INDEX_FRAMES

    def __getitem__(self, i: int):
        return (np.asarray([i]),)


class TinyFrames:
    """Seeded (images, labels) frames of 2 agents at 32x32: any change in the
    order of the data shows in the trained parameters."""

    root, split = "tiny", "train"
    AGENTS, HW = 2, 32

    def __len__(self) -> int:
        return 32

    def __getitem__(self, i: int):
        r = np.random.default_rng(i)
        img = r.uniform(0, 1, (self.AGENTS, self.HW, self.HW, 3)).astype(np.float32)
        return img, r.integers(0, 11, (self.AGENTS, self.HW, self.HW)).astype(np.int64)


def _cfg(iters: int, resume: str | None = None) -> dict:
    from multiagentperception_tpu_torch.config import normalize_config

    cfg = {
        "model": {"arch": "Single_agent", "agent_num": 2, "multiple_output": True,
                  "enc_backbone": "n_segnet_encoder", "dec_backbone": "simple_decoder",
                  "feat_channel": 16},
        "data": {"img_rows": 32, "img_cols": 32, "commun_label": "None",
                 "target_view": "two_agents"},
        "training": {"batch_size": 4, "train_iters": iters, "val_interval": 100,
                     "print_interval": 100, "save_interval": 2, "watchdog_secs": 0,
                     "shard_data_by_process": True, "device_prefetch": 0,
                     "optimizer": {"name": "adam", "lr": 1e-3},
                     "loss": {"name": "cross_entropy", "size_average": True}},
    }
    if resume:
        cfg["training"]["resume"] = resume
    return normalize_config(cfg)


def _trainer(cfg, layout, logdir: str, loader=None, seed: int = 0):
    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import init_weights
    from multiagentperception_tpu_torch.trainer import Trainer

    tr = Trainer(cfg, None, get_loss_function(cfg), loader, GrainLoader(TinyFrames(), 4),
                 device="cpu", logdir=logdir, layout=layout)
    init_weights(tr.model, seed)
    return tr


def worker(workdir: str) -> dict:
    import torch

    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader
    from multiagentperception_tpu_torch.ops.comm import confusion_matrix
    from multiagentperception_tpu_torch.parallel import from_environment
    from multiagentperception_tpu_torch.parallel.collectives import all_reduce_sum, barrier

    torch.set_num_threads(1)
    layout = from_environment(device="cpu")
    rank, world = layout.rank, layout.world
    group = layout.world_group
    report: dict = {"rank": rank, "world": world, "backend": layout.backend}

    # 1. barrier
    barrier(group)
    report["barrier"] = "ok"

    # 2. shard_by_process slices
    loader = GrainLoader(IndexFrames(), batch_size=4, shuffle=True, seed=7,
                         shard_by_process=True)
    report["grain_slice"] = sorted(int(v) for (batch,) in loader for v in batch.ravel())

    # 3. a data-parallel step on a linear least-squares problem
    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn(16, 8, generator=gen, dtype=torch.float64)
    x_all = torch.randn(world * 4, 16, generator=gen, dtype=torch.float64)
    y_all = torch.randn(world * 4, 8, generator=gen, dtype=torch.float64)
    w = w0.clone().requires_grad_(True)
    rows = slice(rank * 4, (rank + 1) * 4)
    share = ((x_all[rows] @ w - y_all[rows]) ** 2).sum() / y_all.numel()
    share.backward()
    loss, grad = all_reduce_sum(share.detach(), group), all_reduce_sum(w.grad, group)
    w1 = w0.clone().requires_grad_(True)
    ((x_all @ w1 - y_all) ** 2).mean().backward()
    report["spmd_loss"] = float(loss)
    report["spmd_matches_single"] = bool(
        torch.allclose(loss, ((x_all @ w0 - y_all) ** 2).mean(), rtol=1e-12)
        and torch.allclose(grad, w1.grad, rtol=1e-12))

    # 4. single-writer checkpoints
    os.chdir(workdir)
    saves = []
    real_save = torch.save

    def counting_save(obj, path, *a, **kw):
        saves.append(str(path))
        return real_save(obj, path, *a, **kw)

    torch.save = counting_save
    try:
        tr = _trainer(_cfg(2), layout, "runs/ckpt")
        tr.step = tr.applied = 5
        path = tr._save_ckpt("latest", 5, 0.5)
    finally:
        torch.save = real_save
    report["ckpt_writes"] = len(saves)
    fresh = _trainer(_cfg(2), layout, "runs/ckpt", seed=1)
    report["restored_best_iou"] = fresh._restore_full(path)
    report["restored_step"] = fresh.step
    report["restored_params_equal"] = all(
        torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                          fresh.model.state_dict().values()))

    # 5. per-rank confusion matrices summed
    pred = (torch.arange(64) + rank) % 11
    hist = all_reduce_sum(confusion_matrix(torch.arange(64)[None] % 11, pred[None], 11), group)
    report["metric_reduction_total"] = int(hist.sum())

    # 6. Trainer.train over the ranks, cut and resumed
    def train(iters: int, logdir: str, resume: str | None = None):
        stream = GrainLoader(TinyFrames(), batch_size=4, shuffle=True, drop_last=True,
                             seed=11, shard_by_process=True)
        tr = _trainer(_cfg(iters, resume), layout, logdir, stream)
        batch_sizes = []
        real_rows = tr._train_rows

        def rows(data_list):
            out = real_rows(data_list)
            batch_sizes.append(len(out[0]))
            return out

        tr._train_rows = rows
        tr.train()
        return tr, batch_sizes

    run_a, sizes = train(6, "runs/a")
    report["e2e_rank_batch"] = sizes[0]
    train(2, "runs/b")
    latest = os.path.join("runs", "b", "Single_agent_airsim_latest.pkl")
    blob = torch.load(latest, weights_only=True)
    report["e2e_positions"] = blob.get("data_stream")
    run_b, _ = train(6, "runs/b", resume=latest)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        run_a.model.state_dict().values(), run_b.model.state_dict().values())
        if a.is_floating_point())
    report["e2e_resume_param_maxdiff"] = diff
    report["e2e_resume_exact"] = diff == 0.0
    report["e2e_final_step"] = run_b.step
    barrier(group)
    layout.close()
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--coordinator", default=None,
                        help="MAP_COORDINATOR for the ranks (default localhost:<free port>)")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        report = worker(args.worker)
        with open(os.path.join(args.worker, f"report_{report['rank']}.json"), "w") as fp:
            json.dump(report, fp)
        return 0
    coordinator = args.coordinator
    if coordinator is None:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            coordinator = f"localhost:{s.getsockname()[1]}"
    workdir = tempfile.mkdtemp(prefix="map_dryrun_")
    try:
        return _launch(coordinator, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _launch(coordinator: str, workdir: str) -> int:
    """Run the ranks in ``workdir`` and print the combined result."""
    env = {**os.environ, "MAP_COORDINATOR": coordinator, "MAP_NUM_PROCESSES": str(N_PROC),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "multiagentperception_tpu_torch.dryrun_multiprocess",
         "--worker", workdir],
        env={**env, "MAP_PROCESS_ID": str(i)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(N_PROC)]
    failed = []
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                failed.append(i)
                print(f"--- rank {i} failed (exit code {p.returncode}) ---\n{out[-4000:]}",
                      file=sys.stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        print(json.dumps({"ok": False, "failed_ranks": failed}))
        return 1
    reports = []
    for i in range(N_PROC):
        with open(os.path.join(workdir, f"report_{i}.json")) as fp:
            reports.append(json.load(fp))
    slices = [set(r["grain_slice"]) for r in reports]
    disjoint = not (slices[0] & slices[1])
    exhaustive = len(slices[0] | slices[1]) == (INDEX_FRAMES // N_PROC) * N_PROC
    positions = reports[0]["e2e_positions"]
    result = {
        "disjoint": disjoint, "exhaustive": exhaustive,
        "covered": len(slices[0] | slices[1]), "frames": INDEX_FRAMES,
        "spmd_loss_identical": reports[0]["spmd_loss"] == reports[1]["spmd_loss"],
        "spmd_matches_single": all(r["spmd_matches_single"] for r in reports),
        "ckpt_writes": [r["ckpt_writes"] for r in reports],
        "restored_step": [r["restored_step"] for r in reports],
        "restored_params_equal": all(r["restored_params_equal"] for r in reports),
        "metric_reduction_total": reports[0]["metric_reduction_total"],
        "global_batch": sum(r["e2e_rank_batch"] for r in reports),
        "positions_per_rank": positions,
        "resume_param_maxdiff": [r["e2e_resume_param_maxdiff"] for r in reports],
        "backend": reports[0]["backend"],
    }
    result["ok"] = bool(
        disjoint and exhaustive and result["spmd_loss_identical"]
        and result["spmd_matches_single"] and result["ckpt_writes"] == [1, 0]
        and result["restored_step"] == [5, 5] and result["restored_params_equal"]
        and result["metric_reduction_total"] == 64 * N_PROC
        and result["global_batch"] == 4 * N_PROC
        and isinstance(positions, list) and len(positions) == N_PROC
        and all(r["e2e_resume_exact"] and r["e2e_final_step"] == 6 for r in reports))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
