"""Sustained end-to-end train-loop throughput on the card: decode -> batch ->
host-to-device copy -> train step (counterpart of the repo's
scripts/bench_train_pipeline.py).

    python -m multiagentperception_tpu_torch.bench_train_pipeline [--batch 2]
        [--img 512] [--iters 20] [--frames 8] [--steps_per_call 8]
        [--workers 4] [--device cpu] [--loaders]

Writes a ``generate_fixture`` dataset (6 agents, ``--img``², ``--frames``
frames in each of 2 train trajectories) under a temporary directory, then
times the trainer's own hot loop (``Trainer._device_train_chunks`` feeding
``Trainer._chunk``, what ``Trainer.train`` iterates) on the flagship
geometry (MIMOcom, 6 agents, query 32, key 1024) in bfloat16 from
``init_weights(model, 0)``, Adam at 1e-5, in six cumulative variants:

  A. float32 frames normalized on the host, synchronous (the reference's loop)
  B. + uint8 frames normalized on the device (``data.on_device_normalize``)
  C. + the decoded-frame cache (``data.cache_decoded``)
  D. + host-to-device prefetch (``training.device_prefetch`` 2)
  E. + ``training.steps_per_call`` K (one CUDA graph of the step, replayed)
  F. D with ``data_backend: grain`` and ``grain_workers`` ``--workers``

Each variant times ``--iters`` iterations after a warm-up (E: chunks of K
after two warm-up chunks, the capture among them), a host clock closed by
reading the last losses back. A frame is one agent's view: frames/s is
batch x 6 x iterations over the seconds. Prints each variant's frames/s and
its ratio to A, then one JSON line. ``--loaders`` first times the loader
alone, in frames decoded/s over two passes of the train split (uint8):
cv2 through the thread ``DataLoader``, the native decoder, the cache cold
(its first pass, which writes it) and warm, and ``GrainLoader`` with
``--workers`` worker processes (timed from its first batch, so the
workers' start is not counted). On the CPU (``--device cpu``) the numbers
are the host's, never the card's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import tempfile
import time

import torch

AGENTS = 6
SEED = 0


def _cfg(root: str, img: int, batch: int, raw: bool, cache_dir: str | None, prefetch: int,
         steps_per_call: int, iters: int) -> dict:
    from multiagentperception_tpu_torch.config import normalize_config

    return normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": AGENTS, "multiple_output": True,
                  "query_size": 32, "key_size": 1024, "dtype": "bfloat16"},
        "data": {"img_rows": img, "img_cols": img, "path": root, "target_view": "6agent",
                 "commun_label": "mimo", "on_device_normalize": raw,
                 "cache_decoded": cache_dir},
        "training": {"batch_size": batch, "n_workers": 4, "device_prefetch": prefetch,
                     "steps_per_call": steps_per_call, "train_iters": iters,
                     "val_interval": iters, "watchdog_secs": 0,
                     "optimizer": {"name": "adam", "lr": 1e-5},
                     "loss": {"name": "cross_entropy", "size_average": True}},
    })


def _dataset(root: str, img: int, raw: bool, cache_dir: str | None, **kw):
    from multiagentperception_tpu_torch.data import AirsimDataset

    return AirsimDataset(root, split="train", target_view="6agent", img_size=(img, img),
                         commun_label="mimo", raw_images=raw, cache_decoded=cache_dir, **kw)


def build_trainer(root: str, img: int, batch: int, device, *, raw: bool,
                  cache_dir: str | None, prefetch: int, steps_per_call: int = 1,
                  iters: int = 1, grain_workers: int | None = None):
    """A ``Trainer`` of the flagship geometry over the train split; with
    ``grain_workers`` its loader is a shuffled ``GrainLoader``, else the
    thread ``DataLoader`` with 4 threads."""
    from multiagentperception_tpu_torch.data import DataLoader
    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import init_weights
    from multiagentperception_tpu_torch.trainer import Trainer

    cfg = _cfg(root, img, batch, raw, cache_dir, prefetch, steps_per_call, iters)
    ds = _dataset(root, img, raw, cache_dir)
    if grain_workers is None:
        loader = DataLoader(ds, batch, shuffle=True, drop_last=True, num_workers=4, seed=SEED)
    else:
        loader = GrainLoader(ds, batch, shuffle=True, drop_last=True,
                             num_workers=grain_workers, seed=SEED)
    trainer = Trainer(cfg, logging.getLogger("bench_train_pipeline"), get_loss_function(cfg),
                      loader, None, device=device)
    init_weights(trainer.model, SEED)
    return trainer


def run_loop(trainer, chunks: int, steps_per_call: int = 1, warmup: int = 3) -> float:
    """Seconds of ``chunks`` chunks of the trainer's hot loop after
    ``warmup`` ones; a loss readback closes each end of the window."""
    graph = trainer.graphs and steps_per_call > 1 and trainer.device.type == "cuda"
    gen = trainer._device_train_chunks(steps_per_call, 0)
    t0, losses = None, None
    try:
        for c in range(warmup + chunks):
            xs, ys, k, _ = next(gen)
            losses = trainer._chunk(xs, ys, k, graph)
            if c == warmup - 1:
                losses.float().cpu()
                t0 = time.perf_counter()
        losses.float().cpu()
        return time.perf_counter() - t0
    finally:
        gen.close()
        shutdown = getattr(trainer.trainloader, "shutdown", None)
        if shutdown is not None:
            shutdown()


def _pass_seconds(loader, passes: int, skip_first: bool = False) -> tuple[float, int]:
    """Seconds and agent views of ``passes`` passes over ``loader`` (from
    its first batch with ``skip_first``)."""
    views, t0 = 0, time.perf_counter()
    for p in range(passes):
        for b, batch in enumerate(loader):
            if skip_first and p == 0 and b == 0:
                t0 = time.perf_counter()
                continue
            views += batch[0].shape[0] * batch[0].shape[1]
    return time.perf_counter() - t0, views


def loader_rates(root: str, img: int, batch: int, workers: int, cache_root: str,
                 passes: int = 2) -> dict:
    """The loader alone, frames (agent views) decoded per second, uint8."""
    from multiagentperception_tpu_torch import native
    from multiagentperception_tpu_torch.data import DataLoader
    from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader

    def threads(ds):
        return DataLoader(ds, batch, shuffle=True, drop_last=True, num_workers=4, seed=SEED)

    out = {}
    try:
        import cv2  # noqa: F401
    except ImportError as err:
        out["cv2_threads"] = f"cv2 does not import: {err}"
    else:
        out["cv2_threads"] = _pass_seconds(threads(_dataset(root, img, True, None,
                                                            use_native_decoder=False)), passes)
    try:
        native.load()
    except (native.NativeBuildError, OSError) as err:
        out["native_threads"] = f"the native decoder does not build or load: {str(err)[-400:]}"
    else:
        out["native_threads"] = _pass_seconds(threads(_dataset(root, img, True, None,
                                                               use_native_decoder=True)), passes)
    cache = os.path.join(cache_root, "loader_cache")
    shutil.rmtree(cache, ignore_errors=True)
    cached = threads(_dataset(root, img, True, cache))
    out["cache_cold"] = _pass_seconds(cached, 1)
    out["cache_warm"] = _pass_seconds(cached, passes)
    grain = GrainLoader(_dataset(root, img, True, None), batch, shuffle=True, drop_last=True,
                        num_workers=workers, seed=SEED)
    try:
        out[f"grain_{workers}_workers"] = _pass_seconds(grain, passes + 1, skip_first=True)
    finally:
        grain.shutdown()
    return {k: (v if isinstance(v, str) else {"seconds": v[0], "frames": v[1],
                                               "frames_per_s": v[1] / v[0]})
            for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)  # the flagship YAML's
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--loaders", action="store_true",
                    help="also time the loader alone (frames decoded/s)")
    ap.add_argument("--root", default=None,
                    help="an existing generate_fixture root (default: written anew)")
    args = ap.parse_args(argv)

    from multiagentperception_tpu_torch.data.synthetic import generate_fixture
    from multiagentperception_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="trainpipe_")
    try:
        root = args.root or os.path.join(tmp, "data")
        if args.root is None:
            print(f"generating a {args.img}^2 fixture at {root} ...")
            generate_fixture(root, target_view="6agent", img_size=args.img,
                             frames_per_traj=args.frames, n_train=2)
        result = {"device": str(device), "batch": args.batch, "img": args.img,
                  "iters": args.iters, "dtype": "bfloat16"}
        if device.type == "cuda":
            result["card"] = torch.cuda.get_device_name(device)
        if args.loaders:
            result["loader_frames_per_s"] = loader_rates(root, args.img, args.batch,
                                                         args.workers, tmp)
            print("loaders " + json.dumps(result["loader_frames_per_s"]))
        cache = os.path.join(tmp, "cache")
        k = args.steps_per_call
        variants = [
            ("A f32-sync (reference-style)", dict(raw=False, cache_dir=None, prefetch=0), 1),
            ("B + uint8 + device-normalize", dict(raw=True, cache_dir=None, prefetch=0), 1),
            ("C + decoded-frame cache", dict(raw=True, cache_dir=cache, prefetch=0), 1),
            ("D + device prefetch (depth 2)", dict(raw=True, cache_dir=cache, prefetch=2), 1),
            (f"E + steps_per_call {k}", dict(raw=True, cache_dir=cache, prefetch=2), k),
            (f"F D + grain, {args.workers} workers",
             dict(raw=True, cache_dir=cache, prefetch=2, grain_workers=args.workers), 1),
        ]
        rows, base = {}, None
        for name, kw, spc in variants:
            chunks = args.iters if spc == 1 else max(2, args.iters // spc)
            warmup = 3 if spc == 1 else 2
            trainer = build_trainer(root, args.img, args.batch, device, steps_per_call=spc,
                                    iters=(warmup + chunks) * spc, **kw)
            seconds = run_loop(trainer, chunks, spc, warmup)
            frames = args.batch * AGENTS * chunks * spc
            rate = frames / seconds
            base = rate if base is None else base
            rows[name[0]] = {"name": name, "seconds": seconds, "frames": frames,
                             "frames_per_s": rate, "vs_A": rate / base}
            print(f"{name:36s} {seconds:8.3f}s  {rate:8.1f} frames/s  {rate / base:5.2f}x")
            del trainer
            if device.type == "cuda":
                torch.cuda.empty_cache()
        result["variants"] = rows
        print(json.dumps(result))
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
