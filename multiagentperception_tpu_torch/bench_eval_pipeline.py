"""The pipelined eval loop against a synchronous one.

    python -m multiagentperception_tpu_torch.bench_eval_pipeline [--uint8] [--batch 16]
        [--device cpu] [--tiny]

The counterpart of the repo's scripts/bench_eval_pipeline.py. The flagship
MIMOcom (6 agents, ``query_size`` 32, ``key_size`` 1024) in bf16 from the
seeded init (``models.init_weights``) evaluates ``n_batches`` seeded
in-memory batches in ``activated`` mode through ``Evaluator._pipelined``
(on the card each batch is a replay of the eval step's CUDA graph: K2
``comm_fusion`` fuses the pruned graph, K1 ``upsample_argmax`` makes the
class map), with the whole of the host's metric work a batch
(``Evaluator._record``: the readback, the confusion matrices, the bandwidth
and the selection counts). One warm pass at depth 2, then the best of
``reps`` passes at depth 0 (each batch read back before the next is
dispatched) and at depth 2 (``evaluate.PIPELINE_DEPTH``, the depth of every
other eval path). ``--uint8`` (``raw_uint8``) hands the evaluator raw uint8
frames that it normalizes on the device (``data.on_device_normalize``): a
quarter of the bytes through the host.

Prints the JAX script's three lines, then one JSON line: frames/s at each
depth, the speedup, K1's and K2's launches in each timed pass (on the card
once a batch each, on the bf16 route, or the script raises) and the card's
name and power limit. A frame is one agent's view. The confusion matrices,
the bandwidth and the selection counts of the two depths must be equal, or
the script raises. ``main`` returns ``(sync seconds, pipelined seconds)``,
as the JAX script's does. Entry points run on the card unless ``--device
cpu`` (``--tiny``, the test hook: 64x64 frames, batch 1, 3 batches, one
pass a depth); without a card that raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from multiagentperception_tpu_torch import bench
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.evaluate import N_CLASSES, PIPELINE_DEPTH, Evaluator
from multiagentperception_tpu_torch.metrics import runningScore
from multiagentperception_tpu_torch.models import init_weights

SEED = 0
DTYPE = "bfloat16"
TINY = {"batch": 1, "img": 64, "n_batches": 3, "reps": 1}


def config(batch: int, img: int, agents: int, raw_uint8: bool) -> dict:
    """The JAX script's config (scripts/bench_eval_pipeline.py:34-41)."""
    return normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": agents, "query_size": 32,
                  "key_size": 1024, "multiple_output": True, "dtype": DTYPE},
        "data": {"img_rows": img, "img_cols": img, "commun_label": "mimo",
                 "target_view": "6agent", "on_device_normalize": raw_uint8},
        "training": {"batch_size": batch},
    })


def seeded_batches(batch: int, img: int, agents: int, n_batches: int,
                   raw_uint8: bool) -> list[tuple]:
    """``n_batches`` (images, labels, commun_label) batches from one seeded
    generator: float32 or raw uint8 frames, random labels, and agents 0
    and 1 of every sample noisy (scripts/bench_eval_pipeline.py:47-57)."""
    rng = np.random.default_rng(SEED)
    shape = (batch, agents, img, img)
    batches = []
    for _ in range(n_batches):
        if raw_uint8:
            images = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        else:
            images = rng.standard_normal(shape + (3,), dtype=np.float32)
        labels = rng.integers(0, N_CLASSES, shape, dtype=np.uint8)
        commun = np.zeros((batch, 2, agents), np.int64)
        commun[:, 0, :2] = 1  # two "noisy" agents
        batches.append((images, labels, commun))
    return batches


def _tallies(metrics: runningScore) -> dict:
    """What a pass records: the three confusion matrices, the bandwidth
    and the selection counts."""
    return {"hist": metrics.confusion_matrix, "hist_pos": metrics.confusion_matrix_pos,
            "hist_neg": metrics.confusion_matrix_neg, "total_bandW": metrics.total_bandW,
            "count": metrics.count, "total_agent": metrics.total_agent,
            "correct_when2com": metrics.correct_when2com,
            "correct_who2com": metrics.correct_who2com}


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def run_pass(ev: Evaluator, batches: list, depth: int) -> tuple[float, dict, dict]:
    """One pass over ``batches`` at ``depth``: its seconds, its tallies,
    and K1's and K2's launches in it."""
    bench._zero_launches()
    metrics = runningScore(N_CLASSES)
    t0 = time.perf_counter()
    for res, commun_label in ev._pipelined(batches, depth=depth, inference="activated"):
        ev._record(metrics, res, commun_label)
    seconds = time.perf_counter() - t0
    launches = {kern.__name__: kern.launches for kern in bench.EVAL_KERNELS}
    if ev.device.type == "cuda":
        bench._check_launches(len(batches), DTYPE)
    return seconds, _tallies(metrics), launches


def measure(batch: int = 16, img: int = 512, agents: int = 6, n_batches: int = 6,
            reps: int = 3, raw_uint8: bool = False, device=None) -> dict:
    """The warm pass, then the best of ``reps`` at depth 0 and at depth
    ``PIPELINE_DEPTH``; raises if the two depths' tallies differ. Returns
    the JSON line's record."""
    ev = Evaluator(config(batch, img, agents, raw_uint8), device)
    init_weights(ev.model, SEED)
    batches = seeded_batches(batch, img, agents, n_batches, raw_uint8)
    run_pass(ev, batches, PIPELINE_DEPTH)  # warm: cuDNN, the graph's capture
    best, tallies, launches = {}, {}, {}
    for depth in (0, PIPELINE_DEPTH):
        for _ in range(reps):
            seconds, tallies[depth], launches[depth] = run_pass(ev, batches, depth)
            best[depth] = min(best.get(depth, seconds), seconds)
    if not _same(tallies[0], tallies[PIPELINE_DEPTH]):
        raise AssertionError(f"depth 0 and depth {PIPELINE_DEPTH} recorded different "
                             f"metrics: {tallies}")
    frames = batch * agents * n_batches
    sync, asyn = best[0], best[PIPELINE_DEPTH]
    return {"tag": "uint8+device-norm" if raw_uint8 else "f32", "batch": batch, "img": img,
            "agents": agents, "n_batches": n_batches, "reps": reps, "dtype": DTYPE,
            "raw_uint8": raw_uint8, "device": ev.device.type, "frames": frames,
            "sync_s": sync, "async_s": asyn, "depth": PIPELINE_DEPTH,
            "sync_frames_per_s": frames / sync, "async_frames_per_s": frames / asyn,
            "speedup": sync / asyn,
            "launches_per_pass": {f"depth{d}": launches[d] for d in launches},
            "bandwidth": tallies[0]["total_bandW"] / max(tallies[0]["count"], 1),
            "card": bench._card_line() if ev.device.type == "cuda" else None}


def main(batch: int = 16, img: int = 512, agents: int = 6, n_batches: int = 6, reps: int = 3,
         raw_uint8: bool = False, device=None) -> tuple[float, float]:
    """Measure, print the JAX script's three lines and the JSON line;
    returns ``(sync, pipelined)`` seconds."""
    r = measure(batch, img, agents, n_batches, reps, raw_uint8, device)
    tag, frames, sync, asyn = r["tag"], r["frames"], r["sync_s"], r["async_s"]
    print(f"[{tag}] sync  (depth=0): {sync:.3f}s  {frames / sync:7.1f} frames/s")
    print(f"[{tag}] async (depth={PIPELINE_DEPTH}): {asyn:.3f}s  {frames / asyn:7.1f} frames/s")
    print(f"[{tag}] speedup: {sync / asyn:.2f}x")
    print(json.dumps(r), flush=True)
    return sync, asyn


def _cli(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--uint8", action="store_true",
                        help="raw uint8 frames, normalized on the device")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--device", default=None, help="default: the card")
    parser.add_argument("--tiny", action="store_true",
                        help="64x64 frames, batch 1, 3 batches, one pass a depth "
                        "(the CPU test hook)")
    args = parser.parse_args(argv)
    shape = dict(TINY) if args.tiny else {"batch": args.batch}
    main(raw_uint8=args.uint8, device=args.device, **shape)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
