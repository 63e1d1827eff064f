"""Agent-count sweep: MIMOcom eval against N at a fixed number of frames.

    python -m multiagentperception_tpu_torch.bench_agents [--img 256] [--frames 96]
        [--agents 6 12 24 48] [--dtype bfloat16] [--device cpu] [--tiny]

The counterpart of the repo's scripts/bench_agents.py: for each N of
``--agents`` the batch is ``max(frames // N, 1)``, so B*N stays about
``--frames``; the model is MIMOcom at the flagship's widths (512 channels,
``key_size`` 1024, ``query_size`` 32) from the seeded init
(``bench._build``), on seeded numpy frames and labels put on the device
before any timing, in ``--dtype`` (default ``bfloat16``, as the JAX
script). One step is the ``activated`` eval and the confusion matrix
(``bench.eval_step``: K2 ``comm_fusion`` fuses the pruned graph, K1
``upsample_argmax`` makes the class map); its time is
``bench._amortized_device_time`` over 2 and 8 steps, as the JAX script
takes it. The framework's claim (the agent axis folds into the batch) is
that the cost a frame stays flat in N.

Prints the JAX script's table (N, batch, step ms, frames/s, ms/frame, and
the cost a frame against the first N) with, for each N, K1's and K2's
launches a step and K2's design (``comm_fusion.plan``: ``cluster`` up to
16 agents, ``wide`` above). On the card K1 and K2 must launch once a step
and K2 on the planned design only, and the logits must be finite, or the N
fails. On the CPU (``--device cpu``; ``--tiny``, the test hook, runs 64x64
frames, N = 2 and 17) the kernels' plain versions run and count nothing. A
failing N prints its line and the sweep goes on; the exit code is then 1.
Entry points run on the card unless ``--device cpu``; without a card that
raises.
"""

from __future__ import annotations

import argparse
import sys

import torch

from multiagentperception_tpu_torch import bench
from multiagentperception_tpu_torch.device import resolve_device
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2

AGENTS = (6, 12, 24, 48)
FRAMES = 96
IMG = 256
K_LO, K_HI = 2, 8  # scripts/bench_agents.py's loop lengths
KEY_SIZE, FEAT_CHANNEL = 1024, 512  # bench._config's MIMOcom
TINY = {"img": 64, "frames": 17, "agents": (2, 17), "k_lo": 1, "k_hi": 3}


def design_of(batch: int, agents: int, img: int, dtype: str) -> str:
    """K2's design for this N: its value maps are (512, img/32, img/32)."""
    m = FEAT_CHANNEL * (img // 32) ** 2
    return k2.plan(batch, agents, KEY_SIZE, m, getattr(torch, dtype))


def bench_n(agents: int, batch: int, img: int, dtype: str, device: torch.device,
            k_lo: int = K_LO, k_hi: int = K_HI) -> dict:
    """One N: seconds a step, and the kernels' launches and K2's designs
    over every step run (warm-up and timed), held on the card."""
    model = bench._build(img, agents, dtype, device)
    xs, ys = bench._inputs(batch, img, agents, getattr(torch, dtype), device)
    steps = [0]

    @torch.inference_mode()
    def run(k: int) -> torch.Tensor:
        hist = torch.zeros((bench.N_CLASSES, bench.N_CLASSES), dtype=torch.int64,
                           device=device)
        for _ in range(k):
            hist = bench.eval_step(model, xs, ys, hist)
        steps[0] += k
        return hist

    design = design_of(batch, agents, img, dtype)
    bench._zero_launches()
    k2.comm_fusion.design_launches.update(dict.fromkeys(k2.comm_fusion.design_launches, 0))
    step_s, _ = bench._amortized_device_time(run, k_lo, k_hi, device)
    launches = {kern.__name__: kern.launches for kern in bench.EVAL_KERNELS}
    designs = dict(k2.comm_fusion.design_launches)
    if device.type == "cuda":
        bench._check_launches(steps[0], dtype)
        if designs != {**dict.fromkeys(designs, 0), design: steps[0]}:
            raise AssertionError(f"K2 at N={agents} launched by design {designs}, want "
                                 f"{design} once a step ({steps[0]} steps)")
    with torch.inference_mode():
        logits = model(xs, inference="activated", full_res=False)[0]
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"N={agents}: non-finite logits")
    return {"agents": agents, "batch": batch, "step_s": step_s, "steps": steps[0],
            "launches": launches, "designs": designs, "design": design}


def sweep(img: int = IMG, frames: int = FRAMES, agents=AGENTS, dtype: str = "bfloat16",
          device=None, k_lo: int = K_LO, k_hi: int = K_HI) -> list[dict]:
    """Run each N, printing the table as it goes; returns one row per N
    (``ok`` False with the ``error`` for an N that failed)."""
    device = resolve_device(device)
    print(f"# MIMOcom eval, {img}^2, B*N={frames}, {dtype}, activated, {device.type}")
    print(f"{'N':>4} {'batch':>6} {'step ms':>9} {'frames/s':>9} {'ms/frame':>9} "
          f"{'K1/step':>8} {'K2/step':>8} {'K2 design':>10}")
    rows, base = [], None
    for n in agents:
        b = max(frames // n, 1)
        try:
            r = bench_n(n, b, img, dtype, device, k_lo, k_hi)
        except Exception as err:  # reported, and the exit code says so
            print(f"{n:>4} {b:>6}  failed: {err!r}", flush=True)
            rows.append({"agents": n, "batch": b, "ok": False, "error": repr(err)})
            continue
        per = r["step_s"] * 1e3 / (b * n)
        r.update(ok=True, step_ms=r["step_s"] * 1e3, frames_per_s=b * n / r["step_s"],
                 ms_per_frame=per,
                 per_step={name: count / r["steps"] for name, count in r["launches"].items()})
        note = ""
        if base is None:
            base = (per, n)
        else:
            r["vs_first"] = per / base[0]
            note = f"  ({r['vs_first']:.2f}x per-frame cost vs N={base[1]})"
        print(f"{n:>4} {b:>6} {r['step_ms']:>9.2f} {r['frames_per_s']:>9.1f} {per:>9.3f} "
              f"{r['per_step']['upsample_argmax']:>8.2f} {r['per_step']['comm_fusion']:>8.2f} "
              f"{r['design']:>10}{note}", flush=True)
        rows.append(r)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--img", type=int, default=IMG)
    parser.add_argument("--frames", type=int, default=FRAMES,
                        help="total frames per step (B*N held constant)")
    parser.add_argument("--agents", type=int, nargs="*", default=list(AGENTS))
    parser.add_argument("--dtype", choices=tuple(bench.ROUTE), default="bfloat16")
    parser.add_argument("--device", default=None, help="default: the card")
    parser.add_argument("--tiny", action="store_true",
                        help="64x64 frames, N = 2 and 17, 17 frames (the CPU test hook)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    shape = dict(TINY) if args.tiny else {"img": args.img, "frames": args.frames,
                                          "agents": args.agents}
    rows = sweep(dtype=args.dtype, device=device, **shape)
    if device.type == "cuda":
        print(bench._card_line())
    failed = [r["agents"] for r in rows if not r["ok"]]
    if failed:
        print(f"bench_agents: N = {failed} failed", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
