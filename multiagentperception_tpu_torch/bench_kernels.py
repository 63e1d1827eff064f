"""Event timing of the port's small kernels, and the harness that times them.

``time_ms`` is the timer behind every kernel's "ms" in ``chip_smoke.py``:
the median of CUDA-event timed runs, L2 flushed before each, with a spin
kernel of ``lead_cycles`` ahead of each start event so that a wrapper's
host side (its checks and launches, tens of microseconds) is enqueued
before the card reaches the start. ``lead_cycles=0`` is the harness
without the lead, which times a call whose host side outlasts its kernel
as the host's.

Run as a script on the card, it times K4 ``int8_conv`` at each of the
flagship's 16 int8 conv shapes (``K4_SHAPES``, batch 20 x 6, float32, bf16
and float16 networks), K1 ``upsample_argmax`` and K2 ``comm_fusion``
(float32, bf16 and float16) at the shapes ``chip_smoke.py`` times them, and
K2 at the agent-count sweep's N = 24 and 48 (``bench_agents``: 256x256,
B*N = 96; the wide design) and at 24 agents of 512x512 value maps, batch 2
(phase 18 (d)'s, the float32 wide record's), each with the lead and without
it:

    python -m multiagentperception_tpu_torch.bench_kernels [--iters 20] [--label NAME]

It calls only the kernels' public wrappers, so it also times an earlier
checkout of the port: copy this file into that checkout's package and run
it there. A network dtype that the checkout's K1, K2 or K4 route tables
lack is skipped, with a line that says so, and so is K2 beyond 16 agents
in a checkout whose K2 has no ``plan`` (it took at most 16).

It prints one JSON line per (kernel, network dtype, shape) with both
times, then one line per K4 network dtype with the sums over an eval
step's 48 convolutions, and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

L2_FLUSH_BYTES = 256 * 2**20  # > the 50 MB L2: each timed launch starts cold
HOST_LEAD_CYCLES = 400_000  # ~0.2 ms of the card's clock, ahead of each timed run
# the flagship's int8 convolutions per eval step (both towers and the decoder),
# as (Cin, Cout, input side, kernel, stride, padding, bias, calls per step)
K4_SHAPES = (
    (3, 64, 512, 7, 2, 3, False, 2),      # the stems
    (64, 64, 128, 3, 1, 1, False, 8),     # layer1
    (64, 128, 128, 3, 2, 1, False, 2), (64, 128, 128, 1, 2, 0, False, 2),
    (128, 128, 64, 3, 1, 1, False, 6),
    (128, 256, 64, 3, 2, 1, False, 2), (128, 256, 64, 1, 2, 0, False, 2),
    (256, 256, 32, 3, 1, 1, False, 6),
    (256, 512, 32, 3, 2, 1, False, 2), (256, 512, 32, 1, 2, 0, False, 2),
    (512, 512, 16, 3, 1, 1, False, 6),
    (512, 512, 16, 3, 1, 1, True, 3),     # the squeezers, PolicyNet4 conv1
    (512, 256, 16, 3, 1, 1, True, 2),     # PolicyNet4 conv2, SimpleDecoder's 512->256
    (256, 256, 16, 3, 2, 1, True, 1), (256, 256, 8, 3, 1, 1, True, 1),
    (256, 256, 8, 3, 2, 1, True, 1))      # PolicyNet4 conv3-5
NETWORKS = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
# K2 beyond 16 agents: (batch, agents, value map) as bench_agents runs it
# (B*N = 96 at 256x256), and 24 agents at 512x512, batch 2
WIDE_SHAPES = ((4, 24, (512, 8, 8)), (2, 48, (512, 8, 8)), (2, 24, (512, 16, 16)))


def time_ms(fn, iters: int = 50, lead_cycles: int = HOST_LEAD_CYCLES) -> float:
    """Median device time of ``fn`` by CUDA events, L2 flushed before each
    run and a spin kernel of ``lead_cycles`` (none at 0) ahead of each
    start event."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _both(fn, iters: int) -> dict:
    return {"lead_ms": time_ms(fn, iters), "no_lead_ms": time_ms(fn, iters, lead_cycles=0)}


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20, help="timed runs a reading")
    parser.add_argument("--label", default="", help="a name for the checkout, echoed per line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from multiagentperception_tpu_torch.bench import BATCH
    from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
    from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1

    def emit(row: dict) -> None:
        print(json.dumps({"label": args.label, **row}), flush=True)

    gen = torch.Generator().manual_seed(0)
    n = BATCH * 6  # the bench's frames of 6 agents
    for network, dtype in NETWORKS.items():
        if not all(dtype in table for table in (k1.ROUTES, k2.ROUTES, k4.QUANTIZE)):
            emit({"network": network, "skipped": "no route for this dtype in this checkout"})
            continue
        step = {"lead_ms": 0.0, "no_lead_ms": 0.0}
        for cin, cout, side, k, stride, pad, has_bias, calls in K4_SHAPES:
            x = torch.randn(n, cin, side, side, generator=gen).to(
                "cuda", torch.float32 if cin == 3 else dtype)
            w = k4.prepare_weight(
                (torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5).to("cuda"))
            bias = torch.randn(cout, generator=gen).to("cuda") if has_bias else None
            s_x = torch.tensor(0.8 * float(x.float().abs().amax()) / 127, device="cuda")
            times = _both(lambda: k4.int8_conv(x, w, s_x, bias, stride, pad, out_dtype=dtype),
                          args.iters)
            for key in step:
                step[key] += calls * times[key]
            emit({"kernel": "int8_conv", "network": network, "calls_per_step": calls,
                  "shape": f"({n}, {cin}, {side}, {side}) {k}x{k}/{stride} pad {pad} -> {cout}"
                           + (" +bias" if has_bias else ""), **times})
            del x, w
        emit({"kernel": "int8_conv", "network": network, "step": True, **step})
        torch.cuda.empty_cache()
        x = torch.randn(12, 11, 16, 16, generator=gen).to("cuda", dtype)
        emit({"kernel": "upsample_argmax", "network": network,
              "shape": "(12, 11, 16, 16) -> (12, 512, 512)",
              **_both(lambda: k1.upsample_argmax(x, 512, 512), 50)})
        q = torch.randn(2, 6, 1024, generator=gen).to("cuda", dtype)
        kk = (torch.randn(2, 6, 1024, generator=gen) * 2 / 32).to("cuda", dtype)
        v = torch.randn(2, 6, 512, 16, 16, generator=gen).to("cuda", dtype)
        emit({"kernel": "comm_fusion", "network": network,
              "shape": "q', k (2, 6, 1024); V (2, 6, 512, 16, 16), activated",
              **_both(lambda: k2.comm_fusion(q, kk, v, mode="activated", diag_bias=0.001), 50)})
        for b, agents, rest in WIDE_SHAPES:
            q = torch.randn(b, agents, 1024, generator=gen).to("cuda", dtype)
            kk = (torch.randn(b, agents, 1024, generator=gen) * 4 / 32).to("cuda", dtype)
            v = torch.randn(b, agents, *rest, generator=gen).to("cuda", dtype)
            row = {"kernel": "comm_fusion", "network": network,
                   "shape": f"q', k ({b}, {agents}, 1024); V {tuple(v.shape)}, activated"}
            if not hasattr(k2, "plan"):  # an earlier checkout: K2 took at most 16 agents
                emit({**row, "skipped": "this checkout's K2 takes at most 16 agents"})
                continue
            m = v[0, 0].numel()
            emit({**row, "design": k2.plan(b, agents, 1024, m, dtype),
                  **_both(lambda: k2.comm_fusion(q, kk, v, mode="activated",
                                                 diag_bias=0.001), 50)})
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
