"""Bench of K3, the fused eval-mode ResNet basic block, on the card
(counterpart of the repo's scripts/bench_fused_block.py).

    python -m multiagentperception_tpu_torch.bench_fused_block [--batch 120] [--iters 20]
        [--dtype bfloat16|float32] [--layers layer1,layer2]

Geometries are the flagship's stride-1 blocks: layer1 (C=64 at 128x128) and
layer2 (C=128 at 64x64) by default, layer3 (C=256 at 32x32) and layer4
(C=512 at 16x16) on request, at B*N = 120 frames (batch 20 x 6 agents),
bfloat16 by default, seeded inputs. For each it prints one JSON line: the
route the wrapper takes (``fused_block.route``: ``wgmma`` for bfloat16 and
``tf32x3`` for float32 at C 64/128, ``wgmma_conv`` and ``tf32x3_conv`` at
C 256/512), the kernel's median time over ``--iters`` launches timed by
CUDA events after a warm-up, its TF/s, the least time the card could take
(``bound_ms``: the larger of the bytes of x, out and the weights over
3.35 TB/s and the block's 4*B*H*W*9*C^2 operations at the peak for the
type: 989 TFLOP/s of bf16 tensor cores, or on the float32 routes three
TF32 products per operation at 495 TFLOP/s; ``bound_by`` says which of
bytes and operations), and the same block as a cuDNN
composition in channels_last ``--dtype`` with BatchNorm folded into the
convolutions (``library_ms``, a yardstick the port never calls; float32
convolutions in TF32 as PyTorch defaults, ``cudnn_tf32``), with
``vs_library`` = library_ms / ms. The JAX script's fori_loop difference
quotient exists for a remote TPU and is not carried over. Runs on the card
only: without one it raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from multiagentperception_tpu_torch.device import resolve_device
from multiagentperception_tpu_torch.ops.kernels import fused_block as k3

GEOMETRIES = {"layer1": (64, 128), "layer2": (128, 64), "layer3": (256, 32),
              "layer4": (512, 16)}  # name: (C, H = W)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor cores
TF32_FLOP_PER_S = 495e12   # dense TF32 tensor cores


def block_inputs(b: int, h: int, w: int, c: int, dtype, device, seed: int = 0):
    """Seeded x (B, H, W, C) in ``dtype``, HWIO weights (0.05 * normal) and
    folded BatchNorms of random statistics, on ``device``."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731

    def bn():
        return k3.fold_bn(f32(rng.uniform(0.5, 1.5, c)), f32(rng.normal(size=c) * 0.1),
                          f32(rng.normal(size=c) * 0.1), f32(rng.uniform(0.5, 1.5, c)))

    x = f32(rng.normal(size=(b, h, w, c))).to(dtype)
    w1, w2 = (f32(rng.normal(size=(3, 3, c, c)) * 0.05) for _ in range(2))
    (s1, b1), (s2, b2) = bn(), bn()
    return x, (w1, s1, b1, w2, s2, b2)


def cudnn_block(x, w1, s1, b1, w2, s2, b2):
    """The block as cuDNN convolutions on channels_last ``x.dtype`` tensors,
    BatchNorm folded into the weights and the conv bias, as a deployed
    block runs: a yardstick of speed only (it rounds at other points)."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory

    def conv(v, w, s, b):
        w = (w * s).to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return F.conv2d(v, w, b.to(x.dtype), padding=1)

    y = torch.relu_(conv(xc, w1, s1, b1))
    return torch.relu_(conv(y, w2, s2, b2).add_(xc))


def block_ops(x: torch.Tensor) -> int:
    b, h, w, c = x.shape
    return 4 * b * h * w * 9 * c * c


def bound_ms(x: torch.Tensor) -> tuple[float, str]:
    """The least time for one block on ``x``: bytes (x and out once, the two
    weights, four (C,) vectors) or operations at the peak of the tensor
    cores that K3's routes use: bf16, or for float32 three TF32 products per
    operation (the tf32x3 routes' arithmetic)."""
    c, item = x.shape[-1], x.element_size()
    moved = 2 * x.numel() * item + 2 * 9 * c * c * item + 4 * c * 4
    if x.dtype == torch.bfloat16:
        t_ops = block_ops(x) / BF16_FLOP_PER_S
    else:
        t_ops = 3 * block_ops(x) / TF32_FLOP_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, t_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=120, help="B*N frames")
    parser.add_argument("--iters", type=int, default=20, help="timed launches (>= 20)")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--layers", default="layer1,layer2",
                        help=f"comma-separated, of {', '.join(GEOMETRIES)}")
    args = parser.parse_args(argv)
    layers = args.layers.split(",")
    unknown = sorted(set(layers) - set(GEOMETRIES))
    if unknown:
        parser.error(f"unknown layers {unknown}")
    dtype = getattr(torch, args.dtype)
    device = resolve_device(None)
    records = []
    for name in layers:
        c, hw = GEOMETRIES[name]
        x, params = block_inputs(args.batch, hw, hw, c, dtype, device)
        ms = time_ms(lambda: k3.fused_basic_block(x, *params), max(args.iters, 20))
        lib_ms = time_ms(lambda: cudnn_block(x, *params), max(args.iters, 20))
        bound, bound_by = bound_ms(x)
        rec = {"bench": "fused_basic_block", "geometry": name, "shape": list(x.shape),
               "dtype": args.dtype, "route": k3.route(dtype, c), "ms": ms,
               "tflops": block_ops(x) / ms / 1e9,
               "library_ms": lib_ms, "library_tflops": block_ops(x) / lib_ms / 1e9,
               "vs_library": lib_ms / ms, "bound_ms": bound, "bound_by": bound_by,
               "cudnn_tf32": torch.backends.cudnn.allow_tf32,
               "device": torch.cuda.get_device_name(device)}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
