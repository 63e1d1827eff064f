"""Benchmark of the flagship on the card (counterpart of the repo's bench.py).

    python -m multiagentperception_tpu_torch.bench [--dtype float32]
        [--sweep | --sweep-train | --latency] [--tiny] [--device cpu]

Measures the flagship mrms_when2com model (MIMOcom, 6 agents at 512x512,
``query_size`` 32, ``key_size`` 1024, multiple outputs) from the seeded
init ``models.init_weights(model, 0)``, on seeded inputs made with numpy
``default_rng(0)`` and put on the device before any timing, in
``--dtype`` (default ``bfloat16``, the JAX bench's ``use_bf16=True``):

- **eval**, batch 20 (bench.py:382): the ``activated`` forward to the
  decoder's pre-upsample logits, the class map by K1 ``upsample_argmax``
  (as ``Evaluator.predict`` makes it), and the confusion matrix against
  the labels; the pruned fusion runs K2 ``comm_fusion``. On the card both
  kernels must launch once per step on the dtype's route, or the bench
  fails. Frames are ``normal`` in the compute dtype (bench.py:153-156).
- **train**, batch 20: one step of the forward in training mode, the loss,
  the backward and Adam at 1e-5 (bench.py:208-263), on float32 frames.
  ``remat`` (``model.remat``) checkpoints the two towers.
- **int8 eval** (bench.py:126-175, :408-414): the same eval step with
  every eligible convolution of the towers and the decoder in int8
  (``quantize.Int8Convs``; K4 ``int8_conv`` on the card, once per swapped
  conv call, or the bench fails), its activation scales calibrated on the
  bench's own frames (bench.py:158-162); the network dtype stays
  ``--dtype`` around them. ``eval_int8_speedup`` is its frames/s over the
  eval step's.
- **MFU**: the model's FLOPs per step over the step time and the card's
  published dense peak for the dtype (``_device_peak_flops``).

Method (``_amortized_device_time``): (t(K_hi) - t(K_lo)) / (K_hi - K_lo),
each t a host clock around K back-to-back steps that ends in
``torch.cuda.synchronize()``, the minimum of three runs taken in turns
with the other length's, after a warm-up run of each.
This is the step as eager PyTorch runs it, the host's launches included:
where the host launches slower than the card computes, the step time is
the host's. So beside it the bench traces K_hi steps once more under
``torch.profiler`` and reports the device time per step (kernels and
copies) and the busy share, device time over the untraced K_hi window's
wall time; and the peak device memory of the timed runs.

FLOPs (``count_flops``): ``torch.utils.flop_counter.FlopCounterMode`` over
the float32 plain function at the bench's shapes on the ``meta`` device,
once per shape, outside the timed window: the same count whatever route,
kernel or dtype runs the step. Eval counts the ``activated`` forward at
full resolution (the x32 resize that K1 folds away included, as the JAX
bench's XLA count has it) and K2's products through its plain version;
the argmax and the histogram count no multiply-adds. Train counts the
forward and the backward; Adam's elementwise update is not counted. The
count is **dense** (``flops_convention``): every tap of a convolution,
those on the zero padding too, which cuDNN and the K3 routes compute. XLA's
``cost_analysis()`` counts only the taps inside the input; the bench
prints that padding-free count beside the dense one (``*_padfree``), so
its MFU can be set beside the JAX bench's ``eval_mfu_pct``.

Prints one JSON line last (bench.py:431-443's keys that apply, and the
device time, busy share, peak memory, dtype, peak and power limit). On the
CPU (``--device cpu``, the test hook with ``--tiny``) the keys that only
the card can give are absent (``DEVICE_ONLY_KEYS``). Any failure raises:
nothing falls back to another timing or device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.device import resolve_device
from multiagentperception_tpu_torch.loss import cross_entropy2d
from multiagentperception_tpu_torch.models import get_model, init_weights
from multiagentperception_tpu_torch.ops.comm import confusion_matrix
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from multiagentperception_tpu_torch.optimizers import get_optimizer
from multiagentperception_tpu_torch.quantize import Int8Convs, calibrate_activations

N_CLASSES = 11
SEED = 0
BATCH = 20  # the JAX bench's main() batch for eval and training (bench.py:382, :208)
LR = 1e-5
# published dense peaks by torch.cuda.get_device_name (NVIDIA data sheet, SXM
# part at 700 W): bf16 and float16 tensor cores, and TF32 for float32, whose
# convolutions cuDNN runs in TF32 (PyTorch's default)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12,
                                         "float32": 495e12}}
# the kernels of the eval step, each with the route of each dtype
EVAL_KERNELS = (k1.upsample_argmax, k2.comm_fusion)
ROUTE = {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}
# keys only a card can give: absent from a CPU run's JSON line
DEVICE_ONLY_KEYS = ("peak_tflops", "power_limit_w", "eval_mfu_pct", "eval_device_ms",
                    "eval_busy_pct", "eval_peak_gb", "eval_route_launches",
                    "eval_kernel_device_ms", "eval_int8_device_ms", "eval_int8_busy_pct",
                    "eval_int8_route_launches", "eval_int8_kernel_device_ms", "train_mfu_pct",
                    "train_device_ms", "train_busy_pct", "train_peak_gb")
TOP_KERNELS = 10  # the device kernels a trace reports, by time


def _config(img: int, agents: int, dtype: str = "float32", remat: bool = False) -> dict:
    """bench.py:80-85's configuration, in the port's schema."""
    return normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": agents, "query_size": 32,
                  "key_size": 1024, "multiple_output": True, "remat": remat,
                  "dtype": dtype},
        "data": {"img_rows": img, "img_cols": img},
    })


def _build(img: int, agents: int, dtype: str, device: torch.device, train: bool = False,
           remat: bool = False) -> torch.nn.Module:
    """The flagship from ``init_weights(model, SEED)`` on ``device``, in
    training or eval mode."""
    model = init_weights(get_model(_config(img, agents, dtype, remat), N_CLASSES), SEED)
    return model.to(device).train(train)


@functools.lru_cache(maxsize=1)
def _host_inputs(batch: int, img: int, agents: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded float32 frames ``(B, N, H, W, 3)`` and uint8 labels
    ``(B*N, H, W)`` on the host, made once per shape (seconds at the
    bench's: every reading of a run shares them; callers copy, never write)."""
    rng = np.random.default_rng(SEED)
    xs = rng.normal(size=(batch, agents, img, img, 3)).astype(np.float32)
    return xs, rng.integers(0, N_CLASSES, size=(batch * agents, img, img)).astype(np.uint8)


def _inputs(batch: int, img: int, agents: int, dtype: torch.dtype, device: torch.device):
    """The seeded frames in ``dtype`` and the labels, on ``device``."""
    xs, ys = _host_inputs(batch, img, agents)
    return torch.from_numpy(xs).to(device, dtype), torch.from_numpy(ys).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


TIMED_PAIRS = 3  # timed runs of each loop length, interleaved


def _amortized_device_time(run, k_lo: int, k_hi: int, device: torch.device):
    """Seconds per step from two loop lengths, and the wall seconds of the
    K_hi run. ``run(k)`` runs k back-to-back steps; each length is run once
    to warm up, then TIMED_PAIRS times each, the two lengths in turns, host
    clock to ``synchronize``, and each length's fastest run kept. Taking
    turns keeps a stretch of contention on a shared host (the CPU hook
    under the test runner's workers) from slowing one length's every run.
    The step is eager PyTorch's, host launches included; ``_trace`` gives
    the device's share of it."""
    def timed(k: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        run(k)
        _sync(device)
        return time.perf_counter() - t0

    run(k_lo)
    run(k_hi)
    pairs = [(timed(k_lo), timed(k_hi)) for _ in range(TIMED_PAIRS)]
    t_lo, t_hi = (min(t) for t in zip(*pairs))
    step = (t_hi - t_lo) / (k_hi - k_lo)
    if not step > 0:
        raise RuntimeError(f"amortized step time {step} s from t({k_lo}) = {t_lo} s and "
                           f"t({k_hi}) = {t_hi} s: the measurement failed")
    return step, t_hi


def _trace(run, k: int, device: torch.device, kernels=()) -> dict:
    """k steps once more under ``torch.profiler``: the device time per step
    (kernels and copies, without the ranges that ``record_function``
    annotations draw over them), the TOP_KERNELS largest kernels per step,
    and each of ``kernels``' device time per launch (``<wrapper>_kernel``
    in csrc)."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(k)
        _sync(device)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        raise RuntimeError("the profiler recorded no device time")
    per_launch = {kern.__name__: device_ms_per_call(events, kern) for kern in kernels}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:TOP_KERNELS]
    return {"device_ms": sum(e.self_device_time_total for e in events) / 1e3 / k,
            "kernel_device_ms": per_launch,
            "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3 / k for e in top}}


def device_ms_per_call(events, kern) -> float:
    """Device ms per call of the kernel wrapper ``kern`` in a trace's device
    events: the time of every kernel one call launches over the calls. A
    call launches ``<wrapper>_kernel`` (csrc) unless the wrapper names its
    kernels in ``device_kernels``, each with 1 where it runs once a call on
    its own path (K2's wide design launches a graph and a fusion kernel):
    the calls are counted by those. Raises if the trace holds no call."""
    names = getattr(kern, "device_kernels", {f"{kern.__name__}_kernel": 1})
    ms = calls = 0.0
    for e in events:
        weight = next((w for name, w in names.items() if name in e.key), None)
        if weight is not None:
            ms += e.self_device_time_total / 1e3
            calls += weight * e.count
    if not calls:
        raise RuntimeError(f"the trace holds no launch of {kern.__name__}")
    return ms / calls


# ------------------------------------------------------------------ FLOPs

def _valid_taps(size: int, out: int, k: int, stride: int, pad: int, dil: int) -> int:
    """(output, kernel tap) pairs along one axis whose input lies inside the
    input, not on its padding."""
    return sum(0 <= o * stride - pad + j * dil < size for o in range(out) for j in range(k))


def padfree_conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation) -> int:
    """2 x the multiply-adds of a convolution over the taps that fall inside
    the input (XLA's ``cost_analysis`` convention; tests/test_torch_bench.py
    holds it equal to XLA's per convolution)."""
    taps = math.prod(_valid_taps(*dims) for dims in zip(
        x_shape[2:], out_shape[2:], w_shape[2:], stride, padding, dilation))
    c_out, c_in_per_group = w_shape[:2]
    return 2 * x_shape[0] * c_out * c_in_per_group * taps


def _counter() -> tuple[FlopCounterMode, list[int]]:
    """A FlopCounterMode with PyTorch's (dense) formulas, and a one-element
    list that it fills with the FLOPs of the convolution taps on padding:
    the dense count less those is the padding-free count. A backward
    counts the forward's taps once for each gradient it computes (input,
    weight), as PyTorch's formula does."""
    padded = [0]

    def count(x_shape, w_shape, out_shape, stride, padding, dilation, transposed, grads=1):
        if transposed:
            raise NotImplementedError("padding-free count of a transposed convolution")
        dense = conv_flop_count(x_shape, w_shape, out_shape) * grads
        free = padfree_conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation)
        padded[0] += dense - free * grads
        return dense

    def conv(x_shape, w_shape, bias, stride, padding, dilation, transposed, *args,
             out_shape=None, **kwargs):
        return count(x_shape, w_shape, out_shape, stride, padding, dilation, transposed)

    def conv_backward(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                      transposed, output_padding, groups, output_mask, out_shape=None,
                      **kwargs):
        return count(x_shape, w_shape, grad_out_shape, stride, padding, dilation, transposed,
                     grads=int(output_mask[0]) + int(output_mask[1]))

    aten = torch.ops.aten
    mode = FlopCounterMode(display=False, custom_mapping={
        aten.convolution: conv, aten.convolution_backward: conv_backward})
    return mode, padded


@functools.lru_cache(maxsize=None)
def count_flops(batch: int, img: int, agents: int, train: bool) -> tuple[int, int]:
    """(dense, padding-free) FLOPs of one eval or train step of the float32
    plain function at these shapes, counted on the ``meta`` device."""
    meta = torch.device("meta")
    with meta:
        model = get_model(_config(img, agents), N_CLASSES).train(train)
        x = torch.empty(batch, agents, img, img, 3)
        labels = torch.empty(batch * agents, img, img, dtype=torch.uint8)
    counter, padded = _counter()
    with counter:
        if train:
            cross_entropy2d(model(x)[0], labels).backward()
        else:
            model(x, inference="activated")[0].argmax(1)
    dense = counter.get_total_flops()
    return dense, dense - padded[0]


def _device_peak_flops(dtype: str, device: torch.device):
    """(device kind, published dense peak FLOP/s for ``dtype`` or None)."""
    if device.type != "cuda":
        return "cpu", None
    kind = torch.cuda.get_device_name(device)
    peak = PEAK_FLOPS.get(kind, {}).get(dtype)
    if peak is None:
        print(f"no published peak for {kind!r} in {dtype}: MFU left out", file=sys.stderr)
    return kind, peak


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _power_limit_w() -> float:
    return float(_card_line().rsplit(",", 1)[1].strip().split()[0])


# ------------------------------------------------------------------ eval

def eval_step(model: torch.nn.Module, x: torch.Tensor, labels: torch.Tensor,
              hist: torch.Tensor) -> torch.Tensor:
    """bench.py:164-173's step, as the port's evaluator computes it: the
    ``activated`` forward to the pre-upsample logits (K2 fuses the pruned
    graph), the class map by K1, the confusion matrix added to ``hist``."""
    pre = model(x, inference="activated", full_res=False)[0]
    pred = k1.upsample_argmax(pre, x.shape[-3], x.shape[-2])
    return hist + confusion_matrix(labels, pred, N_CLASSES)


def _zero_launches(kernels=EVAL_KERNELS) -> None:
    for kern in kernels:
        kern.launches = 0
        kern.route_launches.update(dict.fromkeys(kern.route_launches, 0))


def _check_launches(steps: int, dtype: str, int8_convs: Int8Convs | None = None) -> dict:
    """Each eval kernel launched once per step on ``dtype``'s route, never on
    another; with ``int8_convs``, K4 once per swapped conv call."""
    route = ROUTE[dtype]
    counts = {kern.__name__: dict(kern.route_launches) for kern in EVAL_KERNELS}
    for name, by_route in counts.items():
        if by_route != {**dict.fromkeys(by_route, 0), route: steps}:
            raise AssertionError(f"{name} did not launch its {route} route once per eval "
                                 f"step ({steps} steps): {by_route}")
    if int8_convs is not None:
        counts[k4.int8_conv.__name__] = dict(k4.int8_conv.route_launches)
        if k4.int8_conv.launches != int8_convs.calls or int8_convs.calls % steps:
            raise AssertionError(f"int8_conv launched {k4.int8_conv.launches} times for "
                                 f"{int8_convs.calls} int8 conv calls in {steps} steps")
    return counts


def bench_eval(batch=16, img=512, agents=6, k_lo=2, k_hi=12, dtype="bfloat16",
               device=None, count=True, int8=False) -> dict:
    """The eval step's frames/s and seconds (``fps``, ``step_s``), the steps
    run (``steps``), its FLOPs (``flops``, ``flops_padfree``; None without
    ``count``), and on the card
    the device time per step, the busy share, the peak memory, each
    kernel's launches by route and its device time per launch. ``int8``
    runs the step with its convolutions in int8 (``quantize.Int8Convs``),
    scales calibrated on the step's frames, and adds ``int8_convs`` (the
    int8 conv calls per step)."""
    device = resolve_device(device)
    model = _build(img, agents, dtype, device)
    xs, ys = _inputs(batch, img, agents, getattr(torch, dtype), device)
    steps = [0]
    swap = None
    if int8:
        swap = Int8Convs(model, calibrate_activations(
            model, [xs], inference="activated", full_res=False))

    @torch.inference_mode()
    def run(k: int) -> torch.Tensor:
        # chained through the histogram; eager PyTorch hoists nothing out of
        # the loop, so bench.py's x + 1e-6 * (i + 1) is not needed
        hist = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int64, device=device)
        with swap or contextlib.nullcontext():
            for _ in range(k):
                hist = eval_step(model, xs, ys, hist)
        steps[0] += k
        return hist

    cuda = device.type == "cuda"
    kernels = EVAL_KERNELS + ((k4.int8_conv,) if int8 else ())
    if cuda:
        _zero_launches(kernels)
        torch.cuda.reset_peak_memory_stats(device)
    step_s, wall_hi = _amortized_device_time(run, k_lo, k_hi, device)
    out = {"batch": batch, "fps": batch * agents / step_s, "step_s": step_s,
           "flops": None, "flops_padfree": None}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        traced = _trace(run, k_hi, device, kernels)
        out.update(traced, busy=traced["device_ms"] * k_hi / (wall_hi * 1e3),
                   route_launches=_check_launches(steps[0], dtype, swap))
    out["steps"] = steps[0]  # every step run: warm-up, timed and traced
    if swap is not None:
        out["int8_convs"] = swap.calls // steps[0]
    if count:
        out["flops"], out["flops_padfree"] = count_flops(batch, img, agents, False)
    return out


def bench_eval_dispatch(batch=16, img=512, agents=6, iters=10, dtype="bfloat16",
                        device=None) -> float:
    """Seconds of one eval step called alone with the histogram read back
    to the host, the fastest of ``iters`` calls after one warm-up: a reading
    of its own (per-call latency), never a stand-in for ``bench_eval``."""
    device = resolve_device(device)
    model = _build(img, agents, dtype, device)
    xs, ys = _inputs(batch, img, agents, getattr(torch, dtype), device)
    zero = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int64, device=device)

    @torch.inference_mode()
    def call() -> np.ndarray:
        return eval_step(model, xs, ys, zero).cpu().numpy()

    call()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return min(times)


# ------------------------------------------------------------------ train

def bench_train(batch=20, img=512, agents=6, k_lo=1, k_hi=6, dtype="bfloat16", remat=False,
                device=None, count=True) -> dict:
    """The train step's frames/s and seconds, its FLOPs (forward and
    backward), and on the card the device time, busy share and peak
    memory, as ``bench_eval`` returns them."""
    device = resolve_device(device)
    model = _build(img, agents, dtype, device, train=True, remat=remat)
    opt = get_optimizer({"training": {"optimizer": {"name": "adam", "lr": LR}}},
                        model.parameters())
    xs, ys = _inputs(batch, img, agents, torch.float32, device)  # bench.py:225-227

    def run(k: int) -> torch.Tensor:
        acc = torch.zeros((), device=device)
        for _ in range(k):
            opt.zero_grad(set_to_none=True)
            loss = cross_entropy2d(model(xs)[0], ys)
            loss.backward()
            opt.step()
            acc = acc + loss.detach()
        return acc

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    step_s, wall_hi = _amortized_device_time(run, k_lo, k_hi, device)
    out = {"batch": batch, "fps": batch * agents / step_s, "step_s": step_s,
           "flops": None, "flops_padfree": None}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        traced = _trace(run, k_hi, device)
        out.update(traced, busy=traced["device_ms"] * k_hi / (wall_hi * 1e3))
    if count:
        out["flops"], out["flops_padfree"] = count_flops(batch, img, agents, True)
    return out


# ------------------------------------------------------------------ tables

def sweep(batches=(8, 16, 20, 24, 32), dtype="bfloat16", device=None) -> None:
    """Eval fps by batch, one line each to stderr (bench.py:320-334)."""
    device = resolve_device(device)
    kind, peak = _device_peak_flops(dtype, device)
    for b in batches:
        r = bench_eval(batch=b, dtype=dtype, device=device)
        mfu = f"  mfu={r['flops'] / r['step_s'] / peak * 100:.1f}%" if peak else ""
        print(f"batch={b:3d}  step={r['step_s'] * 1000:8.2f} ms  fps={r['fps']:8.1f}"
              f"  fps/frame-batch={r['fps'] / (b * 6):6.2f}{mfu}", file=sys.stderr)


def sweep_train(configs=((2, False), (4, False), (8, False), (16, False), (8, True),
                         (16, True)), dtype="bfloat16", device=None) -> None:
    """Train fps and peak memory by (batch, remat), one line each to
    stderr (bench.py:337-352); peak memory is what remat lowers."""
    device = resolve_device(device)
    for b, remat in configs:
        r = bench_train(batch=b, remat=remat, dtype=dtype, device=device, count=False)
        peak = f"  peak={r['peak_bytes'] / 1e9:6.2f} GB" if "peak_bytes" in r else ""
        print(f"train batch={b:3d} remat={int(remat)}  step={r['step_s'] * 1000:8.2f} ms  "
              f"fps={r['fps']:7.1f}{peak}", file=sys.stderr)


def latency(device=None) -> None:
    """Batch-1 eval latency in bf16 and int8 (bench.py:355-366)."""
    for tag, int8 in (("bf16", False), ("int8", True)):
        r = bench_eval(batch=1, k_lo=4, k_hi=24, dtype="bfloat16", device=device, count=False,
                       int8=int8)
        dt = r["step_s"]
        print(f"latency batch=1 {tag}: {dt * 1000:6.2f} ms/frame-set "
              f"({dt * 1000 / 6:5.2f} ms/frame, {r['fps']:6.1f} f/s)", file=sys.stderr)


# ------------------------------------------------------------------ main

def _record(prefix: str, r: dict, peak: float | None) -> dict:
    """The JSON keys of one bench_eval / bench_train result."""
    rec = {f"{prefix}_step_ms": r["step_s"] * 1e3, f"{prefix}_batch": r["batch"],
           f"{prefix}_tflops_per_step": r["flops"] / 1e12,
           f"{prefix}_tflops_per_step_padfree": r["flops_padfree"] / 1e12,
           f"{prefix}_tflops_per_sec": r["flops"] / r["step_s"] / 1e12}
    if "device_ms" in r:
        rec.update({f"{prefix}_device_ms": r["device_ms"],
                    f"{prefix}_busy_pct": r["busy"] * 100,
                    f"{prefix}_peak_gb": r["peak_bytes"] / 1e9})
    if peak:
        rec[f"{prefix}_mfu_pct"] = r["flops"] / r["step_s"] / peak * 100
    return rec


def main(argv=None) -> dict | None:
    """Run the bench (or a table) and print its JSON line; returns the record."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=tuple(ROUTE), default="bfloat16")
    parser.add_argument("--device", default=None, help="default: the card")
    parser.add_argument("--tiny", action="store_true",
                        help="the same code paths at 64x64, 2 agents, batch 1 (test hook)")
    table = parser.add_mutually_exclusive_group()
    table.add_argument("--sweep", action="store_true", help="eval fps by batch, to stderr")
    table.add_argument("--sweep-train", action="store_true",
                       help="train fps and peak memory by batch and remat, to stderr")
    table.add_argument("--latency", action="store_true", help="batch-1 eval, to stderr")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    card = _card_line() if device.type == "cuda" else "cpu"
    if args.sweep or args.sweep_train or args.latency:
        print(card, file=sys.stderr)
        if args.sweep:
            sweep(dtype=args.dtype, device=device)
        elif args.sweep_train:
            sweep_train(dtype=args.dtype, device=device)
        else:
            latency(device)
        return None

    shape, batch = {}, BATCH
    if args.tiny:
        # two steps apart, not one: on a loaded CPU one step's noise alone can
        # make t(K_hi) - t(K_lo) negative
        shape, batch = dict(img=64, agents=2, k_lo=1, k_hi=3), 1
    kind, peak = _device_peak_flops(args.dtype, device)
    dispatch_s = bench_eval_dispatch(batch=batch, dtype=args.dtype, device=device,
                                     **{k: shape[k] for k in ("img", "agents") if k in shape})
    # after the dispatch reading, so each bench_eval counts only its own
    # launches (each zeroes the counts; the int8 run's are left at the end)
    ev = bench_eval(batch=batch, dtype=args.dtype, device=device, **shape)
    i8 = bench_eval(batch=batch, dtype=args.dtype, device=device, count=False, int8=True,
                    **shape)
    train = bench_train(batch=batch, dtype=args.dtype, device=device, **shape)

    record = {"metric": "eval_frames_per_sec_mrms_when2com_512_activated",
              "value": ev["fps"], "unit": "frames/sec", "dtype": args.dtype,
              "device_kind": kind, "flops_convention": "dense"}
    if device.type == "cuda":
        record["power_limit_w"] = _power_limit_w()
        record["eval_route_launches"] = ev["route_launches"]
        record["eval_kernel_device_ms"] = ev["kernel_device_ms"]
        if peak:
            record["peak_tflops"] = peak / 1e12
    record.update(_record("eval", ev, peak))
    record["eval_steps"] = ev["steps"]
    record["eval_dispatch_ms"] = dispatch_s * 1e3
    record["eval_int8_frames_per_sec"] = i8["fps"]
    record["eval_int8_step_ms"] = i8["step_s"] * 1e3
    record["eval_int8_speedup"] = i8["fps"] / ev["fps"]
    record["eval_int8_steps"] = i8["steps"]
    record["eval_int8_convs_per_step"] = i8["int8_convs"]
    if "device_ms" in i8:
        record["eval_int8_device_ms"] = i8["device_ms"]
        record["eval_int8_busy_pct"] = i8["busy"] * 100
        record["eval_int8_route_launches"] = i8["route_launches"]
        record["eval_int8_kernel_device_ms"] = i8["kernel_device_ms"]
    record["train_frames_per_sec"] = train["fps"]
    record.update(_record("train", train, peak))
    for name, r in (("eval", ev), ("eval_int8", i8), ("train", train)):
        if "top_device_ms" in r:
            print(f"{name} device ms per step by kernel: {json.dumps(r['top_device_ms'])}",
                  file=sys.stderr)
    print(f"{card}: eval {ev['step_s'] * 1e3:.2f} ms/step {ev['fps']:.1f} frames/s, "
          f"int8 eval {i8['step_s'] * 1e3:.2f} ms/step {i8['fps']:.1f} frames/s, "
          f"train {train['step_s'] * 1e3:.2f} ms/step ({args.dtype})", file=sys.stderr)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
