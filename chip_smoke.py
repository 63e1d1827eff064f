#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of when2com on one NVIDIA card, end to end.

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package. Phases; any failure raises
and the script exits non-zero:

1. Kernels. Build K1 (``upsample_argmax``) and K2 (``comm_fusion``) from
   ``multiagentperception_tpu_torch/csrc`` with nvcc for sm_90a, hold each
   against its plain PyTorch version on the card at the flagship shapes,
   and time the kernel, the plain version and one PyTorch library call
   (a yardstick only: the port never calls it). The checks and their
   tolerances are ``ops/kernels/checks.py``'s: K1 agrees on at least
   99.99% of pixels and every disagreement is a near-tie (the plain
   version's top two upsampled logits within 1e-4); an all-equal input
   gives class 0. K2: fused within rtol/atol 1e-5, graphs within 1e-6,
   masks equal, in all three modes.
2. The slice at full width. The flagship MIMOcom
   (``configs/multi-request-multi-support/mrms_when2com.yml``, 6 agents at
   512x512, unchanged) from a seeded init is saved as a reference-format
   ``.pkl``, loaded through ``Evaluator.load_weight`` and evaluated in
   ``activated`` mode over seeded in-memory batches of the loader's
   shapes. Both kernels' launch counts are zeroed just before and read
   just after; each must have launched. Prints eval frames/s (a frame is
   one agent's view) over the timed window, then traces the same batches
   again under ``torch.profiler``: the device's busy share is the traced
   device time over the untraced window's wall time.
3. Card against CPU. The same slice at 256x256 with TF32 off, from one set
   of weights: actions and bandwidth equal, class maps agree on at least
   99.9% of pixels.

Prints the card's ``nvidia-smi`` name and power limit, then the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.evaluate import N_CLASSES, Evaluator
from multiagentperception_tpu_torch.models import get_model, init_weights
from multiagentperception_tpu_torch.ops.kernels import _build, checks
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from multiagentperception_tpu_torch.ops.normalize import normalize_images

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "multi-request-multi-support" / "mrms_when2com.yml"
WORK = ROOT / "multiagentperception_tpu_torch" / "build" / "smoke"
PROFILE_OUT = WORK / "profile.txt"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s outside
# the tensor cores (both kernels use plain FMAs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
L2_FLUSH_BYTES = 256 * 2**20  # > the 50 MB L2: each timed launch starts cold

SEED = 0
EVAL_BATCHES = 10  # timed; two more warm up cuDNN and the caching allocator
DIAG_BIAS = 0.001
THRES = 0.2


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _time_ms(fn, iters: int = 50) -> float:
    """Median device time of ``fn`` by CUDA events, L2 flushed before each run."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1

def check_upsample_argmax(gen) -> dict:
    n, c, h, w, out = 12, 11, 16, 16, 512  # B*N decoder logits at 512x512
    x = torch.randn(n, c, h, w, generator=gen).to("cuda")
    checked = checks.check_upsample_argmax(x, out, out)

    def library():
        return torch.nn.functional.interpolate(
            x, size=(out, out), mode="bilinear", align_corners=False).argmax(1)

    taps_bytes = 2 * (out * 2 * 4) * 2  # row and column (idx, weight) tables
    bytes_moved = x.numel() * 4 + taps_bytes + n * out * out * 4
    # vertical taps once per (row, source column, class), horizontal per pixel
    flops = 3 * n * c * (out * w + out * out)
    bound_ms, bound_by = _bound(bytes_moved, flops)
    return {
        "name": "upsample_argmax", "route": "cuda",
        "source": "multiagentperception_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "multiagentperception_tpu/ops/pallas/upsample_argmax.py:56",
        **checked,
        "ms": _time_ms(lambda: k1.upsample_argmax(x, out, out)),
        "plain_ms": _time_ms(lambda: k1.upsample_argmax_plain(x, out, out)),
        "library_ms": _time_ms(library),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": f"({n}, {c}, {h}, {w}) f32 -> ({n}, {out}, {out}) int32",
    }


def check_comm_fusion(gen) -> dict:
    b, n, d, c, h, w = 2, 6, 1024, 512, 16, 16  # flagship value maps, NCHW per agent
    q = torch.randn(b, n, d, generator=gen).to("cuda")
    # logits with a spread of about 2, so `activated` keeps off-diagonal links
    k = (torch.randn(b, n, d, generator=gen) * 2 / d ** 0.5).to("cuda")
    v = torch.randn(b, n, c, h, w, generator=gen).to("cuda")
    max_err = max(checks.check_comm_fusion(q, k, v, mode, DIAG_BIAS, THRES)
                  for mode in ("softmax", "activated", "argmax"))

    flat = v.reshape(b, n, -1)
    bias = DIAG_BIAS * torch.eye(n, device="cuda")

    def library():
        soft = torch.softmax(torch.bmm(k, q.transpose(1, 2)), dim=1) + bias
        coef = torch.where(soft > THRES, soft, torch.zeros_like(soft))
        return torch.bmm(coef.transpose(1, 2), flat)

    m = c * h * w
    bytes_moved = (q.numel() + k.numel() + 2 * v.numel() + 2 * b * n * n) * 4
    flops = 2 * b * n * n * d + 2 * b * n * n * m
    bound_ms, bound_by = _bound(bytes_moved, flops)
    run = lambda: k2.comm_fusion(q, k, v, mode="activated", diag_bias=DIAG_BIAS)  # noqa: E731
    plain = lambda: k2.comm_fusion_plain(q, k, v, mode="activated", diag_bias=DIAG_BIAS)  # noqa: E731
    return {
        "name": "comm_fusion", "route": "cuda",
        "source": "multiagentperception_tpu_torch/csrc/comm_fusion.cu",
        "replaces": "multiagentperception_tpu/ops/pallas/comm_fusion.py:73",
        "max_abs_err": max_err,
        "ms": _time_ms(run), "plain_ms": _time_ms(plain),
        "library_ms": _time_ms(library),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": f"q', k ({b}, {n}, {d}); V ({b}, {n}, {c}, {h}, {w}) f32, activated",
    }


# ------------------------------------------------------------------ phase 2

def seeded_batches(count, b, n, size, seed):
    """(images, labels, commun_label) as the AirSim loader yields them:
    normalized float32 (B, N, H, W, 3), int32 (B, N, H, W) labels with some
    ignore-index pixels, and mimo labels (B, 2, N)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        raw = rng.integers(0, 256, (b, n, size, size, 3), dtype=np.uint8)
        images = normalize_images(torch.from_numpy(raw)).numpy()
        labels = rng.integers(0, 11, (b, n, size, size)).astype(np.int32)
        labels[rng.random(labels.shape) < 0.01] = 250
        noise = rng.integers(0, 2, (b, n))
        link = rng.integers(0, n, (b, n))
        out.append((images, labels, np.stack([noise, link], axis=1).astype(np.int64)))
    return out


def run_slice(kernels) -> dict:
    cfg = load_config(str(FLAGSHIP))
    b, n, size = cfg["training"]["batch_size"], cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    model = init_weights(get_model(cfg, N_CLASSES), SEED)
    WORK.mkdir(parents=True, exist_ok=True)
    pkl = WORK / "mrms_when2com_seed0.pkl"
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0}, pkl)
    del model

    ev = Evaluator(cfg)  # the card: the default device
    ev.load_weight(str(pkl))
    batches = seeded_batches(EVAL_BATCHES + 2, b, n, size, SEED)
    ev.evaluate(batches[:2])  # warm-up

    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score, class_iou = ev.evaluate(batches[2:])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {kern.__name__: kern.launches for kern in kernels}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the eval path never launched: {launches}")

    metrics = ev.last_eval_metrics
    labels = np.stack([bt[1] for bt in batches[2:]])
    valid = int(((labels >= 0) & (labels < N_CLASSES)).sum())
    if int(metrics.confusion_matrix.sum()) != valid:
        raise AssertionError("confusion matrix does not count every labelled pixel")
    bandwidth = metrics.get_avg_bandW()
    if not 0.0 <= bandwidth <= n - 1:
        raise AssertionError(f"bandwidth {bandwidth} outside [0, {n - 1}]")
    if not all(np.isfinite(float(x)) for x in list(score.values()) + list(class_iou.values())):
        raise AssertionError("non-finite eval scores")

    frames = EVAL_BATCHES * b * n
    result = {"config": FLAGSHIP.relative_to(ROOT).as_posix(), "inference": "activated",
              "batch": b, "agents": n, "size": size, "batches": EVAL_BATCHES,
              "eval_frames_per_s": frames / seconds,
              "batch_ms": seconds / EVAL_BATCHES * 1e3, "bandwidth": bandwidth,
              "when2com_acc": metrics.get_selection_accuracy()[0],
              "who2com_acc": metrics.get_selection_accuracy()[1],
              "launches": launches}
    result.update(profile_window(ev, batches[2:], seconds, kernels))
    return result


def profile_window(ev, batches, wall_s: float, kernels) -> dict:
    """Trace the timed window's batches again. The device is busy for the
    traced device time (one stream: kernels and copies do not overlap) over
    ``wall_s``, the untraced window's wall time; the tracer's own cost shows
    in the traced wall time. Each kernel's traced device time per launch
    on the path (``<wrapper>_kernel`` in csrc) is free of host gaps, unlike
    an event-timed launch. The full table goes to PROFILE_OUT."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.evaluate(batches)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    PROFILE_OUT.write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    per_batch = len(batches)
    path_ms = {}
    for kern in kernels:
        hits = [e for e in events if f"{kern.__name__}_kernel" in e.key]
        calls = sum(e.count for e in hits)
        if not calls:
            raise AssertionError(f"the trace holds no launch of {kern.__name__}")
        path_ms[kern.__name__] = sum(e.self_device_time_total for e in hits) / calls / 1e3
    return {"device_ms_per_batch": device_ms / per_batch,
            "path_kernel_device_ms": path_ms,
            "device_busy_share": device_ms / (wall_s * 1e3),
            "traced_batch_wall_ms": traced_s * 1e3 / per_batch,
            "tracer_wall_inflation": traced_s / wall_s,
            "top_device_kernels_ms_per_batch": {
                e.key[:60]: e.self_device_time_total / 1e3 / per_batch for e in top}}


# ------------------------------------------------------------------ phase 3

def card_vs_cpu() -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(str(FLAGSHIP))
    cfg["data"]["img_rows"] = cfg["data"]["img_cols"] = 256
    b, n = cfg["training"]["batch_size"], cfg["model"]["agent_num"]
    state = init_weights(get_model(cfg, N_CLASSES), SEED + 1).state_dict()
    images = seeded_batches(1, b, n, 256, SEED + 1)[0][0]
    out = {}
    for dev in ("cuda", "cpu"):
        ev = Evaluator(cfg, device=dev)
        ev.model.load_state_dict(state, strict=True)
        out[dev] = [t.cpu() for t in ev.predict(images)]
    (g_cls, g_act, g_nc), (c_cls, c_act, c_nc) = out["cuda"], out["cpu"]
    agree = (g_cls == c_cls).float().mean().item()
    if not torch.equal(g_act, c_act) or float(g_nc) != float(c_nc):
        raise AssertionError(f"card and CPU choose other links: {g_act.tolist()} "
                             f"vs {c_act.tolist()}, {float(g_nc)} vs {float(c_nc)}")
    if agree < 0.999:
        raise AssertionError(f"card and CPU class maps agree on only {agree:.6f}")
    return {"size": 256, "pixel_agreement": agree, "num_connect": float(g_nc),
            "tf32": False}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    kernels = (k1.upsample_argmax, k2.comm_fusion)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", file=sys.stderr)

    gen = torch.Generator().manual_seed(SEED)
    records = [check_upsample_argmax(gen), check_comm_fusion(gen)]
    print("kernel checks passed")

    slice_result = run_slice(kernels)
    print("slice " + json.dumps(slice_result))
    for rec, kern in zip(records, kernels):
        rec["launches"] = slice_result["launches"][kern.__name__]
        rec["path_device_ms"] = slice_result["path_kernel_device_ms"][kern.__name__]
        rec["kernel_ms"] = rec["ms"]

    print("card_vs_cpu " + json.dumps(card_vs_cpu()))

    print(_card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
