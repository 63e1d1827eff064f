"""The multi-rank dry run (the port's counterpart of
``__graft_entry__.dryrun_multichip``).

    python -m multiagentperception_tpu_torch.dryrun_multichip [--ranks N] \\
        [--device cpu|cuda] [--img 128]

Starts N ranks (``parallel.spawn``; on the card they share it under gloo)
for each of the legs below, all legs at once, and holds them to one
process, as the JAX dry run holds its mesh to one device. The grid is
data x model, M = 2 on the model axis where N is even and >= 4 (JAX's
``n_model``):

1. the grid: MIMOcom (6 agents, query 8, key 128, at ``--img``) from
   ``models.init_weights``, a seeded batch of D rows, 3 train steps and one
   ``activated`` eval with the loss: losses within rtol 2e-4 / atol 1e-6,
   every parameter within rtol 5e-3 / atol 1e-4, the eval's confusion
   matrix moving less than 1e-3 of its pixels;
2. the agent ring: a ring of N ranks (N agents, 64x64, key 32) evaluates
   ``activated`` as the dense model does (predictions within 1e-4, graphs
   rtol 2e-4 / atol 1e-6, ``num_connect`` within 1e-6), and where N is
   even and >= 4 a 2 x N/2 grid of rings on a batch of 2;
3. ``training.steps_per_call``: the grid's 3 steps are one chunk (eager:
   its steps one after another), held to one process's steps as 1. holds
   them; on a shared card no CUDA graph holds a gloo collective, and the
   run also reports the trainer's refusal to capture it.

Every rank and the one process run in full float32 with deterministic
algorithms (``precise``): TF32 convolutions, the card's default, round
each product to ~1e-3, and the grid's shards (half the output channels)
take other cuDNN algorithms than one process's whole layers, so two TF32
runs part by far more than JAX's bounds, which are for reduction-order
noise (on an NVIDIA H100 80GB HBM3 at 700 W, TF32 on: the second step's
loss 7.2e-4 relative from one process's).

Prints one JSON line and exits non-zero on any failure (a rank that fails
fails the run).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_STEPS = 3
SEED = 0
RANK_TIMEOUT_S = 600.0
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-6
PARAM_RTOL, PARAM_ATOL = 5e-3, 1e-4
HIST_MOVED = 1e-3
RING_IMG = 64


def precise() -> None:
    """Full float32 products and deterministic algorithms, in this process."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)


def grid_shape(ranks: int) -> tuple[int, int]:
    """(D, M): M = 2 where the ranks are even and at least 4 (JAX :128)."""
    m = 2 if ranks % 2 == 0 and ranks >= 4 else 1
    return ranks // m, m


def _cfg(img: int, batch: int, **training) -> dict:
    from multiagentperception_tpu_torch.config import normalize_config

    return normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": 6, "query_size": 8, "key_size": 128,
                  "multiple_output": True},
        "data": {"img_rows": img, "img_cols": img, "target_view": "6agent",
                 "commun_label": "mimo"},
        "training": {"batch_size": batch, "watchdog_secs": 0, **training}})


def _batch(img: int, b: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    images = rng.normal(size=(b, 6, img, img, 3)).astype(np.float32)
    labels = rng.integers(0, 11, size=(b, 6, img, img)).astype(np.int32)
    return images, labels


def _trainer(layout, img: int, b: int, device: str, **training):
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import init_weights
    from multiagentperception_tpu_torch.trainer import Trainer

    cfg = _cfg(img, b, **training)
    tr = Trainer(cfg, logging.getLogger("dryrun"), get_loss_function(cfg), None, None,
                 device=device, layout=layout, logdir=tempfile.mkdtemp(prefix="dryrun_"))
    init_weights(tr.model, SEED)  # a shard draws the whole weight and keeps its part
    return tr


def _global(value: torch.Tensor, tr) -> torch.Tensor:
    """A rank's share of a batch sum -> the whole batch's (data group)."""
    from multiagentperception_tpu_torch.parallel.collectives import all_reduce_sum

    return value if tr.layout is None else all_reduce_sum(value, tr.layout.data_group)


def run_training(layout, img: int, b: int, device: str) -> dict:
    """N_STEPS train steps on the seeded batch as one ``steps_per_call``
    chunk, eager (its steps one after another: one process's steps), and
    one ``activated`` eval with the loss: losses, the gathered parameters,
    the confusion matrix; on ranks sharing a card, also the trainer's
    refusal to capture the chunk (no CUDA graph holds a gloo collective)."""
    from multiagentperception_tpu_torch.parallel import tensor

    tr = _trainer(layout, img, b, device, steps_per_call=N_STEPS, train_iters=N_STEPS)
    out = {}
    if layout is not None and layout.backend == "gloo" and tr.device.type == "cuda":
        try:
            tr.train()
        except RuntimeError as e:
            out["refused"] = str(e)
        else:
            raise AssertionError("steps_per_call > 1 under gloo on the card ran")
    images, labels = tr._train_rows(_batch(img, b))
    x, y = tr._batch(images, labels)
    xs, ys = x[None].expand(N_STEPS, *x.shape), y[None].expand(N_STEPS, *y.shape)
    out["losses"] = [float(_global(v, tr)) for v in tr._chunk(xs, ys, N_STEPS, graph=False)]
    tr.model.eval()
    res = tr.eval_step(images, labels, inference="activated", with_loss=True,
                       rows=layout is not None and layout.data > 1)
    out.update(params={k: v.cpu() for k, v in tensor.gather_state_dict(tr.model).items()},
               hist=res["hist"].cpu().numpy(), eval_loss=float(res["loss"]))
    shutil.rmtree(tr.logdir, ignore_errors=True)
    return out


def _ring_cfg(agents: int, ring: int) -> dict:
    from multiagentperception_tpu_torch.config import normalize_config

    return normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": agents, "query_size": 8, "key_size": 32,
                  "multiple_output": True, "agent_parallel": ring},
        "data": {"img_rows": RING_IMG, "img_cols": RING_IMG}})


def run_ring(layout, agents: int, rows: int, seed: int, device: str) -> dict:
    """The ``activated`` eval of a MIMOcom of ``agents`` agents on a seeded
    batch of ``rows``: on the ring (this rank's rows and agents) or dense."""
    from multiagentperception_tpu_torch.models import get_model, init_weights

    ring = 1 if layout is None else layout.agent
    dev = torch.device(device) if layout is None else layout.device
    model = init_weights(get_model(_ring_cfg(agents, ring), 11, layout), SEED).to(dev).eval()
    x = np.random.default_rng(seed).normal(size=(rows, agents, RING_IMG, RING_IMG, 3))
    x = torch.from_numpy(x.astype(np.float32))
    if layout is not None and layout.data > 1:
        x = x[layout.data_index * rows // layout.data:(layout.data_index + 1) * rows
              // layout.data]
    with torch.inference_mode():
        pred, prob, _, num_connect = model(x.to(dev), inference="activated")
    return {"pred": pred.cpu(), "prob": prob.cpu(), "num_connect": float(num_connect)}


def rank_main(layout, work: str, leg: str, img: int, b: int, device: str) -> None:
    """One rank of a leg; rank ``r`` saves its result to ``work/<leg>_<r>.pt``."""
    precise()
    if layout.device.type == "cpu":
        torch.set_num_threads(1)
    if leg == "grid":
        out = {"train": run_training(layout, img, b, device)}
    elif leg == "ring":
        out = run_ring(layout, layout.world, 1, 1, device)
    else:  # combined: D x A rings
        out = run_ring(layout, layout.agent, layout.data, 2, device)
    out["layout"] = {"data": layout.data, "model": layout.model, "agent": layout.agent,
                     "backend": layout.backend}
    torch.save(out, os.path.join(work, f"{leg}_{layout.rank}.pt"))


def _launch(work: str, leg: str, ranks: int, device: str, img: int, b: int,
            agent: int = 1, model: int = 1) -> list:
    from multiagentperception_tpu_torch.parallel import spawn

    spawn(rank_main, ranks, (work, leg, img, b, device), device=device, agent=agent,
          model=model, timeout_s=RANK_TIMEOUT_S, shared_card=True)
    return [torch.load(os.path.join(work, f"{leg}_{r}.pt"), weights_only=False)
            for r in range(ranks)]


def _assert_close(got, want, rtol: float, atol: float, what: str) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    return float(np.abs(got - want).max()) if got.size else 0.0


def check_grid(ranks: list, ref: dict) -> dict:
    out = {"layout": ranks[0]["layout"]}
    for r in ranks:
        got = r["train"]
        _assert_close(got["losses"], ref["losses"], LOSS_RTOL, LOSS_ATOL, "losses")
        gap = max(_assert_close(got["params"][k], v, PARAM_RTOL, PARAM_ATOL, k)
                  for k, v in ref["params"].items() if v.is_floating_point())
        moved = float(np.abs(got["hist"] - ref["hist"]).sum() / max(ref["hist"].sum(), 1))
        if moved >= HIST_MOVED:
            raise AssertionError(f"eval histogram diverged: {moved:.2e} of pixels moved")
    got = ranks[0]["train"]
    out.update(losses=got["losses"], losses_one_process=ref["losses"],
               dloss=max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])),
               params_max_abs=gap, hist_moved=moved, eval_loss=got["eval_loss"],
               eval_loss_one_process=ref["eval_loss"], steps_per_call={"steps": N_STEPS})
    if "refused" in got:
        out["steps_per_call"]["refused"] = got["refused"]
    return out


def check_ring(ranks: list, want: dict, agents: int, rows: int) -> dict:
    """Each rank's predictions (its rows, its agents) against the dense
    model's, its graph and ``num_connect`` against the whole batch's."""
    gap = 0.0
    ring = ranks[0]["layout"]["agent"]
    data = ranks[0]["layout"]["data"]
    pred = want["pred"].reshape((rows, agents) + tuple(want["pred"].shape[1:]))
    for r, got in enumerate(ranks):
        d, a = divmod(r, ring)
        block = pred[d * rows // data:(d + 1) * rows // data,
                     a * agents // ring:(a + 1) * agents // ring]
        gap = max(gap, _assert_close(got["pred"], block.reshape(got["pred"].shape), 1e-4,
                                     1e-4, "ring predictions"))
        prob = want["prob"][d * rows // data:(d + 1) * rows // data]
        _assert_close(got["prob"], prob, 2e-4, 1e-6, "ring graph")
        if data == 1:
            _assert_close(got["num_connect"], want["num_connect"], 0, 1e-6, "num_connect")
    return {"layout": ranks[0]["layout"], "max_dpred": gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--img", type=int, default=128)
    args = ap.parse_args(argv)
    n, device = args.ranks, args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    precise()
    d, m = grid_shape(n)
    legs = {"grid": {"model": m}, "ring": {"agent": n}}
    if n >= 4 and n % 2 == 0:
        legs["combined"] = {"agent": n // 2}
    work = tempfile.mkdtemp(prefix="dryrun_multichip_")
    result: dict = {"ok": False, "ranks": n, "device": device, "img": args.img}
    try:
        # the legs' ranks all at once (each leg its own rendezvous), one
        # process's references meanwhile
        with ThreadPoolExecutor(len(legs)) as pool:
            runs = {leg: pool.submit(_launch, work, leg, n, device, args.img, d, **kw)
                    for leg, kw in legs.items()}
            ref = run_training(None, args.img, d, device)
            dense = {"ring": run_ring(None, n, 1, 1, device)}
            if "combined" in legs:
                dense["combined"] = run_ring(None, n // 2, 2, 2, device)
            ranks = {leg: run.result() for leg, run in runs.items()}
        result["grid"] = check_grid(ranks["grid"], ref)
        result["ring"] = check_ring(ranks["ring"], dense["ring"], n, 1)
        if "combined" in legs:
            result["combined"] = check_ring(ranks["combined"], dense["combined"], n // 2, 2)
        result["ok"] = True
    except Exception as e:  # noqa: BLE001 (reported on the JSON line, exit 1)
        result["error"] = f"{type(e).__name__}: {e}"[-2000:]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
