"""Train the shipped flagship config at its real geometry through the train CLI.

    python -m multiagentperception_tpu_torch.run_flagship_512 [--iters 5000] [--img 512]
        [--val_interval 500] [--frames 16] [--root DIR] [--resume CKPT]
        [--workdir DIR] [--steps_per_call 10] [--rss_limit_gb 100] [--device cpu]

The counterpart of the repo's scripts/run_flagship_512.py: what a user runs
to see the product work, end to end.

1. If ``--root`` does not exist, write the informative fixture there
   (``data.synthetic.generate_informative_fixture``, 6 agents, 2 noisy,
   ``--frames`` frames a trajectory, ``--img`` pixels a side).
2. ``derive_config``: the stock ``mrms_when2com.yml`` verbatim but for the
   data path, the image size, the iteration budget, ``val_interval``,
   ``print_interval`` 50 and the documented extension keys:
   ``mixed_precision``, ``data_backend: grain``, ``save_interval`` (=
   ``val_interval``), ``nan_guard`` 5, ``steps_per_call`` (where above 1),
   ``rss_limit_gb`` (where set), ``on_device_normalize``, ``cache_decoded``
   (under ``--workdir``) and ``resume``; written to
   ``<workdir>/mrms_when2com_512_run.yml``.
3. ``python -m multiagentperception_tpu_torch.train --config <derived>`` as
   a subprocess in ``--workdir``, its output in ``<workdir>/train_cli.log``.
   Its run directory is ``runs/mrms_when2com_512_run/<timestamp>`` there,
   with the ``best_model`` and ``latest`` checkpoints.
4. ``report``: from the CLI's own lines, the sustained train rate (the
   median of the ``Time/Image`` readings after the first, as frames/s),
   the Overall mIoU trajectory and the selection accuracy trajectory, as
   the JAX script reads them. Like the JAX script's, those two lists hold
   one reading more than the validations: the post-train test eval prints
   its tables too. ``report`` also splits them at the test eval's
   ``Bandwidth:`` line into the validations' and the test's, and reads the
   memory line each validation prints.

``main`` prints the JAX script's lines and returns the CLI's exit code.
The CLI runs on the card unless ``--device cpu``; without a card
``main`` raises before it starts anything.
"""

from __future__ import annotations

import argparse
import copy
import os
import re
import subprocess
import sys
import tempfile
import time

import yaml

from multiagentperception_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STOCK = os.path.join(REPO, "configs", "multi-request-multi-support", "mrms_when2com.yml")
WORKDIR = os.path.join(tempfile.gettempdir(), "flagship512")  # /tmp/flagship512, as JAX's
CONFIG_NAME = "mrms_when2com_512_run.yml"
LOG_NAME = "train_cli.log"
FRAMES_PER_SET = 6  # a batch item of the flagship is a 6-camera frame set
TIME_RE = r"Time/Image: ([0-9.]+)"
MIOU_RE = r"Mean IoU : \t\s*\n([ 0-9.\-]+)"
WHEN_RE = r"when2com accuracy:([0-9.eE+-]+)"
ITER_RE = r"Iter \[(\d+)/\d+\]"
BANDWIDTH_RE = r"Bandwidth: ([0-9.eE+-]+|nan)"
MEMORY_RE = (r"Memory at iter (\d+): host RSS ([0-9.]+) GiB"
             r"(?:, device allocated ([0-9.]+) GiB, peak ([0-9.]+) GiB)?")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--val_interval", type=int, default=500)
    ap.add_argument("--frames", type=int, default=16,
                    help="frames per trajectory (train = 2 trajs)")
    ap.add_argument("--root", default=os.path.join(WORKDIR, "data"))
    ap.add_argument("--resume", default=None, help="checkpoint path to continue from")
    ap.add_argument("--workdir", default=WORKDIR)
    ap.add_argument("--steps_per_call", type=int, default=10,
                    help="K optimizer steps per CUDA graph chunk (0/1 = the eager step)")
    ap.add_argument("--rss_limit_gb", type=float, default=100.0,
                    help="self-healing restart threshold (0 disables)")
    ap.add_argument("--device", default=None, help="default: the card; cpu for the CPU")
    return ap.parse_args(argv)


def derive_config(args: argparse.Namespace) -> dict:
    """The stock flagship YAML with the run's keys (scripts/run_flagship_512.py:75-103)."""
    with open(STOCK) as fp:
        cfg = yaml.safe_load(fp)
    derived = copy.deepcopy(cfg)
    derived["data"]["path"] = args.root
    derived["data"]["img_rows"] = args.img
    derived["data"]["img_cols"] = args.img
    derived["training"]["train_iters"] = args.iters
    derived["training"]["val_interval"] = args.val_interval
    derived["training"]["print_interval"] = 50
    # documented extension keys
    derived["training"]["mixed_precision"] = True
    derived["training"]["data_backend"] = "grain"
    derived["training"]["save_interval"] = args.val_interval
    derived["training"]["nan_guard"] = 5
    if args.steps_per_call > 1:
        derived["training"]["steps_per_call"] = args.steps_per_call
    if args.rss_limit_gb:
        derived["training"]["rss_limit_gb"] = args.rss_limit_gb
    derived["data"]["on_device_normalize"] = True
    derived["data"]["cache_decoded"] = os.path.join(args.workdir, "cache")
    if args.resume:
        derived["training"]["resume"] = args.resume
    return derived


def _floats(pattern: str, text: str) -> list[float]:
    return [float(m) for m in re.findall(pattern, text)]


def _tables(text: str) -> list[float]:
    """Every table's mIoU (in percent) in order: each evaluation prints
    Normal, Noise and Overall."""
    rows = re.findall(MIOU_RE, text)
    return [float(row.split()[-1]) for row in rows if row.split()]


def _overall(text: str) -> list[float]:
    """The Overall tables' mIoU, each validation's and the test eval's."""
    mious = _tables(text)
    return mious[2::3] if len(mious) >= 3 else mious


def report(text: str) -> dict:
    """The figures of a train CLI log (scripts/run_flagship_512.py:117-141):
    ``sustained`` frames/s (None without a ``Time/Image`` reading), the
    ``overall`` mIoU and ``when2com`` trajectories as the JAX script reads
    them, and the same split at the test eval's ``Bandwidth:`` line into
    ``val_overall`` / ``val_normal`` / ``val_noise`` / ``val_when2com`` and
    ``test`` (Normal, Noise and Overall mIoU, selection accuracy and
    bandwidth, or None), the ``first_iter`` printed,
    and ``memory``: per validation ``(iter, host RSS GiB, device allocated
    GiB, device peak GiB)`` (the last two None on the CPU)."""
    times = _floats(TIME_RE, text)
    sustained = None
    if times:
        # Time/Image is seconds per batch item, a 6-camera frame set; the
        # first reading holds the start (kernel builds, the graph's capture)
        rates = [FRAMES_PER_SET / t for t in times]
        steady = rates[1:] or rates
        sustained = sorted(steady)[len(rates[1:]) // 2]
    bandwidths = list(re.finditer(BANDWIDTH_RE, text))
    val_text, test = text, None
    if bandwidths:
        cut = bandwidths[-1]
        # the test eval prints its selection lines just before its bandwidth
        start = text.rfind("Validation when2com accuracy:", 0, cut.start())
        start = cut.start() if start < 0 else start
        val_text, test_text = text[:start], text[start:]
        tables = _tables(test_text) + [None] * 3
        test = {"normal": tables[0], "noise": tables[1], "overall": tables[2],
                "when2com": (_floats(WHEN_RE, test_text) or [None])[0],
                "bandwidth": float(cut.group(1))}
    iters = [int(i) for i in re.findall(ITER_RE, text)]
    memory = [(int(i), float(rss), float(alloc) if alloc else None,
               float(peak) if peak else None)
              for i, rss, alloc, peak in re.findall(MEMORY_RE, text)]
    val_tables = _tables(val_text)
    return {"time_image": times, "sustained": sustained, "overall": _overall(text),
            "when2com": _floats(WHEN_RE, text), "val_overall": _overall(val_text),
            "val_normal": val_tables[0::3], "val_noise": val_tables[1::3],
            "val_when2com": _floats(WHEN_RE, val_text), "test": test,
            "first_iter": iters[0] if iters else None, "memory": memory}


def print_report(r: dict, log_path: str) -> None:
    """The JAX script's closing lines (scripts/run_flagship_512.py:121-140)."""
    if r["time_image"]:
        print(f"sustained end-to-end train throughput: {r['sustained']:.1f} frames/s "
              f"(median of {len(r['time_image'])} print-interval readings, incl. input "
              f"pipeline + transfers)")
    if r["overall"]:
        print(f"val Overall mIoU trajectory (every val_interval): {r['overall']}")
    if r["when2com"]:
        print(f"when2com selection accuracy trajectory: {r['when2com']}")
    print(f"full CLI log: {log_path}")


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    # the CLI runs in the workdir: every path it is handed is absolute
    # (JAX's script passes them as given, so a relative --workdir breaks it)
    args.root, args.workdir = os.path.abspath(args.root), os.path.abspath(args.workdir)
    if args.resume:
        args.resume = os.path.abspath(args.resume)
    os.makedirs(args.workdir, exist_ok=True)

    # ---- 1. fixture ----
    if not os.path.isdir(args.root):
        from multiagentperception_tpu_torch.data.synthetic import generate_informative_fixture

        print(f"generating informative {args.img}d fixture at {args.root} ...")
        t0 = time.time()
        generate_informative_fixture(args.root, target_view="6agent", img_size=args.img,
                                     frames_per_traj=args.frames, n_noisy=2)
        print(f"fixture done in {time.time() - t0:.0f}s")

    # ---- 2. derived config ----
    cfg_path = os.path.join(args.workdir, CONFIG_NAME)
    with open(cfg_path, "w") as fp:
        yaml.safe_dump(derive_config(args), fp, sort_keys=False)
    print(f"derived config: {cfg_path}")

    # ---- 3. the train CLI ----
    log_path = os.path.join(args.workdir, LOG_NAME)
    print(f"running the train CLI (log: {log_path}) ...")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    t0 = time.time()
    with open(log_path, "w") as log:
        rc = subprocess.call(
            [sys.executable, "-m", "multiagentperception_tpu_torch.train",
             "--config", cfg_path, "--device", device.type],
            stdout=log, stderr=subprocess.STDOUT, cwd=args.workdir, env=env)
    wall = time.time() - t0
    print(f"train CLI exited rc={rc} after {wall / 60:.1f} min")

    # ---- 4. sustained throughput and quality from the CLI log ----
    with open(log_path) as fp:
        r = report(fp.read())
    print_report(r, log_path)
    if r["memory"]:
        print(f"memory at each validation (iter, host RSS GiB, device allocated GiB, "
              f"device peak GiB): {r['memory']}")
    if r["test"] is not None:
        print(f"post-train test: Overall mIoU {r['test']['overall']}, "
              f"bandwidth {r['test']['bandwidth']}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
