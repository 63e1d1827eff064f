"""Serving CLI of the port (counterpart of the repo's serve.py): run an
exported artifact over a dataset split.

    python -m multiagentperception_tpu_torch.serve --config <yml> \\
        --artifact model.pt2 [--split test] [--out preds/] [--colorize] \\
        [--limit N] [--device cpu]

The artifact (``python -m multiagentperception_tpu_torch.export_serving``)
is loaded without the model code: this CLI needs the data pipeline, the
kernels' ops and ``torch.export`` only. It writes per-frame class maps
(``<frame>_cam<k>.png``, ids; ``.npy`` where cv2 is missing; ``--colorize``
adds an RGB panel) and prints the comm graph's bandwidth. The artifact is
self-describing: its batch size and input shape and dtype come from the
program (``export.ServingArtifact``); the last partial batch is padded by
repetition, trimmed after, and left out of the per-frame bandwidth. Runs on
the card unless ``--device cpu`` is passed (the program is moved there);
without a card and without it, it stops with an error.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import deque

import numpy as np

PIPELINE_DEPTH = 2  # batches dispatched ahead of the oldest one's readback


def main(argv=None) -> dict:
    """Serve the split; returns ``serve_dataset``'s statistics."""
    p = argparse.ArgumentParser(description="serve an exported artifact")
    p.add_argument("--config", required=True)
    p.add_argument("--artifact", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--out", default="preds")
    p.add_argument("--colorize", action="store_true", help="also write RGB-colorized panels")
    p.add_argument("--limit", type=int, default=None, help="serve at most N frames")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from multiagentperception_tpu_torch.config import load_config
    from multiagentperception_tpu_torch.data import get_loader
    from multiagentperception_tpu_torch.device import resolve_device
    from multiagentperception_tpu_torch.export import load_serving

    device = resolve_device(args.device)  # raises first if no card
    cfg = load_config(args.config)
    data_cfg = cfg["data"]
    with open(args.artifact, "rb") as f:
        served = load_serving(f.read(), device=device)
    ds = get_loader(data_cfg["dataset"])(
        root=data_cfg["path"],
        split=args.split,
        img_size=(data_cfg["img_rows"], data_cfg["img_cols"]),
        commun_label="None",
        target_view=data_cfg["target_view"],
    )
    stats = serve_dataset(served, ds, args.out, limit=args.limit, colorize=args.colorize,
                          device=device, split=args.split)
    print(f"wrote {stats['maps']} prediction maps ({stats['frames']} frames x "
          f"{stats['maps'] // stats['frames']} cams) to {args.out}/ — "
          f"{stats['frames_per_s']:.1f} frames/sec, {stats['maps_per_s']:.1f} maps/sec "
          f"wall incl. decode+encode; avg bandwidth {stats['bandwidth']:.2f} links/agent")
    return stats


def serve_dataset(served, ds, out_dir: str, limit: int | None = None, colorize: bool = False,
                  device=None, split: str = "test") -> dict:
    """Run ``served`` (a ``ServingArtifact``) over ``ds`` (anything with
    ``__len__`` and ``__getitem__`` whose item's first entry is one frame's
    (N, H, W, 3) images), ``PIPELINE_DEPTH`` batches in flight, and write
    each camera's class map under ``out_dir``. Returns the frame and map
    counts, the wall time, the rates, the mean per-frame bandwidth over the
    real frames and the written paths. Raises ``SystemExit`` when the
    dataset's frames are not the artifact's."""
    import torch

    device = torch.device("cpu" if device is None else device)
    os.makedirs(out_dir, exist_ok=True)
    n_frames = len(ds) if limit is None else min(len(ds), limit)
    if n_frames == 0:
        raise SystemExit(f"split '{split}' has no frames")
    batch = served.batch
    sample_shape = np.asarray(ds[0][0]).shape
    if served.input_shape[1:] != sample_shape:
        raise SystemExit(
            f"artifact expects input {served.input_shape} ({served.input_dtype}), but this "
            f"dataset/config yields per-frame shape {sample_shape} — config mismatch")
    print(f"artifact batch={batch} input={served.input_shape} {served.input_dtype}, "
          f"serving {n_frames} frames from split '{split}'")
    np_dtype = torch.empty((), dtype=served.input_dtype).numpy().dtype

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if device.type == "cuda":  # from pinned memory, without blocking the host
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def dispatch(i: int):
        idxs = list(range(i, min(i + batch, n_frames)))
        ims = [np.asarray(ds[j][0], np_dtype) for j in idxs]
        while len(ims) < batch:  # pad the tail by repetition
            ims.append(ims[-1])
        cls_map, _prob, num_connect = served(put(np.stack(ims)))
        return idxs, cls_map, num_connect

    written: list[str] = []
    bw_sum = 0.0

    def drain(idxs, cls_map, num_connect) -> None:
        nonlocal bw_sum
        cls_map = cls_map.cpu().numpy()  # waits for the batch
        nc = num_connect.float().cpu().numpy().reshape(-1)
        bw_sum += float(nc[: len(idxs)].sum())  # padded frames left out
        # multiple outputs are batch-major (b*N + cam); one output is (B, H, W)
        n_cams = cls_map.shape[0] // batch if cls_map.shape[0] != batch else 1
        for bi, j in enumerate(idxs):
            for cam in range(n_cams):
                written.extend(_write_pred(out_dir, j, cam, cls_map[bi * n_cams + cam], ds,
                                           colorize))

    t0 = time.perf_counter()
    pending: deque = deque()
    for i in range(0, n_frames, batch):
        pending.append(dispatch(i))
        if len(pending) > PIPELINE_DEPTH:
            drain(*pending.popleft())
    while pending:
        drain(*pending.popleft())
    seconds = time.perf_counter() - t0
    maps = sum(1 for p in written if not p.endswith("_rgb.png"))
    return {"frames": n_frames, "maps": maps, "seconds": seconds,
            "frames_per_s": n_frames / seconds, "maps_per_s": maps / seconds,
            "bandwidth": bw_sum / n_frames, "paths": written}


def _write_pred(out_dir: str, frame_idx: int, cam: int, cls_map: np.ndarray, ds,
                colorize: bool) -> list[str]:
    """One camera's class map as ``<frame>_cam<k>.png`` (ids), and its
    ``_rgb.png`` with ``colorize``; ``.npy`` ids where cv2 is missing."""
    try:
        import cv2
    except ImportError:
        cv2 = None

    base = os.path.join(out_dir, f"frame{frame_idx:05d}_cam{cam}")
    ids = cls_map.astype(np.uint8)
    if cv2 is None:
        np.save(base + ".npy", ids)
        return [base + ".npy"]
    cv2.imwrite(base + ".png", ids)
    if not colorize:
        return [base + ".png"]
    rgb = ds.decode_segmap(ids)  # (H, W, 3) float 0..1
    cv2.imwrite(base + "_rgb.png", (rgb[..., ::-1] * 255).astype(np.uint8))
    return [base + ".png", base + "_rgb.png"]


if __name__ == "__main__":
    main()
