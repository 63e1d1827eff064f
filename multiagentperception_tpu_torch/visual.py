"""Visualization tools: segmentation panels, communication-graph rendering,
box drawing (port of multiagentperception_tpu/visual.py).

The port's own copy of the JAX package's host-side numpy functions (keep
the two in step): a vectorized class-map colorizer (replacing the
per-class Python loop of the reference's airsim_loader.py:542-555), input
de-normalization (inverting airsim_loader.py:515-540), side-by-side
prediction panels, an N x N communication-graph heatmap and
``draw_bounding``, which the reference's test.py:14 imports but never
ships. ``save_eval_gallery`` runs the port's ``Evaluator``: the class map
comes from K1 ``upsample_argmax`` (``class_map``), as in its evaluation.

Everything but ``save_eval_gallery``'s forward is numpy on arrays already
on the host; PNGs are written with cv2.
"""

from __future__ import annotations

import os

import numpy as np

from multiagentperception_tpu_torch.data.airsim import (
    ID2NAME,
    IGNORE_INDEX,
    MEAN_RGB,
    NAME2COLOR,
)


def class_palette(n_classes: int = 11) -> np.ndarray:
    """(max(n_classes, 256), 3) uint8 RGB palette from the AirSim-MAP class
    tables (airsim_loader.py:48-73); class 0 (unlabeled) is black."""
    pal = np.zeros((max(n_classes, 256), 3), np.uint8)
    for i, name in ID2NAME.items():
        if i < len(pal):
            pal[i] = np.asarray(NAME2COLOR[name][0], np.uint8)
    return pal


def colorize_segmap(labels: np.ndarray, n_classes: int = 11) -> np.ndarray:
    """Class-id map (H, W) int -> (H, W, 3) uint8 RGB: one table lookup;
    ignore pixels render black."""
    labels = np.asarray(labels)
    pal = class_palette(n_classes)
    safe = np.where(labels == IGNORE_INDEX, 0, labels)
    return pal[np.clip(safe, 0, len(pal) - 1)]


def denormalize_image(img: np.ndarray, img_norm: bool = True) -> np.ndarray:
    """Invert the loader transform (airsim_loader.py:515-540): the model
    input is BGR, mean-subtracted, optionally /255; back to uint8 RGB."""
    img = np.asarray(img, np.float64)
    if img_norm:
        img = img * 255.0
    img = img + MEAN_RGB
    return np.clip(np.rint(img[:, :, ::-1]), 0, 255).astype(np.uint8)  # BGR -> RGB


def draw_bounding(img: np.ndarray, boxes, color=(255, 0, 0),
                  thickness: int = 2) -> np.ndarray:
    """Draw (x1, y1, x2, y2) boxes on an (H, W, 3) uint8 image (the API the
    reference's test.py:14 imports but never ships)."""
    out = np.array(img, copy=True)
    h, w = out.shape[:2]
    col = np.asarray(color, out.dtype)
    for box in np.atleast_2d(np.asarray(boxes, np.int64)):
        x1, y1, x2, y2 = box
        x1, x2 = sorted((int(np.clip(x1, 0, w - 1)), int(np.clip(x2, 0, w - 1))))
        y1, y2 = sorted((int(np.clip(y1, 0, h - 1)), int(np.clip(y2, 0, h - 1))))
        t = max(1, int(thickness))
        out[y1:y1 + t, x1:x2 + 1] = col
        out[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = col
        out[y1:y2 + 1, x1:x1 + t] = col
        out[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = col
    return out


def prediction_panel(image: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                     n_classes: int = 11, pad: int = 4) -> np.ndarray:
    """[input | ground truth | prediction] strip, uint8 RGB. ``image`` is a
    model-input view (H, W, 3, normalized) or uint8 RGB; ``gt``/``pred``
    are class-id maps."""
    image = np.asarray(image)
    rgb = (image.astype(np.uint8) if image.dtype == np.uint8
           else denormalize_image(image))
    tiles = [rgb, colorize_segmap(gt, n_classes), colorize_segmap(pred, n_classes)]
    h = max(t.shape[0] for t in tiles)
    spacer = np.full((h, pad, 3), 255, np.uint8)
    padded = []
    for t in tiles:
        if t.shape[0] < h:
            t = np.pad(t, ((0, h - t.shape[0]), (0, 0), (0, 0)))
        padded.extend((t, spacer))
    return np.concatenate(padded[:-1], axis=1)


def comm_graph_image(prob: np.ndarray, action: np.ndarray | None = None,
                     cell: int = 48) -> np.ndarray:
    """An (N_keys, N_queries) communication graph as a heatmap. Each column
    is one requesting agent's distribution over supporters; intensity maps
    black -> blue -> yellow -> white, and the selected link per query
    (``action`` one-hot/index matrix, or the column argmax) gets a red
    cell border."""
    prob = np.asarray(prob, np.float64)
    if prob.ndim != 2:
        raise ValueError(f"expected (N_keys, N_queries), got {prob.shape}")
    n_k, n_q = prob.shape
    p = prob / max(prob.max(), 1e-12)
    anchors = np.array([[0, 0, 0], [40, 70, 200], [250, 220, 60],
                        [255, 255, 255]], np.float64)
    t = np.clip(p, 0, 1) * (len(anchors) - 1)
    lo = np.floor(t).astype(int)
    hi = np.clip(lo + 1, 0, len(anchors) - 1)
    frac = (t - lo)[..., None]
    img = (anchors[lo] * (1 - frac) + anchors[hi] * frac)  # (N_k, N_q, 3)
    img = np.kron(img, np.ones((cell, cell, 1))).astype(np.uint8)
    picks = (np.argmax(np.asarray(action), axis=0) if action is not None
             and np.asarray(action).ndim == 2 else np.argmax(prob, axis=0))
    for q in range(n_q):
        k = int(picks[q])
        y, x = k * cell, q * cell
        img[y:y + cell, x:x + 3] = (220, 30, 30)
        img[y:y + cell, x + cell - 3:x + cell] = (220, 30, 30)
        img[y:y + 3, x:x + cell] = (220, 30, 30)
        img[y + cell - 3:y + cell, x:x + cell] = (220, 30, 30)
    return img


def save_eval_gallery(evaluator, loader, out_dir: str, max_batches: int = 1,
                      inference_mode: str | None = None) -> list[str]:
    """Run eval forwards of ``evaluator`` (``evaluate.Evaluator``, weights
    loaded) and write prediction panels and comm graphs as PNGs: panels per
    requesting view (at most 8 a batch), plus batch element 0's (N, N)
    graph for the comm models. Returns the written paths."""
    import cv2
    import torch

    from multiagentperception_tpu_torch.ops.kernels.upsample_argmax import class_map

    os.makedirs(out_dir, exist_ok=True)
    inference = inference_mode or evaluator.eval_default
    mo = evaluator.mo_flag and evaluator.arch != "All_agents"
    evaluator.model.eval()
    written: list[str] = []
    for bi, data in enumerate(loader):
        if bi >= max_batches:
            break
        images = np.asarray(data[0])
        x = evaluator._images(images)
        with torch.inference_mode():
            out = evaluator.model(x, full_res=False,
                                  **evaluator._forward_kwargs(inference, "eval"))
            pre = out[0] if isinstance(out, tuple) else out
            pred = class_map(pre, x.shape[-3], x.shape[-2]).cpu().numpy()
        gt = evaluator._labels(data[1]).astype(np.int32)

        b, n = images.shape[:2]
        views = images.reshape((b * n,) + images.shape[2:]) if mo else images[:, 0]
        for i in range(min(len(pred), len(views), 8)):
            panel = prediction_panel(views[i], gt[i], pred[i], evaluator.n_classes)
            path = os.path.join(out_dir, f"panel_b{bi}_s{i}.png")
            cv2.imwrite(path, panel[:, :, ::-1])  # RGB -> BGR for cv2
            written.append(path)

        if isinstance(out, tuple) and len(out) >= 3 and out[1] is not None:
            prob = out[1].float().cpu().numpy()
            act = out[2].cpu().numpy() if out[2] is not None else None
            if prob.ndim == 3:  # (B, N_keys, N_queries)
                g = comm_graph_image(
                    prob[0], act[0] if act is not None and act.ndim == 3 else None)
                path = os.path.join(out_dir, f"comm_graph_b{bi}.png")
                cv2.imwrite(path, g[:, :, ::-1])
                written.append(path)
    return written
