"""Synthetic AirSim-MAP-shaped fixtures: the port's own copy of
``multiagentperception_tpu/data/synthetic.py`` (``generate_fixture`` :27-88,
``generate_informative_fixture`` :89-200); keep the two in step.

``generate_fixture`` writes random scenes and labels in the exact directory
layout the loader indexes (root/<modality>/<weather>/<traj>/<cam>/<frame>.png)
with the communication label files; ``informative_frames`` builds the
learning-proof frames in memory (numpy only), and
``generate_informative_fixture`` writes them. Both writers use cv2, as the
JAX package's do, and write byte for byte what its functions write for the
same arguments.
"""

from __future__ import annotations

import os
import random

import numpy as np

from multiagentperception_tpu_torch.data.airsim import (
    IMAGE_MODES,
    WEATHER,
    generate_split_subdirs,
    get_cam_pos,
)
from multiagentperception_tpu_torch.data.noise import generate_noise


def generate_fixture(root: str, target_view: str = "6agent", img_size: int = 128,
                     frames_per_traj: int = 2, n_train: int = 2, n_val: int = 1,
                     n_test: int = 1, n_classes: int = 11, seed: int = 0) -> dict:
    """Create a small on-disk dataset of random frames; returns a manifest
    dict. The label files hold random communication labels in the formats
    ``read_selection_label`` parses (airsim_loader.py:412-438)."""
    import cv2

    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    cams = get_cam_pos(target_view)
    n_agents = len(cams)
    subdirs = generate_split_subdirs()
    chosen = subdirs["train"][:n_train] + subdirs["val"][:n_val] + subdirs["test"][:n_test]
    when_lines, mimo_lines = [], []
    manifest = {"root": root, "trajs": [], "cams": cams}
    for traj_glob in chosen:
        traj = traj_glob.rstrip("*")  # the on-disk directory is the glob's stem
        manifest["trajs"].append(traj)
        for frame_idx in range(frames_per_traj):
            frame = f"{frame_idx:06d}.png"
            for cam in cams:
                for modal in IMAGE_MODES:
                    d = os.path.join(root, modal, WEATHER, traj, cam)
                    os.makedirs(d, exist_ok=True)
                    if modal == "scene":
                        img = rng.integers(0, 256, (img_size, img_size, 3), np.uint8)
                    else:
                        lbl = rng.integers(0, n_classes, (img_size, img_size), np.uint8)
                        img = np.stack([lbl] * 3, axis=-1)
                    cv2.imwrite(os.path.join(d, frame), img)
            # the parser takes split('/')[-3] as the trajectory directory and
            # split('/')[-1] as the frame stem (airsim_loader.py:420-434)
            label_path = f"scene/{traj}/{cams[0]}/{frame[:-4]}"
            # when2com: -1 (normal) .. n_agents-2 (the supporter's index)
            when_lines.append(f"{frame_idx} {pyrng.randint(-1, n_agents - 2)} {label_path}")
            # mimo: per-agent noise flags, then link targets
            noise = tuple(pyrng.randint(0, 1) for _ in range(n_agents))
            link = tuple(pyrng.randrange(n_agents) for _ in range(n_agents))
            mimo_lines.append(f"{noise} {link} {label_path}")
    with open(os.path.join(root, "gt_when_to_communicate.txt"), "w") as f:
        f.write("\n".join(when_lines) + "\n")
    with open(os.path.join(root, "gt_mimo_communicate.txt"), "w") as f:
        f.write("\n".join(mimo_lines) + "\n")
    return manifest


def informative_frames(target_view: str = "6agent", img_size: int = 128,
                       frames_per_traj: int = 8, n_train: int = 2, n_val: int = 1,
                       n_test: int = 1, n_noisy: int = 2, n_classes: int = 11,
                       seed: int = 0) -> dict:
    """The fixture's frames by split: ``{split: [(traj, frame index, scene
    (N, H, W, 3) uint8 RGB, labels (N, H, W) uint8, noise flags (N,), links
    (N,))]}``.

    Each agent's content is a random class map on an ``img_size/32`` grid,
    rendered to 32-pixel blocks of a class's brightness; ``n_noisy`` agents
    see their content occluded (their label stays the full content), and
    each has a distinct normal partner who sees the same content cleanly:
    fusing the partner's map is the only way to segment the occluded
    region. The links point at the partners (self for normal agents), as
    the reference's ground-truth action (metrics.py:66)."""
    rng = np.random.default_rng(seed)
    cams = get_cam_pos(target_view)
    n_agents = len(cams)
    assert 0 < n_noisy <= n_agents // 2, "each noisy agent needs its own partner"
    subdirs = generate_split_subdirs()
    chosen = {"train": subdirs["train"][:n_train], "val": subdirs["val"][:n_val],
              "test": subdirs["test"][:n_test]}
    cell = 32  # one block per 1/32-res feature cell
    grid = img_size // cell
    palette = np.linspace(30, 250, n_classes).astype(np.uint8)
    out: dict[str, list] = {}
    for split, split_dirs in chosen.items():
        out[split] = []
        for traj_glob in split_dirs:
            traj = traj_glob.rstrip("*")
            for frame_idx in range(frames_per_traj):
                contents = [rng.integers(0, n_classes, (grid, grid)) for _ in range(n_agents)]
                order = rng.permutation(n_agents)
                noisy, partners = order[:n_noisy], order[n_noisy: 2 * n_noisy]
                link = list(range(n_agents))
                noise_flags = [0] * n_agents
                for i, j in zip(noisy, partners):
                    contents[j] = contents[i]  # the partner shares the view
                    link[i] = int(j)
                    noise_flags[i] = 1
                scenes, labels = [], []
                for a in range(n_agents):
                    lbl = np.repeat(np.repeat(contents[a], cell, 0), cell, 1).astype(np.uint8)
                    img = np.stack([palette[lbl]] * 3, axis=-1)
                    scenes.append(generate_noise(img, "occlusion") if noise_flags[a] else img)
                    labels.append(lbl)
                out[split].append((traj, frame_idx, np.stack(scenes), np.stack(labels),
                                   np.array(noise_flags), np.array(link)))
    return out


def generate_informative_fixture(root: str, target_view: str = "6agent", img_size: int = 128,
                                 frames_per_traj: int = 8, n_train: int = 2, n_val: int = 1,
                                 n_test: int = 1, n_noisy: int = 2, n_classes: int = 11,
                                 seed: int = 0) -> dict:
    """Write ``informative_frames`` under ``root`` with the communication
    label files (``gt_when_to_communicate.txt``, ``gt_mimo_communicate.txt``);
    returns a manifest dict."""
    import cv2

    cams = get_cam_pos(target_view)
    frames = informative_frames(target_view, img_size, frames_per_traj, n_train, n_val,
                                n_test, n_noisy, n_classes, seed)
    when_lines, mimo_lines = [], []
    manifest = {"root": root, "trajs": [], "cams": cams, "informative": True}
    for split_frames in frames.values():
        for traj, frame_idx, scenes, labels, noise_flags, link in split_frames:
            if traj not in manifest["trajs"]:
                manifest["trajs"].append(traj)
            frame = f"{frame_idx:06d}.png"
            for a, cam in enumerate(cams):
                for modal in IMAGE_MODES:
                    d = os.path.join(root, modal, WEATHER, traj, cam)
                    os.makedirs(d, exist_ok=True)
                    img = scenes[a] if modal == "scene" else np.stack([labels[a]] * 3, -1)
                    cv2.imwrite(os.path.join(d, frame), img)
            label_path = f"scene/{traj}/{cams[0]}/{frame[:-4]}"
            # when2com view (requester = agent 0): -1 when normal, else the
            # supporter's index among agents 1..N-1 (0-based)
            when_label = int(link[0]) - 1 if noise_flags[0] else -1
            when_lines.append(f"{frame_idx} {when_label} {label_path}")
            mimo_lines.append(f"{tuple(int(v) for v in noise_flags)} "
                              f"{tuple(int(v) for v in link)} {label_path}")
    with open(os.path.join(root, "gt_when_to_communicate.txt"), "w") as f:
        f.write("\n".join(when_lines) + "\n")
    with open(os.path.join(root, "gt_mimo_communicate.txt"), "w") as f:
        f.write("\n".join(mimo_lines) + "\n")
    return manifest
