"""Dataset validation tool: audit an AirSim-MAP root before training (the
port's copy of the repo's scripts/validate_dataset.py; keep the two in step:
same output, same exit codes).

    python -m multiagentperception_tpu_torch.validate_dataset --path <root>
        [--target_view 6agent] [--commun_label mimo|when2com]

The loader's existence-intersection indexing (data/airsim.py, reference
airsim_loader.py:233-256) silently DROPS any frame missing from even one
camera or modality — a half-synced dataset trains without error on a
fraction of the data. This tool makes the drops visible: per-split frame
counts, per-camera/modality missing-file tallies, comm-label coverage, and
a non-zero exit code if anything is incomplete (1: incomplete frames or
labels, 2: the root's layout or a label file is missing).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="validate an AirSim-MAP root")
    p.add_argument("--path", required=True)
    p.add_argument("--target_view", default="target")
    p.add_argument("--commun_label", default="None",
                   help="when2com|mimo to also check gt label coverage")
    args = p.parse_args(argv)

    from multiagentperception_tpu_torch.data.airsim import (
        IMAGE_MODES,
        SPLITS,
        WEATHER,
        generate_split_subdirs,
        get_cam_pos,
        read_selection_label,
    )

    # normpath: a trailing slash would break the path_dir extraction below
    # (root + "/scene/" must prefix-match the globbed paths exactly)
    root = os.path.normpath(args.path)
    cam_pos = get_cam_pos(args.target_view)
    split_subdirs = generate_split_subdirs()

    # fail the root-level layout FIRST with the exact expected paths —
    # "0 frames usable" alone doesn't tell a new user what to fix
    if not os.path.isdir(root):
        print(f"FAIL: dataset root '{root}' does not exist")
        sys.exit(2)
    for modal in IMAGE_MODES:
        expect = os.path.join(root, modal, WEATHER)
        if not os.path.isdir(expect):
            print(f"FAIL: missing modality directory '{expect}'")
            print(f"      expected layout: <root>/{modal}/{WEATHER}/"
                  f"<trajectory>/<camera>/<frame>.png with modalities "
                  f"{list(IMAGE_MODES)} and cameras {cam_pos}")
            sys.exit(2)

    comm_label = None
    if args.commun_label != "None":
        try:
            comm_label = read_selection_label(root, args.commun_label)
        except FileNotFoundError as e:
            print(f"FAIL: comm-label file missing: {e}")
            sys.exit(2)

    problems = 0
    print(f"root: {root}  cameras: {len(cam_pos)} ({args.target_view})  "
          f"weather: {WEATHER}")
    for s in SPLITS:
        kept = dropped = 0
        missing: dict[str, int] = {}
        example_missing: str | None = None
        unlabeled = 0
        for subdir in split_subdirs[s]:
            # subdirs are glob patterns (trajectory-name prefixes ending in
            # '*'); the REAL directory name comes from the matched path,
            # exactly like the loader's indexing (data/airsim.py)
            pattern = os.path.join(root, "scene", WEATHER, subdir,
                                   cam_pos[0], "*.png")
            for file_path in sorted(glob.glob(pattern)):
                file_name = os.path.basename(file_path)
                path_dir = file_path.replace(
                    root + "/scene/", "").split("/")[1]
                holes = [
                    f"{modal}/{cam}"
                    for modal in IMAGE_MODES
                    for cam in cam_pos
                    if not os.path.exists(os.path.join(
                        root, modal, WEATHER, path_dir, cam, file_name))
                ]
                if holes:
                    dropped += 1
                    if example_missing is None:
                        modal, cam = holes[0].split("/")
                        example_missing = os.path.join(
                            root, modal, WEATHER, path_dir, cam, file_name)
                    for h in holes:
                        missing[h] = missing.get(h, 0) + 1
                    continue
                if comm_label is not None and \
                        (path_dir + "/" + file_name) not in comm_label:
                    unlabeled += 1
                    continue
                kept += 1
        line = f"split {s:5s}: {kept:6d} frames usable"
        if dropped:
            worst = sorted(missing.items(), key=lambda kv: -kv[1])[:3]
            line += (f", {dropped} DROPPED (incomplete); worst holes: "
                     + ", ".join(f"{k} x{v}" for k, v in worst)
                     + f"; e.g. missing '{example_missing}'")
            problems += dropped
        if unlabeled:
            line += (f", {unlabeled} frames lack a {args.commun_label} label "
                     f"entry (keys are '<trajectory>/<frame>.png' in "
                     f"gt_{'mimo' if args.commun_label == 'mimo' else 'when_to'}"
                     f"_communicate.txt)")
            problems += unlabeled
        if kept == 0:
            probe = os.path.join(root, "scene", WEATHER,
                                 next(iter(split_subdirs[s]), "<traj>*"),
                                 cam_pos[0], "*.png")
            line += (f"  <-- EMPTY: training on this split will fail "
                     f"(no frames matched e.g. '{probe}')")
            problems += 1
        print(line)

    if problems:
        print(f"FAIL: {problems} problems — the loader would silently train "
              f"on the reduced set")
        sys.exit(1)
    print("OK: every discovered frame is complete across all cameras and "
          "modalities")


if __name__ == "__main__":
    main()
