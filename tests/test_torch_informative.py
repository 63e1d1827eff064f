"""The port's copy of the learning-proof fixture
(``data/synthetic.py``) against the JAX package's
``generate_informative_fixture``: the same files, byte for byte, and the
in-memory frames equal to what the port's loader reads back from them."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from multiagentperception_tpu.data.synthetic import (
    generate_informative_fixture as jax_generate_informative_fixture,
)
from multiagentperception_tpu_torch.data import AirsimDataset
from multiagentperception_tpu_torch.data.synthetic import (
    generate_informative_fixture,
    informative_frames,
)

ARGS = dict(target_view="6agent", img_size=64, frames_per_traj=2, n_noisy=2, seed=3)


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_the_copy_writes_the_jax_fixture(tmp_path):
    jax_generate_informative_fixture(str(tmp_path / "jax"), **ARGS)
    manifest = generate_informative_fixture(str(tmp_path / "port"), **ARGS)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(got) == 4 * 2 * 6 * 2 + 2  # trajs x frames x cams x modalities + labels
    assert got == want
    assert manifest["informative"] and len(manifest["trajs"]) == 4


def test_frames_in_memory_are_what_the_loader_reads(tmp_path):
    generate_informative_fixture(str(tmp_path), **ARGS)
    frames = informative_frames(**{k: v for k, v in ARGS.items()})["train"]
    ds = AirsimDataset(str(tmp_path), split="train", img_size=(64, 64), target_view="6agent",
                       commun_label="mimo", raw_images=True)
    assert len(ds) == len(frames)
    by_key = {(traj, idx): f for traj, idx, *f in frames}
    for i in range(len(ds)):
        images, labels, commun = ds[i][:3]
        scene, lbl, noise, link = next(v for v in by_key.values()
                                       if np.array_equal(v[1], np.asarray(labels)))
        np.testing.assert_array_equal(np.asarray(images), scene)
        np.testing.assert_array_equal(np.asarray(commun), np.stack([noise, link]))
