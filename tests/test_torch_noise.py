"""The port's online noise (``data/noise.py``) against the JAX package's, and
the dataset's ``noisy_type`` against JAX's dataset:

- ``generate_noise`` per type, exact, on HWC uint8 and float images; the
  gaussian from one ``default_rng(seed)`` given to both;
- None / "None" copy; an unknown type raises; the port's gaussian without a
  generator raises (JAX's draws from an unseeded one);
- the dataset with each deterministic type (occlusion, grayscale, lowres),
  raw and normalized, equal to JAX's dataset: only the requester's view
  (agent 0) is degraded;
- gaussian through the dataset: a pure function of (seed, epoch, index).
"""

from __future__ import annotations

import numpy as np
import pytest

from multiagentperception_tpu.data import AirsimDataset as JaxDataset
from multiagentperception_tpu.data.noise import generate_noise as jax_noise
from multiagentperception_tpu.data.synthetic import generate_fixture
from multiagentperception_tpu_torch.data import AirsimDataset
from multiagentperception_tpu_torch.data.noise import NOISE_TYPES, generate_noise

IMG = 32


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_noise") / "data")
    generate_fixture(root, target_view="6agent", img_size=IMG, frames_per_traj=2)
    return root


def _image(seed: int, shape=(37, 29, 3), dtype=np.uint8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(dtype)
    return img


@pytest.mark.parametrize("noise_type", NOISE_TYPES + (None, "None"))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_generate_noise_matches_jax(noise_type, dtype):
    img = _image(3, dtype=dtype)
    got = generate_noise(img, noise_type, np.random.default_rng(11))
    want = jax_noise(img, noise_type, np.random.default_rng(11))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not np.shares_memory(got, img)


def test_occlusion_keeps_the_top_fifth():
    img = _image(4, (40, 8, 3))
    out = generate_noise(img, "occlusion")
    np.testing.assert_array_equal(out[:8], img[:8])
    assert not out[8:].any()


def test_gaussian_needs_a_generator_and_follows_it():
    img = _image(5)
    with pytest.raises(ValueError, match="Generator"):
        generate_noise(img, "gaussian")
    a = generate_noise(img, "gaussian", np.random.default_rng(1))
    b = generate_noise(img, "gaussian", np.random.default_rng(1))
    c = generate_noise(img, "gaussian", np.random.default_rng(2))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_unknown_noise_type_raises():
    with pytest.raises(ValueError, match="Unknown noise type"):
        generate_noise(_image(6), "blur")
    with pytest.raises(ValueError, match="Unknown noise type"):
        AirsimDataset("/nonexistent", noisy_type="blur")


@pytest.mark.parametrize("noise_type", ["occlusion", "grayscale", "lowres"])
@pytest.mark.parametrize("raw", [False, True], ids=["normalized", "raw"])
def test_dataset_noise_matches_jax(fixture_root, noise_type, raw):
    kw = dict(split="train", img_size=(IMG, IMG), target_view="6agent", commun_label="mimo",
              raw_images=raw, noisy_type=noise_type)
    port = AirsimDataset(fixture_root, use_native_decoder=False, **kw)
    jax_ds = JaxDataset(fixture_root, use_native_decoder=False, **kw)
    clean = AirsimDataset(fixture_root, use_native_decoder=False,
                          **{**kw, "noisy_type": None})
    for index in range(len(port)):
        got, want, plain = port[index], jax_ds[index], clean[index]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert not np.array_equal(got[0][0], plain[0][0])  # the requester's view degraded
        np.testing.assert_array_equal(got[0][1:], plain[0][1:])  # the others untouched
        np.testing.assert_array_equal(got[1], plain[1])  # labels untouched


def test_dataset_gaussian_is_a_function_of_seed_epoch_and_index(fixture_root):
    def ds(seed):
        return AirsimDataset(fixture_root, split="train", img_size=(IMG, IMG),
                             target_view="6agent", raw_images=True, noisy_type="gaussian",
                             seed=seed)

    a, b, c = ds(0), ds(0), ds(1)
    np.testing.assert_array_equal(a.load(1, 0)[0], b.load(1, 0)[0])
    assert not np.array_equal(a.load(1, 0)[0], a.load(1, 1)[0])  # another epoch
    assert not np.array_equal(a.load(1, 0)[0], c.load(1, 0)[0])  # another seed
    b.set_epoch(1)
    np.testing.assert_array_equal(b[1][0], a.load(1, 1)[0])
