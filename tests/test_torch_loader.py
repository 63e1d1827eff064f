"""The port's loader on the CPU against the JAX package's, on the synthetic
AirSim fixture (32x32, 6 agents):

- the decoded-frame cache: a round trip and a hit; ``commun_label``; a file
  written by JAX and read by the port, and the reverse (same names, same
  layout); two worker processes writing one frame at once; noise on cached
  frames;
- the native decoder (``native.py``, built from ``csrc/decoder.cpp``) against
  cv2 and JAX's: one image, a batch, ``png_info``, a missing file, a
  geometry mismatch, and the dataset's native path equal to its cv2 path;
  the decoder choice: cv2 where it imports, else native; neither raises
  naming both; a forced native build that fails raises with the compiler's
  error, and one that does not load with the loader's;
- ``GrainLoader`` (``torch.utils.data``): unshuffled batches equal to JAX's;
  each shuffled epoch the same multiset as JAX's, in a new order; ``len``
  and ``drop_last``; a state round trip and a restore across instances;
  2 spawned worker processes give the stream that 0 workers give (noise and
  augmentations included), from other pids; a worker's error reaches the
  consumer; sharding refused;
- ``generate_fixture`` byte for byte against JAX's, and ``validate_dataset``
  with JAX's output and exit codes.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib.util
import io
import multiprocessing
import os
import sys
from collections import Counter
from pathlib import Path

import cv2
import numpy as np
import pytest

from multiagentperception_tpu import native as jax_native
from multiagentperception_tpu.data import AirsimDataset as JaxDataset
from multiagentperception_tpu.data.grain_pipeline import GrainLoader as JaxGrainLoader
from multiagentperception_tpu.data.synthetic import generate_fixture as jax_generate_fixture
from multiagentperception_tpu_torch import native
from multiagentperception_tpu_torch import validate_dataset as port_validate
from multiagentperception_tpu_torch.data import AirsimDataset, get_composed_augmentations
from multiagentperception_tpu_torch.data.grain_pipeline import GrainLoader
from multiagentperception_tpu_torch.data.synthetic import generate_fixture
from torch_loader_helpers import FailingDataset, PidDataset

ROOT = Path(__file__).resolve().parents[1]
IMG = 32
SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_loader") / "data")
    generate_fixture(root, target_view="6agent", img_size=IMG, frames_per_traj=3)
    return root


def _port(root, **kw):
    return AirsimDataset(root, **{"split": "train", "target_view": "6agent",
                                  "img_size": (IMG, IMG), **kw})


def _jax(root, **kw):
    return JaxDataset(root, **{"split": "train", "target_view": "6agent",
                               "img_size": (IMG, IMG), **kw})


def _equal(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------------------------ the cache

@pytest.mark.parametrize("raw", [False, True], ids=["normalized", "raw"])
def test_cache_round_trip_and_hit(fixture_root, tmp_path, raw):
    cache = tmp_path / "cache"
    plain, cached = _port(fixture_root, raw_images=raw), \
        _port(fixture_root, raw_images=raw, cache_decoded=str(cache))
    _equal(cached[0], plain[0])  # a miss: decode and write
    assert [p.name for p in cache.iterdir()] == [Path(cached._cache_path(0)).name]
    block = np.load(cached._cache_path(0))
    assert block.shape == (6, IMG, IMG, 4) and block.dtype == np.uint8
    _equal(cached[0], plain[0])  # a hit
    assert len(list(cache.iterdir())) == 1


def test_cache_with_comm_labels(fixture_root, tmp_path):
    ds = _port(fixture_root, commun_label="mimo", cache_decoded=str(tmp_path / "c"))
    first, again = ds[1], ds[1]
    assert len(first) == 3
    _equal(first, again)
    _equal(first, _port(fixture_root, commun_label="mimo")[1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_is_shared_with_jax(fixture_root, tmp_path, writer):
    """A cache written by one package is read, unchanged, by the other."""
    cache = str(tmp_path / "shared")
    kw = dict(commun_label="mimo", raw_images=True, cache_decoded=cache)
    write, read = (_jax, _port) if writer == "jax" else (_port, _jax)
    plain = (_port if writer == "jax" else _jax)(fixture_root, commun_label="mimo",
                                                 raw_images=True)
    written = write(fixture_root, **kw)
    for i in range(len(written)):
        written[i]
    stamps = {p: os.stat(os.path.join(cache, p)).st_mtime_ns for p in os.listdir(cache)}
    reader = read(fixture_root, **kw)
    assert reader._cache_path(2) == written._cache_path(2)
    for i in range(len(reader)):
        _equal(reader[i], plain[i])
    assert {p: os.stat(os.path.join(cache, p)).st_mtime_ns for p in os.listdir(cache)} == stamps


def test_cached_frames_take_noise_and_augmentations(fixture_root, tmp_path):
    kw = dict(noisy_type="gaussian", seed=4,
              augmentations=get_composed_augmentations({"hflip": 0.5, "rotate": 10}))
    plain = _port(fixture_root, **kw)
    cached = _port(fixture_root, cache_decoded=str(tmp_path / "c"), **kw)
    for epoch in (0, 3):
        _equal(cached.load(2, epoch), plain.load(2, epoch))  # a miss, then a hit
        _equal(cached.load(2, epoch), plain.load(2, epoch))


def test_two_worker_processes_write_one_frame(fixture_root, tmp_path):
    cache = tmp_path / "mp"
    ds = _port(fixture_root, raw_images=True, cache_decoded=str(cache))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as pool:
        futures = [pool.submit(ds.load, 0, 0) for _ in range(8)]
        results = [f.result(timeout=SPAWN_TIMEOUT_S) for f in futures]
    want = _port(fixture_root, raw_images=True)[0]
    for got in results:
        _equal(got, want)
    assert sorted(p.name for p in cache.iterdir()) == [Path(ds._cache_path(0)).name]


# ------------------------------------------------------------------ the native decoder

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        p = str(d / f"{i}.png")
        cv2.imwrite(p, rng.integers(0, 256, (32, 24, 3), np.uint8))
        paths.append(p)
    gray = str(d / "gray.png")
    cv2.imwrite(gray, rng.integers(0, 256, (32, 24), np.uint8))
    return paths, gray


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def test_native_builds_into_the_package_build_dir():
    path = native.build()
    assert path.parent == ROOT / "multiagentperception_tpu_torch" / "build" / "native"
    assert native.available()


def test_native_single_matches_cv2_and_jax(pngs):
    paths, gray = pngs
    np.testing.assert_array_equal(native.decode_image(paths[0]), _cv2_rgb(paths[0]))
    np.testing.assert_array_equal(native.decode_image(gray), _cv2_rgb(gray))
    if jax_native.available():
        np.testing.assert_array_equal(native.decode_image(paths[1]),
                                      jax_native.decode_image(paths[1]))


@pytest.mark.parametrize("nthreads", [0, 1, 4])
def test_native_batch_matches_cv2(pngs, nthreads):
    paths, _ = pngs
    batch = native.decode_batch(paths, 32, 24, 3, nthreads=nthreads)
    assert batch.shape == (6, 32, 24, 3)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(batch[i], _cv2_rgb(p))


def test_native_png_info(pngs):
    paths, gray = pngs
    assert native.png_info(paths[0]) == (24, 32, 3)
    assert native.png_info(gray) == (24, 32, 3)  # gray decodes to RGB


def test_native_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        native.decode_image(str(tmp_path / "nope.png"))
    with pytest.raises(IOError, match="cannot open"):
        native.png_info(str(tmp_path / "nope.png"))


def test_native_geometry_mismatch_raises(pngs, tmp_path):
    paths, _ = pngs
    odd = str(tmp_path / "odd.png")
    cv2.imwrite(odd, np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(IOError, match="geometry"):
        native.decode_batch(paths[:2] + [odd], 32, 24, 3)


@pytest.mark.parametrize("raw", [False, True], ids=["normalized", "raw"])
def test_dataset_native_path_equals_cv2_path(fixture_root, raw):
    nat = _port(fixture_root, raw_images=raw, commun_label="mimo", use_native_decoder=True)
    cv = _port(fixture_root, raw_images=raw, commun_label="mimo", use_native_decoder=False)
    want = _jax(fixture_root, raw_images=raw, commun_label="mimo", use_native_decoder=False)
    assert nat.use_native_decoder and not cv.use_native_decoder
    for i in range(len(nat)):
        _equal(nat[i], cv[i])
        _equal(nat[i], want[i])


def test_decoder_choice(fixture_root, monkeypatch):
    assert _port(fixture_root).use_native_decoder is False  # cv2 imports here
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    assert _port(fixture_root).use_native_decoder is True

    def no_build():
        raise native.NativeBuildError("g++: fatal error: no input files")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", no_build)
    with pytest.raises(RuntimeError, match="cv2 does not import.*native decoder does not build"):
        _port(fixture_root)


def test_a_native_build_that_does_not_load_raises(fixture_root, tmp_path, monkeypatch):
    """A library that links but whose libpng the loader cannot find (the
    case of a host with libpng at link time only) raises the OSError."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", lambda: tmp_path / "libmissing.so")
    with pytest.raises(OSError, match="libmissing"):
        _port(fixture_root, use_native_decoder=True)
    assert not native.available()


def test_forced_native_build_failure_raises_the_compiler_error(fixture_root, tmp_path,
                                                               monkeypatch):
    broken = tmp_path / "decoder.cpp"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="error"):
        _port(fixture_root, use_native_decoder=True)
    assert not list((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------------------ GrainLoader

@pytest.mark.parametrize("drop_last", [False, True])
def test_grain_unshuffled_matches_jax(fixture_root, drop_last):
    port = list(GrainLoader(_port(fixture_root, commun_label="mimo"), 4, drop_last=drop_last))
    want = list(JaxGrainLoader(_jax(fixture_root, commun_label="mimo"), 4, drop_last=drop_last))
    assert len(port) == len(want) == (1 if drop_last else 2)
    for a, b in zip(port, want):
        _equal(a, b)


def _fingerprints(batches) -> list:
    return [int(b[1].astype(np.int64).sum()) for b in batches]


def test_grain_epochs_reshuffle_over_jax_multisets(fixture_root):
    ds = _port(fixture_root)
    loader = GrainLoader(ds, 1, shuffle=True, seed=5)
    e1, e2 = _fingerprints(loader), _fingerprints(loader)
    jax_loader = JaxGrainLoader(_jax(fixture_root), 1, shuffle=True, seed=5)
    j1, j2 = _fingerprints(jax_loader), _fingerprints(jax_loader)
    assert Counter(e1) == Counter(e2) == Counter(j1) == Counter(j2)
    assert e1 != e2
    assert e1 == _fingerprints(GrainLoader(ds, 1, shuffle=True, seed=5))  # seed + epoch


def test_grain_len_and_drop_last(fixture_root):
    ds = _port(fixture_root)
    assert len(ds) == 6
    assert len(GrainLoader(ds, 4, drop_last=True)) == 1 == len(list(GrainLoader(ds, 4,
                                                                            drop_last=True)))
    assert len(GrainLoader(ds, 4)) == 2 == len(list(GrainLoader(ds, 4)))
    with pytest.raises(ValueError, match="no batch"):
        next(GrainLoader(ds, 8, drop_last=True).persistent_iterator())


def test_grain_state_round_trip(fixture_root):
    loader = GrainLoader(_port(fixture_root), 2, shuffle=True, seed=3, drop_last=True)
    it = loader.persistent_iterator()
    firsts = [next(it) for _ in range(4)]  # into the second epoch
    state = loader.get_state()
    assert state == {"seed": 3, "epoch": 1, "consumed": 1}
    second = next(it)
    loader.set_state(state)
    _equal(next(it), second)  # the same iterator continues from the state
    loader.set_state({"seed": 3, "epoch": 0, "consumed": 0})
    _equal(next(it), firsts[0])


def test_grain_restores_across_instances(fixture_root):
    ds = _port(fixture_root, noisy_type="gaussian", seed=2,
               augmentations=get_composed_augmentations({"hflip": 0.5, "rcrop": 24}))
    a = GrainLoader(ds, 2, shuffle=True, seed=3, drop_last=True)
    it = a.persistent_iterator()
    next(it)
    next(it)
    state = a.get_state()
    expected = [next(it) for _ in range(3)]
    b = GrainLoader(ds, 2, shuffle=True, seed=99, drop_last=True)
    b.set_state(state)
    got = b.persistent_iterator()
    for want in expected:
        _equal(next(got), want)


def test_grain_worker_processes_give_the_same_stream(fixture_root):
    ds = PidDataset(_port(fixture_root, commun_label="mimo", noisy_type="gaussian", seed=1,
                          augmentations=get_composed_augmentations(
                              {"hflip": 0.5, "rotate": 10, "brightness": 0.3})))
    inline = GrainLoader(ds, 2, shuffle=True, seed=7, drop_last=True)
    spawned = GrainLoader(ds, 2, shuffle=True, seed=7, drop_last=True, num_workers=2)
    try:
        a, b = inline.persistent_iterator(), spawned.persistent_iterator()
        pids = set()
        for _ in range(5):  # across an epoch's end
            x, y = next(a), next(b)
            _equal(x[:-1], y[:-1])
            assert set(x[-1]) == {os.getpid()}
            pids |= set(int(p) for p in y[-1])
        assert os.getpid() not in pids and len(pids) >= 1
        assert spawned.get_state() == inline.get_state()
    finally:
        spawned.shutdown()


def test_grain_worker_error_reaches_the_consumer(fixture_root):
    order = GrainLoader(_port(fixture_root), 2, shuffle=True, seed=0).order(0)
    loader = GrainLoader(FailingDataset(_port(fixture_root), bad=int(order[3])), 2,
                         shuffle=True, seed=0, num_workers=1)
    try:
        it = loader.persistent_iterator()
        next(it)
        with pytest.raises(ValueError, match="unreadable"):
            next(it)
    finally:
        loader.shutdown()


def test_grain_sharding_is_refused(fixture_root):
    """No longer refused: in one process ``shard_by_process`` reads every
    frame (JAX's one process); an explicit slice reads its frames alone
    (the slices over ranks are tests/test_torch_parallel_train.py's)."""
    whole = GrainLoader(_port(fixture_root), 2, shard_by_process=True)
    assert whole.shard is None and len(whole) == len(GrainLoader(_port(fixture_root), 2))
    half = GrainLoader(_port(fixture_root), 1, shard_options=(1, 2))
    n = len(_port(fixture_root))
    assert list(half.order(0)) == list(range(n // 2, 2 * (n // 2)))


# ------------------------------------------------------------------ fixture and validation

def test_generate_fixture_matches_jax_byte_for_byte(tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    ma = generate_fixture(str(a), target_view="5agent", img_size=32, frames_per_traj=2, seed=3)
    mb = jax_generate_fixture(str(b), target_view="5agent", img_size=32, frames_per_traj=2,
                              seed=3)
    assert {**ma, "root": None} == {**mb, "root": None}
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert len(files) == 4 * 2 * 5 * 2 + 2
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _run_validate(main, args) -> tuple[int, str]:
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            main(args)
        except SystemExit as stop:
            code = stop.code or 0
    return code, out.getvalue()


@pytest.fixture(scope="module")
def jax_validate():
    spec = importlib.util.spec_from_file_location("jax_validate_dataset",
                                                  ROOT / "scripts" / "validate_dataset.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def main(args):
        argv = sys.argv
        sys.argv = ["validate_dataset.py", *args]
        try:
            module.main()
        finally:
            sys.argv = argv

    return main


@pytest.mark.parametrize("case", ["complete", "hole", "no_labels", "no_root"])
def test_validate_dataset_matches_jax(tmp_path, jax_validate, case):
    root = tmp_path / "data"
    generate_fixture(str(root), target_view="6agent", img_size=16, frames_per_traj=2)
    args = ["--path", str(root), "--target_view", "6agent", "--commun_label", "mimo"]
    if case == "hole":
        next(root.glob("segmentation_decoded/*/*/agent3/000001.png")).unlink()
    elif case == "no_labels":
        (root / "gt_mimo_communicate.txt").unlink()
    elif case == "no_root":
        args[1] = str(tmp_path / "missing")
    got = _run_validate(port_validate.main, args)
    want = _run_validate(jax_validate, args)
    assert got == want
    assert got[0] == {"complete": 0, "hole": 1, "no_labels": 2, "no_root": 2}[case]


def test_bench_loader_rates_counts_every_loader(fixture_root, tmp_path):
    """``bench_train_pipeline.loader_rates`` (phase 14's loader timing) at
    toy size: each loader's passes count every agent view of the split."""
    from multiagentperception_tpu_torch import bench_train_pipeline

    rates = bench_train_pipeline.loader_rates(fixture_root, IMG, 2, 1, str(tmp_path), passes=2)
    views = len(_port(fixture_root)) * 6
    assert set(rates) == {"cv2_threads", "native_threads", "cache_cold", "cache_warm",
                          "grain_1_workers"}
    assert [rates[k]["frames"] for k in ("cv2_threads", "native_threads", "cache_cold",
                                         "cache_warm", "grain_1_workers")] == \
        [2 * views, 2 * views, views, 2 * views, 3 * views - 12]
    assert all(r["frames_per_s"] > 0 for r in rates.values())
