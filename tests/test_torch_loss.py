"""The port's losses against the JAX package's on the same numpy inputs
(logits NCHW in the port, NHWC in JAX; labels with ignored pixels).
Tolerance rtol 1e-5: one float32 log-softmax and one mean on each side."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu import loss as jax_loss
from multiagentperception_tpu_torch import loss

C = 11


def _inputs(seed=0, n=2, h=16, w=16, ignore=0.1, dtype=np.int32):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, h, w, C)) * 2).astype(np.float32)
    target = rng.integers(0, C, (n, h, w)).astype(dtype)
    target[rng.random(target.shape) < ignore] = loss.IGNORE_INDEX
    return logits, target


def _port(fn, logits, target, **kw):
    nchw = (tuple(torch.from_numpy(x).permute(0, 3, 1, 2) for x in logits)
            if isinstance(logits, tuple) else torch.from_numpy(logits).permute(0, 3, 1, 2))
    return float(fn(input=nchw, target=torch.from_numpy(target), **kw))


def _jax(fn, logits, target, **kw):
    nhwc = tuple(map(jnp.asarray, logits)) if isinstance(logits, tuple) else jnp.asarray(logits)
    return float(fn(input=nhwc, target=jnp.asarray(target), **kw))


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(size_average, weighted):
    logits, target = _inputs()
    kw = {"size_average": size_average}
    if weighted:
        kw["weight"] = np.linspace(0.5, 1.5, C).astype(np.float32)
    np.testing.assert_allclose(
        _port(loss.cross_entropy2d, logits, target, **kw),
        _jax(jax_loss.cross_entropy2d, logits, target,
             **{**kw, **({"weight": jnp.asarray(kw["weight"])} if weighted else {})}),
        rtol=1e-5)


def test_uint8_labels_as_the_trainer_ships_them():
    logits, target = _inputs(dtype=np.uint8)
    np.testing.assert_allclose(_port(loss.cross_entropy2d, logits, target),
                               _jax(jax_loss.cross_entropy2d, logits, target), rtol=1e-5)


def test_all_ignored_batch_gives_zero_not_nan():
    logits, target = _inputs(ignore=1.0)
    assert _port(loss.cross_entropy2d, logits, target) == 0.0
    assert _jax(jax_loss.cross_entropy2d, logits, target) == 0.0


def test_resize_to_the_labels_with_aligned_corners():
    """Logits at 1/4 of the labels' size are resized with align_corners=True
    first (the reference's loss-path resize)."""
    logits, _ = _inputs(h=8, w=8)
    _, target = _inputs(seed=1, h=32, w=32)
    np.testing.assert_allclose(_port(loss.cross_entropy2d, logits, target),
                               _jax(jax_loss.cross_entropy2d, logits, target), rtol=1e-5)


def test_multi_scale_matches_jax():
    (a, target), (b, _) = _inputs(seed=2), _inputs(seed=3)
    for inp in ((a, b), a):
        np.testing.assert_allclose(
            _port(loss.multi_scale_cross_entropy2d, inp, target),
            _jax(jax_loss.multi_scale_cross_entropy2d, inp, target), rtol=1e-5)


@pytest.mark.parametrize("k", [1, 50, 256])
def test_bootstrapped_matches_jax(k):
    logits, target = _inputs(seed=4)
    np.testing.assert_allclose(_port(loss.bootstrapped_cross_entropy2d, logits, target, K=k),
                               _jax(jax_loss.bootstrapped_cross_entropy2d, logits, target, K=k),
                               rtol=1e-5)


@pytest.mark.parametrize("spec", [None, {"name": "cross_entropy", "size_average": False},
                                  {"name": "bootstrapped_cross_entropy", "K": 20},
                                  {"name": "multi_scale_cross_entropy"}],
                         ids=["default", "cross_entropy", "bootstrapped", "multi_scale"])
def test_registry_matches_jax(spec):
    cfg = {"training": {"loss": spec}}
    logits, target = _inputs(seed=5)
    np.testing.assert_allclose(_port(loss.get_loss_function(cfg), logits, target),
                               _jax(jax_loss.get_loss_function(cfg), logits, target), rtol=1e-5)


def test_registry_refuses_unknown():
    with pytest.raises(NotImplementedError, match="focal"):
        loss.get_loss_function({"training": {"loss": {"name": "focal"}}})
