"""The capture-safe forms of the port's step code, on the CPU, against what
they replaced and against the JAX package:

- ``ops.comm.confusion_matrix`` (a scatter-add into C*C + 1 bins, where it
  took ``torch.bincount``, which reads its input's range back to the host
  on CUDA) equals the ``bincount`` form and JAX's ``confusion_matrix``,
  with the ignore index 250, out-of-range predictions and the normal/noise
  sample masks; exact integer counts.
- Each of the seven optimizers with an lr tensor in its groups
  (``optimizers.lr_tensor``, filled by ``set_lr``) steps exactly as with
  the float lr, under a constant and a warmed-up schedule; so does ASGD
  with its count a tensor (``make_capturable`` keeps it on the device).
  ``make_eager`` undoes ``make_capturable``'s lr and counts.
- ``num_connect`` of the softmax forwards is a 0-dim float32 fill, equal
  to the old ``torch.tensor`` of it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu.ops.comm import confusion_matrix as jax_confusion_matrix
from multiagentperception_tpu_torch.ops.comm import confusion_matrix
from multiagentperception_tpu_torch.optimizers import (
    ASGD,
    get_optimizer,
    lr_tensor,
    make_capturable,
    make_eager,
    set_lr,
)
from multiagentperception_tpu_torch.schedulers import get_scheduler
from test_torch_optim import OPTIMIZERS, WARMED, _id

C = 11


def _bincount_form(label_true, label_pred, n_classes, sample_mask=None):
    """The form ``confusion_matrix`` had before: ``torch.bincount``."""
    t = label_true.reshape(label_true.shape[0], -1).to(torch.int64)
    p = label_pred.reshape(label_pred.shape[0], -1).to(torch.int64)
    valid = (t >= 0) & (t < n_classes)
    if sample_mask is not None:
        valid = valid & sample_mask.reshape(-1, 1).to(torch.bool)
    idx = t * n_classes + p.clamp(0, n_classes - 1)
    idx = torch.where(valid, idx, torch.full_like(idx, n_classes * n_classes))
    counts = torch.bincount(idx.reshape(-1), minlength=n_classes * n_classes + 1)
    return counts[: n_classes * n_classes].reshape(n_classes, n_classes)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mask", ["none", "normal", "noise"])
def test_confusion_matrix_equals_bincount_and_jax(seed, mask):
    rng = np.random.default_rng(seed)
    n = 6
    y = rng.integers(0, C, (n, 32, 48)).astype(np.uint8)
    y[rng.random(y.shape) < 0.1] = 250  # the ignore index
    pred = rng.integers(0, C, (n, 32, 48)).astype(np.int32)
    if seed == 3:  # every pixel of a frame ignored, and every frame
        y[0] = 250
    flags = rng.integers(0, 2, n).astype(bool)
    sample = {"none": None, "normal": flags, "noise": ~flags}[mask]
    t_mask = None if sample is None else torch.from_numpy(sample)
    got = confusion_matrix(torch.from_numpy(y), torch.from_numpy(pred), C, t_mask)
    old = _bincount_form(torch.from_numpy(y), torch.from_numpy(pred), C, t_mask)
    ref = np.asarray(jax_confusion_matrix(jnp.asarray(y), jnp.asarray(pred), C,
                                          None if sample is None else jnp.asarray(sample)))
    assert got.dtype == torch.int64 and tuple(got.shape) == (C, C)
    np.testing.assert_array_equal(got.numpy(), old.numpy())
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    keep = (y < C) if sample is None else (y < C) & sample[:, None, None]
    assert int(got.sum()) == int(keep.sum())


def _params(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}


@pytest.mark.parametrize("schedule_cfg", [None, WARMED], ids=["constant", "warmed_multistep"])
@pytest.mark.parametrize("opt_cfg", OPTIMIZERS, ids=_id)
def test_tensor_lr_steps_exactly_as_float_lr(opt_cfg, schedule_cfg):
    cfg = {"training": {"optimizer": dict(opt_cfg)}}
    rng = np.random.default_rng(1)
    start = _params(rng)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in start.items()}
             for _ in range(5)]
    schedule = get_scheduler(schedule_cfg, opt_cfg["lr"])
    runs = {}
    for kind in ("float", "tensor"):
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
        opt = get_optimizer(cfg, list(params.values()), schedule(0))
        if kind == "tensor":
            lr = lr_tensor(schedule(0), "cpu")
            for group in opt.param_groups:
                group["lr"] = lr
        for t, g in enumerate(grads):
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k].copy())
            set_lr(opt, schedule(t))
            opt.step()
        if kind == "tensor":
            assert opt.param_groups[0]["lr"] is lr and float(lr) == schedule(len(grads) - 1)
        runs[kind] = params
    for k in start:
        assert torch.equal(runs["tensor"][k], runs["float"][k]), k


def test_asgd_with_a_tensor_count_steps_exactly():
    rng = np.random.default_rng(2)
    start = _params(rng)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in start.items()}
             for _ in range(5)]
    out = {}
    for kind in ("int", "tensor"):
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
        opt = ASGD(list(params.values()), 1e-2, lambd=1e-2, weight_decay=1e-3)
        if kind == "tensor":
            opt.param_groups[0]["step"] = torch.zeros((), dtype=torch.float64)
        for g in grads:
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
        out[kind] = (params, opt.param_groups[0]["step"])
    assert int(out["tensor"][1]) == out["int"][1] == 5
    for k in start:
        assert torch.equal(out["tensor"][0][k], out["int"][0][k]), k


@pytest.mark.parametrize("name", ["adam", "asgd", "sgd"])
def test_make_eager_undoes_make_capturable(name):
    p = torch.nn.Parameter(torch.ones(3))
    opt = get_optimizer({"training": {"optimizer": {"name": name, "lr": 0.1,
                                                    "momentum": 0.9}}}, [p])
    p.grad = torch.ones(3)
    opt.step()
    lr = lr_tensor(0.05, "cpu")
    make_capturable(opt, lr)
    group = opt.param_groups[0]
    assert group["lr"] is lr
    assert group.get("capturable", True)
    if name == "asgd":
        assert isinstance(group["step"], torch.Tensor) and int(group["step"]) == 1
    make_eager(opt)
    assert group["lr"] == 0.05 and not group.get("capturable", False)
    if name == "asgd":
        assert group["step"] == 1
    for st in opt.state.values():
        if "step" in st:
            assert st["step"].device.type == "cpu" and float(st["step"]) == 1.0
    opt.step()  # eager again


def test_num_connect_fill_equals_the_host_tensor():
    for n in (2, 5, 6):
        old = torch.tensor(float(n - 1))
        new = torch.full((), float(n - 1))
        assert new.dtype == old.dtype == torch.float32 and new.shape == old.shape
        assert torch.equal(new, old)
