"""``model.remat`` in the port: MIMOcom's two towers checkpointed in the
training forward (JAX ``nn.remat``, models/agents.py:406-411).

- One ``Trainer`` step with remat against one without, from the same
  weights and batch (CPU, 64x64, B=2, N=3): the loss, every gradient and
  every BatchNorm buffer (running statistics and ``num_batches_tracked``)
  are bit-identical, in float32, in mixed precision, and with
  ``freeze_bn_stats``. The recompute runs the same CPU operations on the
  same values, and it puts the BatchNorm buffers back as the first forward
  left them, so the momentum is applied once.
- The remat step against the JAX remat model's step on shared weights
  (256x256, B=2, N=3, tests/test_torch_train.py's setup): the loss within
  rtol 1e-5, the gradients within relative L2 3e-2 and cosine 0.9995 (at
  least 30 within 1e-3), the running statistics within rtol 1e-4 / atol
  1e-5: tests/test_torch_train.py's tolerances, whose docstring says why.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.loss import get_loss_function as jax_get_loss
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.models import get_model, init_weights
from multiagentperception_tpu_torch.trainer import Trainer
from test_torch_train import (  # noqa: F401 (few_threads: an autouse fixture)
    STATS,
    _make_shared,
    _raw_cfg,
    _rel,
    _zero_class,
    few_threads,
)

B, N, SMALL = 2, 3, 64
VARIANTS = {"float32": {}, "mixed_precision": {"mixed_precision": True},
            "freeze_bn_stats": {"freeze_bn_stats": True},
            "mixed_precision_freeze_bn_stats": {"mixed_precision": True,
                                                "freeze_bn_stats": True}}


def _cfg(remat: bool, img: int = SMALL, **training) -> dict:
    raw = _raw_cfg("plain", N, img)
    raw["model"]["remat"] = remat
    raw["training"].update(training)
    return raw


def _batch(img: int = SMALL, seed: int = 0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(B, N, img, img, 3)).astype(np.float32)
    labels = rng.integers(0, 11, (B, N, img, img)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 250
    return images, labels


def _step(remat: bool, state: dict, images, labels, img: int = SMALL, **training) -> dict:
    cfg = normalize_config(_cfg(remat, img, **training))
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device="cpu")
    trainer.model.load_state_dict(state, strict=True)
    loss = trainer.train_step(*trainer._batch(images, labels))
    return {"loss": loss, "model": trainer.model,
            "grads": {n: p.grad for n, p in trainer.model.named_parameters()},
            "buffers": dict(trainer.model.named_buffers())}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_step_equals_the_plain_step(variant):
    training = VARIANTS[variant]
    state = init_weights(get_model(normalize_config(_cfg(False)), 11), 0).state_dict()
    images, labels = _batch()
    plain = _step(False, state, images, labels, **training)
    remat = _step(True, state, images, labels, **training)
    assert remat["model"].remat and not plain["model"].remat
    assert torch.equal(plain["loss"], remat["loss"])
    for name, g in plain["grads"].items():
        assert torch.equal(g, remat["grads"][name]), name
    frozen = training.get("freeze_bn_stats", False)
    for name, buf in plain["buffers"].items():
        assert torch.equal(buf, remat["buffers"][name]), name
        if name.endswith("num_batches_tracked"):
            assert int(buf) == (0 if frozen else 1), name
        elif not frozen and name.endswith("running_var"):
            assert not torch.equal(buf, state[name]), name  # updated, and only once


def _saved_bytes(remat: bool) -> int:
    """Bytes autograd keeps for the backward of one training forward."""
    model = init_weights(get_model(normalize_config(_cfg(remat)), 11), 0).train()
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(torch.from_numpy(_batch()[0]))
    return saved[0]


def test_remat_keeps_fewer_activations():
    plain, remat = _saved_bytes(False), _saved_bytes(True)
    print(f"saved for the backward: {plain} bytes, with remat {remat}")
    assert remat < plain / 4


def test_remat_changes_nothing_at_eval():
    """Eval mode, and a training forward without gradients, run the towers
    plainly: the same outputs, no checkpoint."""
    state = init_weights(get_model(normalize_config(_cfg(False)), 11), 0).state_dict()
    x = torch.from_numpy(_batch()[0])
    outs = {}
    for remat in (False, True):
        model = get_model(normalize_config(_cfg(remat)), 11)
        model.load_state_dict(state)
        with torch.inference_mode():
            outs[remat] = [model.eval()(x, inference=mode, full_res=False)[0]
                           for mode in ("softmax", "activated")]
            outs[remat].append(model.train()(x)[0])
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)


def test_other_architectures_ignore_remat(caplog):
    cfg = _cfg(True)
    cfg["model"].update(arch="MIMOcomWho", query=True)
    with caplog.at_level(logging.WARNING, logger="multiagentperception_tpu_torch"):
        model = get_model(normalize_config(cfg), 11)
    assert not model.remat
    assert "model.remat is a MIMOcom extension and is ignored" in caplog.text


# ------------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def against_jax():
    """The first step of the JAX remat model and of the port's remat
    ``Trainer`` on shared weights and one batch (tests/test_torch_train.py)."""
    raw, images, labels, variables = _make_shared(B, N)
    jcfg = jax_normalize_config(_cfg(True, img=256))
    model, loss_fn = jax_get_model(jcfg, 11), jax_get_loss(jcfg)
    y = labels.reshape((-1,) + labels.shape[2:]).astype(np.uint8)

    def first_loss(params):
        out, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(images), train=True, mo_flag=True,
                               inference="softmax", mutable=["batch_stats"])
        return loss_fn(input=out[0], target=jnp.asarray(y)), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(first_loss, has_aux=True))(
        variables["params"])
    as_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    ref = state_dict_from_flax(jcfg, {"params": as_np(grads), "batch_stats": as_np(stats)})

    cfg = normalize_config(_cfg(True, img=256))
    port = _step(True, state_dict_from_flax(cfg, variables), images, labels, img=256)
    return float(loss), ref, port


def test_remat_loss_matches_jax_remat(against_jax):
    loss, _, port = against_jax
    np.testing.assert_allclose(float(port["loss"]), loss, rtol=1e-5)


def test_remat_gradients_match_jax_remat(against_jax):
    _, ref, port = against_jax
    zero = _zero_class(port["grads"], "plain")
    within_1e3 = 0
    for name, g in port["grads"].items():
        jg = torch.as_tensor(ref[name])
        if name in zero:
            assert max(g.norm(), jg.norm()) < 1e-4, name
            continue
        err = _rel(g, jg)
        cos = float(torch.nn.functional.cosine_similarity(
            g.double().flatten(), jg.double().flatten(), dim=0))
        assert err <= 3e-2 and cos >= 0.9995, f"{name}: relative L2 {err:.2e}, cosine {cos:.6f}"
        within_1e3 += err <= 1e-3
    assert len(port["grads"]) - len(zero) > 150 and within_1e3 >= 30


def test_remat_bn_statistics_match_jax_remat(against_jax):
    _, ref, port = against_jax
    names = [n for n in port["buffers"] if n.endswith(STATS)]
    assert len(names) > 50
    for name in names:
        np.testing.assert_allclose(port["buffers"][name].numpy(), ref[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
