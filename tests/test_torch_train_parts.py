"""Parts of the port's training held against the JAX package on the CPU:
the train step's gradients in float64, a ResNet basic block in training
mode (output and BatchNorm running statistics), and the shuffled order of
the training batches.

Tolerances: float64 gradients within relative L2 1e-6 per tensor (the same
arithmetic on both sides; the JAX BatchNorm, loss and graph softmax are
lifted from their float32 casts for this comparison only), and the port's
float32 gradients within 5e-3 of its float64 ones (measured up to 2.3e-3;
the JAX package's own float32 gradients lie up to ~1.5e-2 away, which is
why tests/test_torch_train.py cannot hold float32 against float32 at 1e-3
for every tensor). The basic block: output rtol/atol 1e-5 and running
statistics rtol 1e-5, atol 1e-6 (one block of float32 convolutions).
"""

from __future__ import annotations

import contextlib
import copy
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiagentperception_tpu.loss as jax_loss_module
import multiagentperception_tpu.models.attention as jax_attention_module
import multiagentperception_tpu.models.blocks as jax_blocks_module
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.data.pipeline import DataLoader as JaxDataLoader
from multiagentperception_tpu.models.blocks import BasicBlock as JaxBasicBlock
from multiagentperception_tpu_torch import convert
from multiagentperception_tpu_torch.data.pipeline import DataLoader
from multiagentperception_tpu_torch.models.blocks import BasicBlock
from test_torch_train import (  # noqa: F401 (few_threads: an autouse fixture)
    _jax_grads,
    _make_shared,
    _port_trainer,
    _raw_cfg,
    _rel,
    _zero_class,
    few_threads,
)


@contextlib.contextmanager
def _jax_float64():
    """x64 on, and the JAX BatchNorm, loss and attention see ``jnp.float32``
    as float64, so their float32 casts keep float64."""
    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    shim.float32 = jnp.float64
    with jax.enable_x64(True), contextlib.ExitStack() as stack:
        for module in (jax_blocks_module, jax_loss_module, jax_attention_module):
            stack.enter_context(mock.patch.object(module, "jnp", shim))
        yield


def _port_grads(trainer, x, y, dtype):
    """The first step's gradients without the update, in ``dtype``."""
    model32, trainer.model = trainer.model, copy.deepcopy(trainer.model).to(dtype)
    try:
        trainer.train_mode()
        pred = trainer.model(x.to(dtype), inference="softmax")[0]
        trainer.loss_fn(input=pred, target=y).backward()
        return {n: p.grad.double() for n, p in trainer.model.named_parameters()}
    finally:
        trainer.model = model32


def test_gradients_match_jax_in_float64():
    """One sample of two agents at 128x128 keeps the float64 JAX run short
    (XLA's float64 convolutions on the CPU are slow); the policy map's
    HWC->CHW permutation is held at 256x256 by tests/test_torch_train.py."""
    raw, images, labels, variables = _make_shared(1, 2, seed=1, img=128)
    cfg = jax_normalize_config(_raw_cfg("plain", 2, img=128))
    y = labels.reshape((-1,) + labels.shape[2:]).astype(np.uint8)
    with _jax_float64():
        ref = _jax_grads(cfg, variables, images, y, "plain", jnp.float64)
    trainer = _port_trainer("plain", variables, agents=2, img=128)
    x, yt = trainer._batch(images, labels)
    g64, g32 = (_port_grads(trainer, x, yt, dt) for dt in (torch.float64, torch.float32))
    zero = _zero_class(g64, "plain")
    assert len(g64) > 150
    for name, g in g64.items():
        if name in zero:
            assert max(g.norm(), torch.as_tensor(ref[name]).norm()) < 1e-12, name
            continue
        assert _rel(g, ref[name]) <= 1e-6, f"{name}: {_rel(g, ref[name]):.2e}"
        assert _rel(g32[name], g) <= 5e-3, f"{name}: float32 {_rel(g32[name], g):.2e}"


@pytest.mark.parametrize("cin,cout,stride", [(64, 64, 1), (64, 128, 2)],
                         ids=["identity", "projection"])
def test_basic_block_training_mode_matches_jax(cin, cout, stride):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 16, 16, cin)) + 0.5).astype(np.float32)
    jb = JaxBasicBlock(cout, strides=stride)
    variables = jax.tree_util.tree_map(
        np.asarray, jb.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), variables["batch_stats"])
    j_out, j_upd = jb.apply({"params": variables["params"], "batch_stats": stats},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])

    out = convert._Out()
    convert._basic_block(out, "b", variables["params"], stats)
    block = BasicBlock(cin, cout, stride)
    block.load_state_dict({k[2:]: v for k, v in out.sd.items()}, strict=True)
    block.train()
    t_out = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(t_out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-5)
    updated = convert._Out()
    convert._basic_block(updated, "b", variables["params"],
                         jax.tree_util.tree_map(np.asarray, j_upd["batch_stats"]))
    for key, want in updated.sd.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(block.state_dict()[key[2:]].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.asarray([i]),)


@pytest.mark.parametrize("seed", [0, 1337])
def test_shuffled_training_order_matches_jax(seed):
    """The train loader's shuffle (drop_last, per-epoch reshuffle) draws the
    same order as the JAX package's for one seed, over three epochs."""
    def order(loader_cls):
        loader = loader_cls(_Indexed(11), 2, shuffle=True, drop_last=True, num_workers=1,
                            seed=seed)
        return [batch[0].ravel().tolist() for _ in range(3) for batch in loader]

    assert order(DataLoader) == order(JaxDataLoader)
    assert len(order(DataLoader)) == 15
