"""One train step of each zoo architecture in the port against the JAX
``Trainer``'s step (its ``_train_step_body``) on shared weights and one
batch, on the CPU: 256x256, B=2, N=3, query_size 8, key_size 64, Adam at
1e-4, in the YAML's shape of each architecture (Single_agent with folded
views, both selection baselines, MIMOcomWho without a query, LearnWhen2Com,
LearnWho2Com with ``only_normal_agents`` encoders, whose BatchNorms see
agent 0 alone and agents 1..N-1 together, as in JAX).

The selection baselines draw their partners in the JAX step from its
state's key; the port's trainer is handed those ids.

Weights are the JAX init (attention not scaled: a saturated softmax
would make the policy tower's float32 gradients noise). Tolerances, as
tests/test_torch_train.py sets them and explains: the loss rtol 1e-5;
each gradient (state_dict layout) within relative L2 3e-2 and cosine
0.9995 (float32 chains of training-mode BatchNorms are ill-conditioned;
that file's float64 test holds the arithmetic to 1e-6). That file also
counts MIMOcom's tensors within 1e-3; its count is not carried over, since
how many lie that close depends on the network (2 of 193 for All_agents,
whose per-agent encoders normalize over 2 frames; 62 of 221 for
LearnWho2Com, measured on the CPU). Conv biases that a training-mode
BatchNorm follows, and ``key_net``'s last bias under a dot-product softmax
over keys, have a gradient of 0, and both sides' norms stay < 1e-4 there;
the encoders of All_agents' supporters not drawn get exact zeros on both
sides. BatchNorm running statistics after the step rtol 1e-4 / atol 1e-5;
parameters after the step atol 2*lr plus rtol 1e-4.
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
from multiagentperception_tpu.optimizers import get_optimizer as jax_get_optimizer
from multiagentperception_tpu.trainer import Trainer as JaxTrainer
from multiagentperception_tpu.trainer import TrainState
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.trainer import Trainer
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import B, IMG, N, jax_kwargs, model_inputs, raw_cfg, shared_variables

LR = 1e-4
STATS = ("running_mean", "running_var")
ARCHS = {
    "Single_agent": {},
    "All_agents": {"shuffle_features": "selection"},
    "MIMO_All_agents": {"shuffle_features": "selection"},
    "MIMOcomWho": {"query": False},
    "LearnWhen2Com": {},
    "LearnWho2Com": {"shared_img_encoder": "only_normal_agents"},
}


def _cfg(arch: str) -> dict:
    cfg = raw_cfg(arch, **ARCHS[arch])
    cfg["training"] = {"batch_size": B, "optimizer": {"name": "adam", "lr": LR},
                       "loss": {"name": "cross_entropy", "size_average": True}}
    return cfg


def _jax_step(cfg, variables, images, labels):
    """The JAX trainer's step on one batch: loss, first gradients, state
    after, and the partners its selection forward drew (or None)."""
    cfg = jax_normalize_config(cfg)
    tx = jax_get_optimizer(cfg)
    model, loss_fn = jax_get_model(cfg, 11), jax_get_loss(cfg)
    trainer = JaxTrainer(cfg, None, logging.getLogger("test"), model, loss_fn,
                         None, None, tx)
    x, y = jnp.asarray(trainer._model_inputs(images)), jnp.asarray(trainer._labels(labels))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(2))
    kw = jax_kwargs(cfg, True)
    action_rng = jax.random.split(state.rng)[1]  # the key the step's forward takes

    def loss_and_out(p):
        out, _ = model.apply({"params": p, "batch_stats": state.batch_stats}, x,
                             rngs={"action": action_rng}, mutable=["batch_stats"], **kw)
        pred = out[0] if isinstance(out, tuple) else out
        return loss_fn(input=pred, target=y), out

    grads, out = jax.jit(jax.grad(loss_and_out, has_aux=True))(state.params)
    ids = None
    if cfg["model"]["arch"] in ("All_agents", "MIMO_All_agents"):
        ids = np.array(out[1][0])
    new_state, loss = jax.jit(trainer._train_step_body())(state, x, y)
    to_sd = lambda p, s: state_dict_from_flax(cfg, jax.tree_util.tree_map(  # noqa: E731
        np.asarray, {"params": p, "batch_stats": s}))
    return {"loss": float(loss), "ids": ids,
            "grads": to_sd(grads, variables["batch_stats"]),
            "final": to_sd(jax.device_get(new_state.params),
                           jax.device_get(new_state.batch_stats))}


def _port_step(cfg, variables, images, labels, ids, monkeypatch):
    cfg = normalize_config(cfg)
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device="cpu")
    trainer.model.load_state_dict(state_dict_from_flax(cfg, variables), strict=True)
    if ids is not None:
        monkeypatch.setattr(trainer, "draw_ids", lambda stream: torch.from_numpy(
            np.asarray(ids, np.int64)))
    x, y = trainer._batch(images, labels)
    loss = float(trainer.train_step(x, y))
    return {"loss": loss,
            "grads": {n: p.grad.clone() for n, p in trainer.model.named_parameters()},
            "final": trainer.model.state_dict()}


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / (b.norm() + 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, monkeypatch):
    cfg = _cfg(arch)
    rng = np.random.default_rng(5)
    images = (rng.standard_normal((B, N, IMG, IMG, 3)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 11, (B, N, IMG, IMG)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 250
    x_init = model_inputs(cfg, images.shape)
    variables = shared_variables(cfg, x_init, seed=5, peaked=False)
    ref = _jax_step(cfg, variables, images, labels)
    port = _port_step(cfg, variables, images, labels, ref["ids"], monkeypatch)

    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    zero = {n for n in port["grads"] if n.endswith("cbr_unit.0.bias")}
    if cfg["model"].get("attention", "general") == "general" and "key_net.fc.4.bias" in \
            port["grads"]:
        zero.add("key_net.fc.4.bias")
    for name, g in port["grads"].items():
        jg = torch.as_tensor(ref["grads"][name])
        if not jg.any():  # All_agents: the encoders of the supporters not drawn
            assert not g.any(), name
            continue
        if name in zero:
            assert max(g.norm(), jg.norm()) < 1e-4, name
            continue
        err = _rel(g, jg)
        cos = float(torch.nn.functional.cosine_similarity(
            g.double().flatten(), jg.double().flatten(), dim=0))
        assert err <= 3e-2 and cos >= 0.9995, f"{name}: relative L2 {err:.2e}, cos {cos:.6f}"
    for name, v in port["final"].items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-4, atol=1e-5) if name.endswith(STATS) else \
            dict(rtol=1e-4, atol=2 * LR)
        np.testing.assert_allclose(v.numpy(), ref["final"][name], err_msg=name, **tol)
