"""The port's MIMOcom train step against the JAX package's ``Trainer`` step,
on shared weights and one batch (CPU), at 256x256 with B=2, N=3,
``query_size`` 8 and ``key_size`` 64: the policy map is 2x2, so the key and
query MLPs' HWC->CHW permutation acts on the gradients too. Variants: plain
and ``data.on_device_normalize`` here, ``training.freeze_bn_stats`` in
tests/test_torch_train_freeze.py (the same tests in a file of their own,
so the test runner's workers take the two in parallel).

Tolerances, and why:

- The first step's loss: rtol 1e-5. The later steps' losses: rtol 1e-3,
  since they follow parameters that Adam moved by about ``lr`` on gradient
  elements that are float32 noise (see the last point).
- The first step's gradients, per tensor, in the state_dict layout:

  - A conv bias that a training-mode BatchNorm follows has a gradient of 0
    (the batch mean cancels any shift), and so has ``key_net``'s last bias
    (one shift of every key adds a constant per query to the softmax's
    logits). Both sides give rounding noise there: each norm stays < 1e-4
    in float32 (< 1e-12 in float64).
  - In float64 (tests/test_torch_train_parts.py; the JAX side under
    ``jax.enable_x64``, its BatchNorm, loss and graph softmax lifted from
    their float32 casts for that comparison only): relative L2 <= 1e-6
    for every tensor. The two gradient computations are the same
    arithmetic.
  - In float32, with frozen BatchNorm statistics: relative L2 <= 1e-3
    for every tensor (measured at most 3.2e-4).
  - In float32, with BatchNorm in training mode: relative L2 <= 3e-2 with
    cosine >= 0.9995 for every tensor, and at least 30 of the 158 within
    1e-3 (46 measured). The float64 test shows why not 1e-3 for all:
    chains of training-mode BatchNorms make these gradients
    ill-conditioned, and the JAX package's own float32 gradients lie up to
    ~1.5e-2 from the float64 ones (its BatchNorm takes the variance as
    E[x^2] - E[x]^2, and the policy tower's BatchNorms over 8x8 maps
    amplify the rounding), while the port's lie within 5e-3. No float32
    comparison can be tighter than the reference's own error.
- BatchNorm running statistics after the first step: rtol 1e-4, atol 1e-5.
- Parameters after K = 3 steps: atol 2*K*lr plus rtol 1e-4. Adam moves an
  element by about ``lr`` per step whatever its gradient's size, so an
  element whose gradient is noise can move the other way in each framework.
"""

from __future__ import annotations

import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.loss import get_loss_function as jax_get_loss
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.ops.normalize import normalize_images as jax_normalize
from multiagentperception_tpu.optimizers import get_optimizer as jax_get_optimizer
from multiagentperception_tpu.trainer import Trainer as JaxTrainer
from multiagentperception_tpu.trainer import TrainState
from multiagentperception_tpu.utils import init_variables
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.loss import get_loss_function
from multiagentperception_tpu_torch.trainer import Trainer

B, N, IMG, K, LR = 2, 3, 256, 3, 1e-4
TORCH_THREADS = 2  # the test runner's workers share the host's cores
VARIANTS = ("plain", "on_device_normalize")
STATS = ("running_mean", "running_var")


def _raw_cfg(variant: str, agents: int = N, img: int = IMG) -> dict:
    return {
        "model": {"arch": "MIMOcom", "agent_num": agents, "query_size": 8, "key_size": 64,
                  "multiple_output": True},
        "data": {"img_rows": img, "img_cols": img, "commun_label": "mimo",
                 "on_device_normalize": variant == "on_device_normalize"},
        "training": {"batch_size": B, "optimizer": {"name": "adam", "lr": LR},
                     "loss": {"name": "cross_entropy", "size_average": True},
                     "freeze_bn_stats": variant == "freeze_bn_stats"},
    }


def _seeded_stats(tree, rng):
    if "mean" in tree:
        return {"mean": (rng.standard_normal(tree["mean"].shape) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, tree["var"].shape).astype(np.float32)}
    return {k: _seeded_stats(v, rng) for k, v in tree.items()}


def _make_shared(b: int, n: int, seed: int = 0, img: int = IMG):
    """JAX-initialized weights with seeded BatchNorm statistics, a raw uint8
    batch, its normalized float32 form, and labels with ignored pixels."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (b, n, img, img, 3), dtype=np.uint8)
    images = np.array(jax_normalize(jnp.asarray(raw)))  # writable
    labels = rng.integers(0, 11, (b, n, img, img)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 250
    jm = jax_get_model(jax_normalize_config(_raw_cfg("plain", n, img)), 11)
    variables = init_variables(jm, {"params": jax.random.PRNGKey(0)}, jnp.asarray(images),
                               train=True, mo_flag=True, inference="softmax")
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _seeded_stats(variables["batch_stats"], rng)}
    return raw, images, labels, variables


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs: the test runner's parallel
    workers would otherwise each start one per core and crowd the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def drop_files(request):
    """A test's own ``tmp_path`` (checkpoints of 0.1-0.4 GB, exported
    artifacts) goes when the test ends: the test runner's workers share one
    disk, and pytest keeps the temporary directories of the last three runs."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def shared():
    return _make_shared(B, N)


def _jax_grads(cfg, variables, x, y, variant, dtype):
    """The first step's gradients of the JAX model's loss in ``dtype``, as
    a port state_dict (the Trainer's step body keeps them inside)."""
    model, loss_fn = jax_get_model(cfg, 11), jax_get_loss(cfg)
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
    params, stats = cast(variables["params"]), cast(variables["batch_stats"])
    images = (jax_normalize(jnp.asarray(x), dtype=dtype) if variant == "on_device_normalize"
              else jnp.asarray(x, dtype))

    def first_loss(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, images, train=True,
                             mo_flag=True, inference="softmax",
                             bn_train=variant != "freeze_bn_stats", mutable=["batch_stats"])
        return loss_fn(input=out[0], target=jnp.asarray(y))

    grads = jax.jit(jax.grad(first_loss))(params)
    grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads)
    return state_dict_from_flax(cfg, {"params": grads, "batch_stats": variables["batch_stats"]})


def _jax_run(variant, shared, grads):
    """K steps of the JAX Trainer's jitted step; ``grads`` are the first
    step's gradients."""
    raw, images, labels, variables = shared
    cfg = jax_normalize_config(_raw_cfg(variant))
    tx = jax_get_optimizer(cfg)
    trainer = JaxTrainer(cfg, None, logging.getLogger("test"), jax_get_model(cfg, 11),
                         jax_get_loss(cfg), None, None, tx)
    x_host = raw if variant == "on_device_normalize" else images
    y_host = trainer._labels(labels)

    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(2))
    step = trainer._train_step_fn()
    x, y = jnp.asarray(x_host), jnp.asarray(y_host)
    losses, stats1 = [], None
    for k in range(K):
        state, loss = step(state, x, y)
        losses.append(float(loss))
        if k == 0:
            stats1 = jax.device_get(state.batch_stats)
    to_sd = lambda p, s: state_dict_from_flax(cfg, jax.tree_util.tree_map(  # noqa: E731
        np.asarray, {"params": p, "batch_stats": s}))
    return {"losses": losses, "grads": grads,
            "stats1": to_sd(variables["params"], stats1),
            "final": to_sd(jax.device_get(state.params), jax.device_get(state.batch_stats))}


def _port_trainer(variant, variables, agents: int = N, img: int = IMG):
    cfg = normalize_config(_raw_cfg(variant, agents, img))
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device="cpu")
    trainer.model.load_state_dict(state_dict_from_flax(cfg, variables), strict=True)
    return trainer


def _port_run(variant, shared):
    raw, images, labels, variables = shared
    trainer = _port_trainer(variant, variables)
    x, y = trainer._batch(raw if variant == "on_device_normalize" else images, labels)
    losses, grads, stats1 = [], None, None
    for k in range(K):
        losses.append(float(trainer.train_step(x, y)))
        if k == 0:
            grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
            stats1 = {n: v.clone() for n, v in trainer.model.state_dict().items()
                      if n.endswith(STATS)}
    return {"losses": losses, "grads": grads, "stats1": stats1,
            "final": trainer.model.state_dict()}


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def _zero_class(names, variant) -> set:
    """Tensors whose gradient is exactly 0 (module docstring)."""
    zero = {"key_net.fc.4.bias"}
    if variant != "freeze_bn_stats":
        zero |= {n for n in names if n.endswith("cbr_unit.0.bias")}
    assert len(zero) == (1 if variant == "freeze_bn_stats" else 8)
    return zero


@pytest.fixture(scope="module")
def jax_first_grads(shared):
    """The JAX model's first-step gradients per BatchNorm mode. Normalizing
    on the device feeds the model what ``images`` holds, so that variant
    shares the plain variant's gradients."""
    raw, images, labels, variables = shared
    y = labels.reshape((-1,) + labels.shape[2:]).astype(np.uint8)
    cache = {}

    def get(variant):
        mode = "freeze_bn_stats" if variant == "freeze_bn_stats" else "plain"
        if mode not in cache:
            cfg = jax_normalize_config(_raw_cfg(mode))
            cache[mode] = _jax_grads(cfg, variables, images, y, mode, jnp.float32)
        return cache[mode]

    return get


@pytest.fixture(scope="module", params=VARIANTS)
def runs(request, shared, jax_first_grads):
    variant = request.param
    return (variant, _port_run(variant, shared),
            _jax_run(variant, shared, jax_first_grads(variant)))


def test_loss_matches_jax(runs):
    _, port, ref = runs
    np.testing.assert_allclose(port["losses"][0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-3)


def test_gradients_match_jax(runs):
    variant, port, ref = runs
    zero = _zero_class(port["grads"], variant)
    frozen = variant == "freeze_bn_stats"
    within_1e3 = 0
    for name, g in port["grads"].items():
        jg = torch.as_tensor(ref["grads"][name])
        if name in zero:
            assert max(g.norm(), jg.norm()) < 1e-4, name
            continue
        err = _rel(g, jg)
        cos = float(torch.nn.functional.cosine_similarity(
            g.double().flatten(), jg.double().flatten(), dim=0))
        assert err <= (1e-3 if frozen else 3e-2) and cos >= 0.9995, \
            f"{name}: relative L2 {err:.2e}, cosine {cos:.6f}"
        within_1e3 += err <= 1e-3
    checked = len(port["grads"]) - len(zero)
    assert checked > 150 and within_1e3 >= (checked if frozen else 30)


def test_bn_statistics_match_jax(runs, shared):
    variant, port, ref = runs
    initial = state_dict_from_flax(normalize_config(_raw_cfg(variant)), shared[3])
    for name, v in port["stats1"].items():
        np.testing.assert_allclose(v.numpy(), ref["stats1"][name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        if variant == "freeze_bn_stats":  # frozen: the statistics stay as loaded
            torch.testing.assert_close(v, initial[name], rtol=0, atol=0)


def test_parameters_after_k_steps_match_jax(runs):
    _, port, ref = runs
    final = port["final"]
    for name in (n for n in final if not n.endswith(STATS + ("num_batches_tracked",))):
        np.testing.assert_allclose(final[name].numpy(), ref["final"][name],
                                   rtol=1e-4, atol=2 * K * LR, err_msg=name)
