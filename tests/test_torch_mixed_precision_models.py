"""The port's bf16 models against the JAX package's bf16 models on shared
weights (``convert.state_dict_from_flax``): the flagship MIMOcom in every
inference mode against JAX with ``model.pallas_comm`` (its K2 in
interpret mode, as the port's pruned modes run K2's plain version), and
one mixed-precision train step of the flagship. The six other
architectures are in tests/test_torch_mixed_precision_zoo.py, with the
helpers and the rule of this file.

64x64 inputs (the policy map is 1x1), B=2, N=3, query_size 8, key_size 64;
weights from the JAX init with seeded BatchNorm statistics and the
attention scaled up (tests/test_torch_zoo.py's helpers), one set per seed.
At 64x64 that scale leaves the flagship's graph nearly uniform (every
``soft`` within 0.28-0.43: ``activated`` keeps every link and the argmaxes
are decided by less than 1e-2), so its projection ``W`` is scaled by a
further ``PEAK``: graphs with kept and pruned links and clear argmaxes.

The bf16 rule: bf16 and float32 round differently in each framework (the
CPU's bf16 convolutions, BatchNorm and resize in torch and in XLA), so
the two bf16 predictions are not held to each other elementwise. Instead,
over the seeds, the port's bf16 prediction lies no further from the
port's float32 prediction than twice the distance of JAX's bf16
prediction from JAX's float32 one (relative L2, summed over the seeds;
the float32 predictions of the two agree within 1e-3, tests/test_torch_zoo*.py).

Actions and bandwidth (the flagship) equal JAX's bf16 ones, but for
links that rounding may flip: a link whose ``soft`` (either side's) lies
within 1e-2 of the 0.2 threshold, or a column's top two links when they
lie within 1e-2 of each other, is excused; the test prints how many links
it excused and fails if more than 10% were.

The train step (module ``Trainer`` on the CPU against the JAX model's
training forward, eagerly: JAX's jitted bf16 train step takes minutes to
compile on the CPU): the loss within 1e-2 relative, the BatchNorm running
statistics within rtol/atol 1e-2, every parameter float32 and finite
after the Adam step.
"""

from __future__ import annotations

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
from multiagentperception_tpu_torch.trainer import Trainer
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import (
    jax_forward,
    jax_rand_ids,
    model_inputs,
    port_forward,
    port_model,
    raw_cfg,
    shared_variables,
)

B, N, IMG = 2, 3, 64
SEEDS = (0, 1, 2, 3)
RATIO = 2.0  # the port's bf16 distance from float32 over JAX's, at most
NEAR = 1e-2  # a link this close to the threshold or to its column's runner-up is excused
MAX_EXCUSED = 0.10
THRES = 0.2
PEAK = 10.0  # the flagship's projection, on top of the helpers' scale
FLAGSHIP_MODES = ("softmax", "argmax_test", "activated")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pred(out) -> np.ndarray:
    """A port prediction (NCHW) as the JAX layout (NHWC), float32."""
    return out[0].float().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def shared_seeds():
    """Per (arch, keys) and seed: the float32 config, inputs and
    JAX-initialized weights, on first use, and the config in ``dtype``
    (bfloat16, or float16: tests/test_torch_float16_models.py)."""
    cache = {}

    def get(arch, keys, seed, dtype="bfloat16"):
        key = (arch, tuple(sorted(keys.items())), seed)
        if key not in cache:
            cfg = raw_cfg(arch, N, (IMG, IMG), **keys)
            x = model_inputs(cfg, (B, N, IMG, IMG, 3), seed=seed)
            variables = shared_variables(cfg, x, seed=seed)
            if arch == "MIMOcom":
                proj = variables["params"]["MIMOGeneralDotAttention_0"]["proj"]
                proj["kernel"] = proj["kernel"] * PEAK
            cache[key] = (cfg, x, variables)
        cfg, x, variables = cache[key]
        cfg16 = raw_cfg(arch, N, (IMG, IMG), dtype=dtype, pallas_comm=True, **keys)
        return cfg, cfg16, x, variables

    return get


def _four_way(cfg, cfg16, x, variables, mode):
    """JAX float32, JAX bf16, port float32 and port bf16 outputs of one
    input; the port takes the partners JAX drew."""
    out = {"jax32": jax_forward(cfg, variables, x, mode),
           "jax16": jax_forward(cfg16, variables, x, mode)}
    ids = jax_rand_ids(cfg, out["jax32"])
    for name, c in (("port32", cfg), ("port16", cfg16)):
        out[name] = port_forward(c, port_model(c, variables), x, mode, rand_ids=ids)
    if not isinstance(out["jax32"], tuple):
        out["jax32"], out["jax16"] = (out["jax32"],), (out["jax16"],)
    return out


def _assert_ratio(errs: dict, label: str) -> None:
    port, ref = sum(errs["port"]), sum(errs["jax"])
    print(f"{label}: relative L2 from float32, port {errs['port']}, JAX {errs['jax']}")
    assert port <= RATIO * ref, f"{label}: port {port:.3e} > {RATIO} x JAX {ref:.3e}"


def _excused(soft_a: np.ndarray, soft_b: np.ndarray) -> np.ndarray:
    """(B, K, Q) links that rounding may flip, by either side's graph."""
    out = np.zeros(soft_a.shape, bool)
    for soft in (soft_a, soft_b):
        out |= np.abs(soft - THRES) < NEAR
        top2 = np.sort(soft, axis=1)[:, -2:, :]  # (B, 2, Q): runner-up, top
        tied = (top2[:, 1] - top2[:, 0]) < NEAR  # (B, Q)
        out |= tied[:, None, :] & (soft >= top2[:, :1, :])
    return out


def flagship_against_jax(shared_seeds, mode: str, dtype: str = "bfloat16",
                         seeds=SEEDS) -> None:
    """The flagship in ``dtype`` against JAX's under the rule of the module
    docstring, over ``seeds``: predictions, actions and bandwidth."""
    errs, excused, links = {"port": [], "jax": []}, 0, 0
    for seed in seeds:
        cfg, cfg16, x, variables = shared_seeds("MIMOcom", {}, seed, dtype)
        out = _four_way(cfg, cfg16, x, variables, mode)
        jp, jprob, jact, jnc = out["jax16"]
        tp, tprob, tact, tnc = out["port16"]
        assert tp.dtype == getattr(torch, dtype) and jp.dtype == getattr(jnp, dtype)
        assert bool(torch.isfinite(tp).all()) and bool(jnp.isfinite(jp).all())
        assert tprob.dtype == torch.float32 and jprob.dtype == jnp.float32
        errs["port"].append(_rel(_pred(out["port16"]), _pred(out["port32"])))
        errs["jax"].append(_rel(np.asarray(jp, np.float32), out["jax32"][0]))

        soft_t, soft_j = tprob.numpy(), np.asarray(jprob)
        exc = _excused(soft_t, soft_j)
        excused, links = excused + int(exc.sum()), links + exc.size
        col_ok = ~exc.any(axis=1)  # (B, Q): columns without an excused link
        np.testing.assert_array_equal(tact.numpy()[col_ok], np.asarray(jact)[col_ok])
        if mode == "activated":
            np.testing.assert_array_equal((soft_t > THRES)[~exc], (soft_j > THRES)[~exc])
        offdiag = exc & ~np.eye(N, dtype=bool)
        # bandwidth: off-diagonal links / (N * B); only excused links may move it
        assert abs(float(tnc) - float(jnc)) * N * B <= \
            (int(offdiag.sum()) if mode != "softmax" else 0) + 1e-4
    print(f"MIMOcom {dtype} {mode}: excused {excused} of {links} links")
    assert excused <= MAX_EXCUSED * links
    _assert_ratio(errs, f"MIMOcom {dtype} {mode}")


@pytest.mark.parametrize("mode", FLAGSHIP_MODES)
def test_flagship_bf16_matches_jax(shared_seeds, mode):
    flagship_against_jax(shared_seeds, mode)


def test_flagship_bf16_keeps_links(shared_seeds):
    """The seeds' graphs are peaked: in bf16, ``activated`` keeps some
    off-diagonal links and prunes others, so the comparison above fuses
    real links and prunes real ones."""
    kept = 0
    for seed in SEEDS:
        cfg, cfg16, x, variables = shared_seeds("MIMOcom", {}, seed)
        _, prob, _, nc = port_forward(cfg16, port_model(cfg16, variables), x, "activated")
        kept += int((prob > THRES).sum())
        assert float(nc) > 0
    assert 0 < kept < len(SEEDS) * B * N * N


# ----------------------------------------------------------------- training

LR = 1e-4


def _train_cfg(dtype: str = "bfloat16") -> dict:
    """bfloat16 by the ``training.mixed_precision`` shorthand, float16 by
    ``model.dtype``."""
    cfg = raw_cfg("MIMOcom", N, (IMG, IMG))
    cfg["data"]["commun_label"] = "mimo"
    cfg["training"] = {"batch_size": B, "optimizer": {"name": "adam", "lr": LR},
                       "loss": {"name": "cross_entropy", "size_average": True}}
    if dtype == "bfloat16":
        cfg["training"]["mixed_precision"] = True
    else:
        cfg["model"]["dtype"] = dtype
    return cfg


def train_step_against_jax(shared_seeds, dtype: str = "bfloat16",
                           moved_at_least: int = 101) -> dict:
    """One ``Trainer`` step in ``dtype`` against JAX's training forward
    (module docstring's tolerances), at least ``moved_at_least`` parameter
    tensors moved by the step. Returns the step's inputs (``raw`` config,
    ``variables``, ``images``, ``labels``), the port's gradients and the
    names of the parameters that moved."""
    raw = _train_cfg(dtype)
    _, _, _, variables = shared_seeds("MIMOcom", {}, SEEDS[0])
    rng = np.random.default_rng(11)
    images = (rng.standard_normal((B, N, IMG, IMG, 3)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 11, (B, N, IMG, IMG)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 250

    jcfg = jax_normalize_config(raw)
    (out, new_state) = jax_get_model(jcfg, 11).apply(
        variables, jnp.asarray(images), train=True, mo_flag=True, inference="softmax",
        mutable=["batch_stats"])
    assert out[0].dtype == getattr(jnp, dtype)
    y = labels.reshape((-1, IMG, IMG)).astype(np.uint8)
    j_loss = float(jax_get_loss(jcfg)(input=out[0], target=jnp.asarray(y)))
    j_stats = state_dict_from_flax(jcfg, jax.tree_util.tree_map(np.asarray, {
        "params": variables["params"], "batch_stats": new_state["batch_stats"]}))

    cfg = normalize_config(raw)
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device="cpu")
    trainer.model.load_state_dict(state_dict_from_flax(cfg, variables), strict=True)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    loss = trainer.train_step(*trainer._batch(images, labels))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-2)

    after = trainer.model.state_dict()
    moved = []
    for name, v in after.items():
        if not v.is_floating_point():
            continue
        assert v.dtype == torch.float32 and bool(torch.isfinite(v).all()), name
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), j_stats[name], rtol=1e-2, atol=1e-2,
                                       err_msg=name)
        elif not torch.equal(v, before[name]):
            moved.append(name)
    assert len(moved) >= moved_at_least
    return {"raw": raw, "variables": variables, "images": images, "labels": labels,
            "moved": moved, "grads": {n: p.grad for n, p in trainer.model.named_parameters()}}


def test_mixed_precision_train_step_matches_jax(shared_seeds):
    train_step_against_jax(shared_seeds)
