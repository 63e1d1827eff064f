"""The port's optimizers and lr schedules against the JAX package's (optax)
on the same gradients. Each optimizer runs K=5 updates on a small parameter
set, under a constant lr and under a warmed-up schedule, and every update's
parameters are held at rtol 1e-5 / atol 1e-7 (float32 elementwise updates
in another order). Schedules: the lr at steps 0, 1, warm-up-1, warm-up and
the last, rtol 1e-5 (the port computes in float64, optax in float32, whose
``0.97 ** 50`` is 1.4e-6 off)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multiagentperception_tpu.optimizers import get_optimizer as jax_get_optimizer
from multiagentperception_tpu.schedulers import get_scheduler as jax_get_scheduler
from multiagentperception_tpu_torch.optimizers import get_optimizer, set_lr
from multiagentperception_tpu_torch.schedulers import get_scheduler

K = 5
OPTIMIZERS = [
    {"name": "sgd", "lr": 0.1},
    {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-2},
    {"name": "adam", "lr": 1e-2},
    {"name": "adam", "lr": 1e-2, "weight_decay": 1e-2, "betas": [0.8, 0.99]},
    {"name": "asgd", "lr": 1e-2, "weight_decay": 1e-3, "lambd": 1e-2},
    {"name": "adamax", "lr": 1e-2},
    {"name": "adadelta", "lr": 1.0},
    {"name": "adagrad", "lr": 1e-1},
    {"name": "rmsprop", "lr": 1e-2},
    {"name": "rmsprop", "lr": 1e-2, "momentum": 0.9, "alpha": 0.9},
]
WARMED = {"name": "multi_step", "milestones": [2, 4], "gamma": 0.5, "warmup_iters": 3,
          "warmup_mode": "linear", "warmup_factor": 0.2}


def _id(spec) -> str:
    return "-".join(f"{v}" if k == "name" else f"{k}{v}" for k, v in spec.items())


@pytest.mark.parametrize("schedule_cfg", [None, WARMED], ids=["constant", "warmed_multistep"])
@pytest.mark.parametrize("opt_cfg", OPTIMIZERS, ids=_id)
def test_optimizer_matches_optax(opt_cfg, schedule_cfg):
    cfg = {"training": {"optimizer": dict(opt_cfg)}}
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(K)]

    j_schedule = jax_get_scheduler(schedule_cfg, opt_cfg["lr"])
    tx = jax_get_optimizer(cfg, learning_rate=j_schedule)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(j_params)

    schedule = get_scheduler(schedule_cfg, opt_cfg["lr"])
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = get_optimizer(cfg, list(t_params.values()), schedule(0))
    for t, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        set_lr(opt, schedule(t))
        opt.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} after update {t}")


def test_default_is_sgd_at_0_01():
    p = torch.nn.Parameter(torch.ones(2))
    opt = get_optimizer({"training": {}}, [p])
    assert isinstance(opt, torch.optim.SGD) and opt.param_groups[0]["lr"] == 0.01


def test_unknown_optimizer_is_refused():
    with pytest.raises(NotImplementedError, match="lbfgs"):
        get_optimizer({"training": {"optimizer": {"name": "lbfgs", "lr": 1}}},
                      [torch.nn.Parameter(torch.ones(1))])


SCHEDULES = [
    None,
    {"name": "constant_lr"},
    {"name": "poly_lr", "max_iter": 50, "gamma": 0.9},
    {"name": "multi_step", "milestones": [10, 30, 30], "gamma": 0.1},
    {"name": "cosine_annealing", "T_max": 50, "eta_min": 1e-5},
    {"name": "exp_lr", "gamma": 0.97},
]


CASES = [(s, w) for s in SCHEDULES for w in (None, "linear", "constant") if s or not w]


@pytest.mark.parametrize("spec,warmup", CASES,
                         ids=[f"{s['name'] if s else 'none'}-{w}" for s, w in CASES])
def test_schedule_matches_optax(spec, warmup):
    sd = dict(spec or {})
    wu = 10
    if warmup:
        sd.update(warmup_iters=wu, warmup_mode=warmup, warmup_factor=0.3)
    base = 1e-2
    ours, ref = get_scheduler(sd or None, base), jax_get_scheduler(sd or None, base)
    for step in (0, 1, wu - 1, wu, 50):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, atol=0,
                                   err_msg=f"step {step}")
