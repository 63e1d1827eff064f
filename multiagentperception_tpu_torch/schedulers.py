"""Learning-rate schedules as ``step -> lr`` functions (port of
multiagentperception_tpu/schedulers.py; reference ptsemseg/schedulers/).

Each schedule gives the lr of update ``step`` (0-based), with the same
formulas as the optax schedules the JAX package builds, computed in Python
floats. The trainer writes ``schedule(step)`` into the optimizer's param
groups before update ``step``, so the lr applied at update ``t`` is
``schedule(t)``, as optax counts. All ten shipped configs leave
``lr_schedule`` empty: a constant lr.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

Schedule = Callable[[int], float]


def constant_lr(base_lr: float, **_) -> Schedule:
    return lambda step: base_lr


def poly_lr(base_lr: float, max_iter: int, gamma: float = 0.9, **_) -> Schedule:
    """Polynomial decay to 0 over ``max_iter`` updates (optax
    ``polynomial_schedule``; the reference's PolynomialLR never decays,
    see the JAX package's note)."""
    if max_iter <= 0:
        return constant_lr(base_lr)

    def schedule(step):
        frac = 1 - min(max(step, 0), max_iter) / max_iter
        return base_lr * frac ** gamma

    return schedule


def multi_step_lr(base_lr: float, milestones, gamma: float = 0.1, **_) -> Schedule:
    """``gamma`` once per milestone reached (``step >= milestone``)."""
    bounds = sorted({int(m) for m in milestones})
    return lambda step: base_lr * gamma ** sum(step >= m for m in bounds)


def cosine_annealing_lr(base_lr: float, T_max: int, eta_min: float = 0.0, **_) -> Schedule:
    alpha = eta_min / base_lr if base_lr else 0.0

    def schedule(step):
        cosine = 0.5 * (1 + math.cos(math.pi * min(step, T_max) / T_max))
        return base_lr * ((1 - alpha) * cosine + alpha)

    return schedule


def exp_lr(base_lr: float, gamma: float, **_) -> Schedule:
    if gamma == 0:
        return constant_lr(base_lr)
    return lambda step: base_lr if step <= 0 else base_lr * gamma ** step


KEY2SCHEDULER: dict[str, Callable[..., Schedule]] = {
    "constant_lr": constant_lr,
    "poly_lr": poly_lr,
    "multi_step": multi_step_lr,
    "cosine_annealing": cosine_annealing_lr,
    "exp_lr": exp_lr,
}


def _with_warmup(schedule: Schedule, warmup_iters: int = 100, mode: str = "linear",
                 gamma: float = 0.2) -> Schedule:
    """WarmUpLR (reference: schedulers/schedulers.py:28-53)."""
    if mode not in ("linear", "constant"):
        raise KeyError(f"WarmUp type {mode} not implemented")

    def warmed(step):
        cold = schedule(step)
        if step >= warmup_iters:
            return cold
        if mode == "constant":
            return gamma * cold
        alpha = step / float(warmup_iters)
        return (gamma * (1 - alpha) + alpha) * cold

    return warmed


def get_scheduler(scheduler_dict: Mapping[str, Any] | None, base_lr: float) -> Schedule:
    """Schedule registry (reference: schedulers/__init__.py:18-48)."""
    if not scheduler_dict:
        return constant_lr(base_lr)
    sd = dict(scheduler_dict)
    s_type = sd.pop("name")
    warmup = {}
    if "warmup_iters" in sd:
        warmup = dict(warmup_iters=sd.pop("warmup_iters", 100),
                      mode=sd.pop("warmup_mode", "linear"),
                      gamma=sd.pop("warmup_factor", 0.2))
    base = KEY2SCHEDULER[s_type](base_lr, **sd)
    return _with_warmup(base, **warmup) if warmup else base
