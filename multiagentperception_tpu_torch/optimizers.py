"""Optimizer registry (port of multiagentperception_tpu/optimizers.py;
reference ptsemseg/optimizers/__init__.py).

Same names and config surface (``training.optimizer.{name, lr, ...}``),
with the update rules of the optax transforms the JAX package builds. Where
``torch.optim`` computes the same update it is used as it is: ``sgd``,
``adam`` (``AdamW`` when ``weight_decay`` is set: optax ``adamw`` decays the
weights decoupled, ``-lr * (adam step + wd * p)``), ``adamax`` and
``adadelta``. Three differ from their ``torch.optim`` namesakes and are
written out here:

- ``adagrad``: optax starts the accumulator at 0.1 and divides by
  ``sqrt(acc + eps)``; torch starts at 0 and divides by ``sqrt(acc) + eps``.
- ``rmsprop``: optax puts eps inside the square root, and its momentum
  accumulates the lr-scaled step.
- ``asgd``: the JAX package's ASGD (torch's rule) takes the step size of
  update ``t`` from the lr of update ``t``; torch's from the lr of ``t-1``.

Every optimizer reads its lr from ``param_groups[i]['lr']``; the trainer
writes the schedule's value there before each update (``set_lr``).

Under a CUDA graph (``training.steps_per_call`` on the card) nothing may
be read back to the host or baked in as a Python number: ``make_capturable``
puts one lr tensor in every group (the captured step fills it on the
device), runs the ``torch.optim`` rules with ``capturable=True`` (their step
counts on the device) and keeps ASGD's count on the device; ``SGD`` steps
a device lr without reading it back. A tensor lr gives the updates of the
same float lr (``lr_tensor``: float64 on the CPU, where the rules read it as
a number).
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

import torch


class SGD(torch.optim.SGD):
    """``torch.optim.SGD``, which reads a tensor lr back to the host
    (``alpha=-lr``); with an lr tensor on the card this step multiplies by
    it on the device instead. Its momentum buffer must exist (one eager
    update made it) before a capture."""

    @torch.no_grad()
    def step(self, closure=None):
        if not any(isinstance(g["lr"], torch.Tensor) and g["lr"].device.type != "cpu"
                   for g in self.param_groups):
            return super().step(closure)
        for group in self.param_groups:
            lr, momentum, wd = group["lr"], group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not wd else p.grad.add(p, alpha=wd)
                if momentum:
                    st = self.state[p]
                    buf = st.get("momentum_buffer")
                    if buf is None:
                        buf = st["momentum_buffer"] = g.detach().clone()
                    else:
                        buf.mul_(momentum).add_(g, alpha=1 - group["dampening"])
                    g = g.add(buf, alpha=momentum) if group["nesterov"] else buf
                p.addcmul_(g, lr, value=-1)
        return None


def _sgd(params, lr, momentum=0.0, weight_decay=0.0, nesterov=False, **_):
    return SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay,
               nesterov=bool(nesterov and momentum))


def _adam(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **_):
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)


def _adamax(params, lr, betas=(0.9, 0.999), eps=1e-8, **_):
    # optax: nu = max(|g| + eps, b2 * nu), step mu_hat / nu: torch's Adamax
    return torch.optim.Adamax(params, lr=lr, betas=tuple(betas), eps=eps)


def _adadelta(params, lr, rho=0.9, eps=1e-6, **_):
    return torch.optim.Adadelta(params, lr=lr, rho=rho, eps=eps)


class Adagrad(torch.optim.Optimizer):
    """optax ``adagrad``: ``acc += g^2`` from 0.1, ``p -= lr * g / sqrt(acc + eps)``."""

    def __init__(self, params, lr, eps=1e-10, **_):
        super().__init__(params, dict(lr=lr, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["sum"] = torch.full_like(p, 0.1)
                acc = st["sum"].addcmul_(p.grad, p.grad)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.sub_(group["lr"] * (scale * p.grad))


class RMSprop(torch.optim.Optimizer):
    """optax ``rmsprop``: ``nu = a * nu + (1 - a) * g^2`` from 0,
    ``u = -lr * g / sqrt(nu + eps)``; with momentum ``m``, ``t = u + m * t``
    and the step is ``t``."""

    def __init__(self, params, lr, alpha=0.99, eps=1e-8, momentum=0.0, **_):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            a = group["alpha"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    if group["momentum"]:
                        st["trace"] = torch.zeros_like(p)
                nu = st["nu"].mul_(a).addcmul_(p.grad, p.grad, value=1 - a)
                upd = -group["lr"] * (p.grad * torch.rsqrt(nu + group["eps"]))
                if group["momentum"]:
                    upd = st["trace"].mul_(group["momentum"]).add_(upd)
                p.add_(upd)


class ASGD(torch.optim.Optimizer):
    """The JAX package's ASGD (torch.optim.ASGD's rule). At update ``t``
    (0-based) with lr ``lr_t``: ``eta = lr_t / (1 + lambd * lr_t * t)^alpha``
    and ``p <- p - lambd * eta * p - eta * (g + wd * p)``. The Polyak average
    both keep beside ``p`` is read by nothing (the model is ``p``), so it is
    not kept here."""

    def __init__(self, params, lr, lambd=1e-4, alpha=0.75, weight_decay=0.0, **_):
        super().__init__(params, dict(lr=lr, lambd=lambd, alpha=alpha,
                                      weight_decay=weight_decay, step=0))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            t, lr, lambd = group["step"], group["lr"], group["lambd"]
            eta = lr / (1.0 + lambd * lr * t) ** group["alpha"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                p.sub_(lambd * eta * p + eta * g)
            if isinstance(t, torch.Tensor):  # the count on the device (make_capturable)
                t.add_(1)
            else:
                group["step"] = t + 1


KEY2OPT: dict[str, Callable[..., torch.optim.Optimizer]] = {
    "sgd": _sgd,
    "adam": _adam,
    "asgd": ASGD,
    "adamax": _adamax,
    "adadelta": _adadelta,
    "adagrad": Adagrad,
    "rmsprop": RMSprop,
}


def get_optimizer(cfg: Mapping, params: Iterable[torch.nn.Parameter],
                  learning_rate: float | None = None) -> torch.optim.Optimizer:
    """Build the optimizer of ``cfg['training']['optimizer']`` over
    ``params``; without that block, SGD at lr 0.01 (as the JAX package).
    ``learning_rate`` overrides the config's lr (the schedule's first value)."""
    opt_cfg = cfg["training"].get("optimizer")
    if opt_cfg is None:
        return SGD(params, lr=learning_rate if learning_rate is not None else 0.01)
    name = opt_cfg["name"]
    if name not in KEY2OPT:
        raise NotImplementedError(f"Optimizer {name} not implemented")
    kw = {k: v for k, v in opt_cfg.items() if k not in ("name", "lr")}
    lr = learning_rate if learning_rate is not None else opt_cfg["lr"]
    return KEY2OPT[name](params, lr, **kw)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The lr of the next update, in every param group: a Python float, or,
    where the group holds an lr tensor (``make_capturable``), filled into
    it on its device (no host sync)."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def lr_tensor(lr: float, device: torch.device) -> torch.Tensor:
    """A 0-dim lr tensor on ``device``: float32 on the card, as the
    capturable rules compute with their step counts, and float64 on the
    CPU, where the rules read it as the number ``lr`` itself."""
    dtype = torch.float64 if torch.device(device).type == "cpu" else torch.float32
    return torch.full((), float(lr), dtype=dtype, device=device)


def make_capturable(optimizer: torch.optim.Optimizer, lr: torch.Tensor) -> None:
    """Ready ``optimizer`` for a CUDA graph of its step (module docstring):
    every group reads ``lr``; ``torch.optim`` rules step with
    ``capturable=True``, their step counts on the parameters' device; ASGD
    counts on ``lr``'s device. Call it after one eager update made the
    optimizer's state."""
    for group in optimizer.param_groups:
        group["lr"] = lr
        if "capturable" in group:
            group["capturable"] = True
        if isinstance(optimizer, ASGD) and not isinstance(group["step"], torch.Tensor):
            group["step"] = torch.full((), float(group["step"]), dtype=lr.dtype,
                                       device=lr.device)
    for p, st in optimizer.state.items():
        if isinstance(st.get("step"), torch.Tensor):
            st["step"] = st["step"].to(p.device)


def make_eager(optimizer: torch.optim.Optimizer) -> None:
    """Undo ``make_capturable`` (a checkpoint of a graph run loaded into any
    run): float lrs, ``capturable=False`` with the step counts on the host,
    ASGD's count an int."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
        if group.get("capturable"):
            group["capturable"] = False
        if isinstance(optimizer, ASGD) and isinstance(group["step"], torch.Tensor):
            group["step"] = int(group["step"])
    for st in optimizer.state.values():
        if isinstance(st.get("step"), torch.Tensor):
            st["step"] = st["step"].detach().to("cpu", torch.float32)


def optimizer_tensors(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """Every tensor an update writes: the parameters, their state, and
    ASGD's count (what ``nan_guard`` puts back after a rejected update)."""
    out = []
    for group in optimizer.param_groups:
        out += [p for p in group["params"]]
        if isinstance(group.get("step"), torch.Tensor):
            out.append(group["step"])
    for st in optimizer.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out
