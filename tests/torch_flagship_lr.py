"""The flagship YAML at its stock lr 1e-5 through either package's train
CLI, from chosen initial weights: the parts of
tests/test_torch_flagship_lr.py that a card run of the port uses too.

The config is ``run_flagship_512.derive_config``'s (the stock YAML with
the JAX script's extension keys, held equal to the JAX script's by
tests/test_torch_flagship_run.py) with ``training.seed`` set; a variant is
an edit of that dict before it is written (``training.mixed_precision:
false`` for float32, say). ``jax_start_state`` and ``write_start`` carry
the JAX train CLI's initial weights to a ``.pkl`` the port's CLI resumes at
iteration 0; ``summary`` reads either CLI's log. This module imports no JAX
but in ``jax_start_state``.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multiagentperception_tpu_torch import run_flagship_512 as flagship  # noqa: E402

LOSS_RE = r"Iter \[(\d+)/\d+\]\s+Loss: ([0-9.eE+-]+|nan)"


def derived(img: int, iters: int, val_interval: int, root: str, workdir: str,
            seed: int = 1337, start: str | None = None) -> dict:
    """``run_flagship_512.derive_config`` for these flags, with
    ``training.seed`` and ``start`` as ``training.resume``."""
    args = flagship.parse_args(["--img", str(img), "--iters", str(iters),
                                "--val_interval", str(val_interval), "--root", root,
                                "--workdir", workdir])
    args.resume = start
    cfg = flagship.derive_config(args)
    cfg["training"]["seed"] = seed
    return cfg


def jax_start_state(cfg: dict, seed: int = 1337) -> dict:
    """The JAX train CLI's initial weights for ``cfg`` at ``seed`` (its
    ``Trainer._init_state`` on an example batch of raw frames, as
    ``train.py`` builds it) as the port's state_dict
    (``convert.state_dict_from_flax``)."""
    import logging

    import optax

    from multiagentperception_tpu.models import get_model as jax_get_model
    from multiagentperception_tpu.trainer import get_trainer
    from multiagentperception_tpu_torch.convert import state_dict_from_flax

    model = jax_get_model(cfg, n_classes=11, agent_mesh=None)
    trainer = get_trainer(cfg)(cfg, None, logging.getLogger("jax_start"), model, None, None,
                               None, optax.adam(cfg["training"]["optimizer"]["lr"]),
                               seed=seed)
    d, m = cfg["data"], cfg["model"]
    example = np.zeros((cfg["training"]["batch_size"], m["agent_num"], d["img_rows"],
                        d["img_cols"], 3), np.uint8)
    state = trainer._init_state(example)
    return state_dict_from_flax(cfg, {"params": state.params,
                                      "batch_stats": state.batch_stats})


def write_start(cfg: dict, state_dict: dict, path: str) -> str:
    """A ``.pkl`` the train CLI resumes at iteration 0 (``training.resume``):
    ``state_dict`` and a fresh optimizer's state, as ``Trainer`` saves."""
    from multiagentperception_tpu_torch.models import get_model
    from multiagentperception_tpu_torch.optimizers import get_optimizer

    model = get_model(cfg, 11)
    model.load_state_dict(state_dict, strict=True)
    optimizer = get_optimizer(cfg, model.parameters())
    torch.save({"epoch": 0, "model_state": model.state_dict(),
                "optimizer_state": optimizer.state_dict(), "best_iou": 0.0}, path)
    return path


def summary(text: str) -> dict:
    """The train loss at each printed iteration and ``run_flagship_512.report``'s
    validations and test eval, from a train CLI's log (either package's)."""
    r = flagship.report(text)
    loss = [(int(i), float(v)) for i, v in re.findall(LOSS_RE, text)]
    return {"loss": loss, "val_when2com": r["val_when2com"],
            "val_normal": r["val_normal"], "val_noise": r["val_noise"],
            "val_overall": r["val_overall"], "test": r["test"]}
