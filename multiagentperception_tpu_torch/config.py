"""Config system: loads the reference's YAML schema unchanged.

The port's own copy of ``multiagentperception_tpu/config.py`` (the port
imports nothing of the JAX package); keep the two in step.

The reference reads raw nested dicts with ``yaml.load`` (reference:
train.py:67-68) and every downstream component indexes into ``cfg["model"]``,
``cfg["data"]``, ``cfg["training"]``. We keep that exact schema (all ten
shipped YAMLs under configs/ parse verbatim) but normalize the handful of
quirks: the string ``'None'`` used as a null sentinel, missing optional keys,
and unversioned defaults.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import yaml

# Keys whose YAML value 'None' (string) means Python None in the reference
# configs (e.g. noisy_type: None parses as the *string* 'None' only when
# quoted; unquoted None parses as null — both appear in the shipped YAMLs).
_MODEL_DEFAULTS: dict[str, Any] = {
    "arch": None,
    "agent_num": 5,
    "shared_policy": True,
    "shared_img_encoder": "unified",
    "attention": "general",
    "sparse": False,
    "query": True,
    "query_size": 32,
    "key_size": 1024,
    "enc_backbone": "resnet_encoder",
    "dec_backbone": "simple_decoder",
    "feat_squeezer": -1,
    "feat_channel": 512,
    "multiple_output": False,
    "shuffle_features": None,
}

_DATA_DEFAULTS: dict[str, Any] = {
    "dataset": "airsim",
    "train_split": "train",
    "val_split": "val",
    "test_split": "test",
    "img_rows": 512,
    "img_cols": 512,
    "path": None,
    "noisy_type": None,
    "target_view": "target",
    "commun_label": "None",
}

_TRAINING_DEFAULTS: dict[str, Any] = {
    "train_iters": 200000,
    "batch_size": 2,
    "val_interval": 1000,
    "n_workers": 4,
    "print_interval": 50,
    "optimizer": {"name": "adam", "lr": 1.0e-5},
    "loss": {"name": "cross_entropy", "size_average": True},
    "lr_schedule": None,
    "resume": None,
    "seed": 1337,
    # framework extension: write/overwrite a 'latest' checkpoint (+ data
    # stream position) every K iters for preemption-safe resume; None = off
    "save_interval": None,
    # framework extension (fine-tuning): freeze BN running stats during
    # training (torch model.eval()-during-fine-tune idiom; ~12% faster step)
    "freeze_bn_stats": False,
}


# Extension keys accepted beyond the defaults above (all opt-in, README
# table). A key in neither set is probably a typo — the raw-dict schema
# would otherwise silently no-op it (e.g. 'freez_bn_stats').
_EXTENSION_KEYS: dict[str, set] = {
    "model": {"dtype", "remat", "pallas_comm", "topk_k",
              "eval_inference", "agent_parallel", "agent_parallel_train"},
    "data": {"on_device_normalize", "cache_decoded"},
    # 'augmentations' is a REFERENCE schema key read from training
    # (reference train.py:137; ours train.py:91), not an extension — but it
    # has no default, so it must be whitelisted here
    "training": {"mixed_precision", "nan_guard", "profile_dir",
                 "profile_range", "data_backend", "augmentations",
                 "shard_data_by_process", "calib_batches",
                 "device_prefetch", "grain_workers", "watchdog_secs",
                 "rss_limit_gb", "steps_per_call"},
}


def _warn_unknown_keys(section: str, user: Mapping[str, Any] | None,
                       defaults: Mapping[str, Any]) -> None:
    import logging

    known = set(defaults) | _EXTENSION_KEYS.get(section, set())
    for k in (user or {}):
        if k not in known:
            logging.getLogger("multiagentperception_tpu_torch").warning(
                "config: unknown key %s.%s (typo? known extension keys: %s)",
                section, k, ", ".join(sorted(_EXTENSION_KEYS[section])),
            )


def _norm_none(value: Any) -> Any:
    """The reference YAMLs use the string 'None' as a null sentinel."""
    if isinstance(value, str) and value == "None":
        return None
    return value


def _merged(defaults: Mapping[str, Any], user: Mapping[str, Any] | None) -> dict:
    out = copy.deepcopy(dict(defaults))
    for k, v in (user or {}).items():
        out[k] = v
    return out


def normalize_config(cfg: Mapping[str, Any]) -> dict:
    """Fill schema defaults; keep the reference's raw-dict access pattern."""
    out: dict[str, Any] = {}
    _warn_unknown_keys("model", cfg.get("model"), _MODEL_DEFAULTS)
    _warn_unknown_keys("data", cfg.get("data"), _DATA_DEFAULTS)
    _warn_unknown_keys("training", cfg.get("training"), _TRAINING_DEFAULTS)
    out["model"] = _merged(_MODEL_DEFAULTS, cfg.get("model"))
    out["data"] = _merged(_DATA_DEFAULTS, cfg.get("data"))
    out["training"] = _merged(_TRAINING_DEFAULTS, cfg.get("training"))

    # 'None'-string normalization on the keys the reference treats as flags.
    out["model"]["shuffle_features"] = _norm_none(out["model"]["shuffle_features"])
    out["data"]["noisy_type"] = _norm_none(out["data"]["noisy_type"])
    out["training"]["resume"] = _norm_none(out["training"]["resume"])
    # commun_label deliberately stays a string: the reference compares it to
    # the literal 'None' (trainer.py:50-53) and also truthy-tests it.
    if out["data"]["commun_label"] is None:
        out["data"]["commun_label"] = "None"
    return out


def load_config(path: str) -> dict:
    """Load a YAML config file (accepts the reference's ten configs verbatim)."""
    with open(path) as fp:
        raw = yaml.safe_load(fp)
    if raw is None:
        raise ValueError(f"empty config: {path}")
    return normalize_config(raw)
