"""Model registry (port of multiagentperception_tpu/models/__init__.py:28-129).

All seven reference architectures with the ``resnet_encoder`` /
``simple_decoder`` backbones: every model the ten reference YAMLs reach,
in float32 or, with ``model.dtype: bfloat16`` or the
``training.mixed_precision`` shorthand, computing in bf16 with float32
parameters and BatchNorm statistics (``compute_dtype``). What the port does
not carry yet raises ``NotImplementedError`` naming the key and
ROADMAP.md, never a silent substitute: ``feat_squeezer``, other backbones,
``sparse: true`` on the SRMS attentions, ``model.dtype: float16``,
``agent_parallel*``, and ``topk`` (``topk_k``, ``eval_inference: topk``).
MIMOcom keeps the flagship's shape (``query: true``, ``multiple_output:
true``).
``model.pallas_comm`` is accepted and has no effect: MIMOcom's pruned eval
modes always run the fused comm step (models/agents.py). ``model.remat``
checkpoints MIMOcom's two towers in its training forward (JAX
models/__init__.py:111); the other architectures ignore it with a warning.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Mapping

import torch
from torch import nn

from multiagentperception_tpu_torch.models.agents import (
    AllAgents,
    LearnWhen2Com,
    LearnWho2Com,
    MIMOAllAgents,
    MIMOcom,
    MIMOcomWho,
    SingleAgent,
)

MODELS = {
    "Single_agent": SingleAgent,
    "All_agents": AllAgents,
    "MIMO_All_agents": MIMOAllAgents,
    "LearnWho2Com": LearnWho2Com,
    "LearnWhen2Com": LearnWhen2Com,
    "MIMOcom": MIMOcom,
    "MIMOcomWho": MIMOcomWho,
}
_LATER = "not ported yet; see ROADMAP.md queue A"


def _refuse(key: str, value) -> None:
    raise NotImplementedError(f"model.{key}={value!r}: {_LATER}")


def compute_dtype(cfg: Mapping[str, Any]) -> torch.dtype | None:
    """The models' compute dtype (JAX models/__init__.py:57-66):
    ``model.dtype``, else ``bfloat16`` when ``training.mixed_precision`` is
    set; ``None`` for float32."""
    name = cfg["model"].get("dtype")
    if name is None and cfg.get("training", {}).get("mixed_precision"):
        name = "bfloat16"
    if name in (None, "None", "float32"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float16":
        _refuse("dtype", name)
    raise KeyError(f"model.dtype={name!r}: bfloat16, float32 or None")


def get_model(cfg: Mapping[str, Any], n_classes: int) -> nn.Module:
    """Build the model of a reference-schema config dict."""
    m = cfg["model"]
    name = m["arch"]
    if name not in MODELS:
        raise KeyError(f"Model {name} not available")
    if name != "MIMOcom":
        # MIMOcom-only extension keys on another arch are ignored, loudly (JAX :41-53)
        for k in ("pallas_comm", "topk_k", "remat", "agent_parallel", "agent_parallel_train"):
            if m.get(k):
                logging.getLogger("multiagentperception_tpu_torch").warning(
                    "config: model.%s is a MIMOcom extension and is ignored for arch %s",
                    k, name)
    for key, value in (("enc_backbone", "resnet_encoder"), ("dec_backbone", "simple_decoder")):
        if m.get(key) != value:
            _refuse(key, m.get(key))
    if (m.get("feat_squeezer") or -1) != -1:
        _refuse("feat_squeezer", m["feat_squeezer"])
    for key in ("agent_parallel", "agent_parallel_train"):
        if m.get(key):
            _refuse(key, m[key])
    if m.get("eval_inference") == "topk":
        _refuse("eval_inference", "topk")

    common = dict(n_classes=n_classes, feat_channel=m.get("feat_channel", 512),
                  dtype=compute_dtype(cfg))
    if name == "Single_agent":
        return SingleAgent(**common)
    if name in ("All_agents", "MIMO_All_agents"):
        return MODELS[name](shuffle_flag=m.get("shuffle_features"),
                            agent_num=m["agent_num"], **common)
    img_size = (cfg["data"]["img_rows"], cfg["data"]["img_cols"])
    comm = dict(agent_num=m["agent_num"], key_size=m["key_size"],
                query_size=m["query_size"], img_size=img_size, **common)
    if name in ("MIMOcom", "MIMOcomWho") and m.get("shared_img_encoder") != "unified":
        raise ValueError("Incorrect shared_img_encoder flag")  # as the JAX models
    if name == "MIMOcom":
        for key in ("query", "multiple_output"):
            if not m.get(key):
                _refuse(key, m.get(key))
        if m.get("topk_k") is not None:
            _refuse("topk_k", m["topk_k"])
        return MIMOcom(remat=bool(m.get("remat")), **comm)
    if name == "MIMOcomWho":
        return MIMOcomWho(has_query=bool(m["query"]),
                          mo_flag=bool(m.get("multiple_output")), **comm)
    if m.get("sparse"):
        _refuse("sparse", m["sparse"])  # sparsemax: ROADMAP A.6
    return MODELS[name](attention=m["attention"], has_query=bool(m["query"]),
                        shared_img_encoder=m["shared_img_encoder"], **comm)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init in the JAX package's distributions: he-normal convs,
    xavier-normal linears, zero biases, fresh BatchNorm. Drawn on the CPU
    from one ``torch.Generator``, so every device gets the same weights."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            if isinstance(mod, nn.Conv2d):
                std = math.sqrt(2.0 / fan_in)
            else:
                std = math.sqrt(2.0 / (fan_in + w.shape[0]))
            w.copy_(torch.randn(w.shape, generator=gen) * std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model


__all__ = ["MODELS", "compute_dtype", "get_model", "init_weights",
           *(cls.__name__ for cls in MODELS.values())]
