"""Model registry (port of multiagentperception_tpu/models/__init__.py:28-129).

Every model the JAX package's ``get_model`` builds: the seven reference
architectures over the ``resnet_encoder`` / ``n_segnet_encoder`` encoders
and the ``simple_decoder`` / ``FCN_decoder`` / ``n_segnet_decoder``
decoders, with ``feat_squeezer``, ``sparse`` (sparsemax on the SRMS
attentions), MIMOcom's ``query: false`` / ``multiple_output: false`` and its
``topk`` eval (``topk_k``), in float32 or, with ``model.dtype: bfloat16``
or the ``training.mixed_precision`` shorthand, computing in bf16 with
float32 parameters and BatchNorm statistics (``compute_dtype``). What the
port does not carry yet raises ``NotImplementedError`` naming the key and
ROADMAP.md, never a silent substitute: ``model.dtype: float16``.
With a ``parallel.Layout`` whose rings hold more than one rank
(``model.agent_parallel``), MIMOcom's full-graph eval modes run the
communication step as a ring over its agent group (``parallel.ring``), and
with ``model.agent_parallel_train`` its training forward too, its
BatchNorms then taking their statistics over the ring
(``parallel.sync_bn``); ``get_model`` raises where the JAX one does
(models/__init__.py:102-127).
``model.pallas_comm`` is accepted and has no effect: MIMOcom's pruned eval
modes always run the fused comm step where it applies (models/agents.py).
``model.remat`` checkpoints MIMOcom's two towers in its training forward
(JAX models/__init__.py:111); the other architectures ignore it with a
warning.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Mapping

import torch
from torch import nn

from multiagentperception_tpu_torch.models.agents import (
    AllAgents,
    Backbones,
    LearnWhen2Com,
    LearnWho2Com,
    MIMOAllAgents,
    MIMOcom,
    MIMOcomWho,
    SingleAgent,
)
from multiagentperception_tpu_torch.parallel import sync_bn

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


def get_model(cfg: Mapping[str, Any], n_classes: int, layout=None) -> nn.Module:
    """Build the model of a reference-schema config dict; ``layout`` (a
    ``parallel.Layout``) gives MIMOcom its ring when its agent groups hold
    more than one rank."""
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
    ring = layout.agent_group if layout is not None and layout.agent > 1 else None
    if ring is not None and name != "MIMOcom":
        raise ValueError(f"agent-axis parallelism is a MIMOcom feature (arch {name!r})")

    backbones = Backbones(m.get("enc_backbone") or "resnet_encoder",
                          m.get("dec_backbone") or "simple_decoder",
                          int(m.get("feat_squeezer") or -1))
    common = dict(n_classes=n_classes, feat_channel=m.get("feat_channel", 512),
                  dtype=compute_dtype(cfg), backbones=backbones)
    if name == "Single_agent":
        return SingleAgent(**common)
    if name in ("All_agents", "MIMO_All_agents"):
        return MODELS[name](shuffle_flag=m.get("shuffle_features"),
                            agent_num=m["agent_num"], **common)
    img_size = (cfg["data"]["img_rows"], cfg["data"]["img_cols"])
    comm = dict(agent_num=m["agent_num"], key_size=m["key_size"],
                query_size=m["query_size"], img_size=img_size, has_query=bool(m["query"]),
                **common)
    if name in ("MIMOcom", "MIMOcomWho") and m.get("shared_img_encoder") != "unified":
        raise ValueError("Incorrect shared_img_encoder flag")  # as the JAX models
    mo_flag = bool(m.get("multiple_output"))
    if name == "MIMOcom":
        # the sparse flag is accepted and ignored by the MIMO attention, as in JAX
        topk = {} if m.get("topk_k") is None else {"topk_k": int(m["topk_k"])}
        ring_train = bool(m.get("agent_parallel_train"))
        if ring is not None and m.get("pallas_comm"):
            raise ValueError(
                "model.pallas_comm and agent-axis parallelism are mutually exclusive: the "
                "agent ring fuses the comm step itself, so the comm kernel would be "
                "silently bypassed. Drop model.pallas_comm or model.agent_parallel.")
        if ring is None and ring_train:
            raise ValueError("model.agent_parallel_train requires model.agent_parallel (no "
                             "agent ring was built — training would silently run dense)")
        model = MIMOcom(remat=bool(m.get("remat")), mo_flag=mo_flag, ring=ring,
                        ring_train=ring_train, **topk, **comm)
        if ring_train:
            sync_bn.attach(model, ring)
        return model
    if name == "MIMOcomWho":
        return MIMOcomWho(mo_flag=mo_flag, **comm)
    return MODELS[name](attention=m["attention"], sparse=bool(m.get("sparse")),
                        shared_img_encoder=m["shared_img_encoder"], **comm)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init in the JAX package's distributions: he-normal convs and
    transposed convs (fan-in over the kernel and the input channels, as
    flax's kernel (kh, kw, in, out)), xavier-normal linears, zero biases,
    fresh BatchNorm. Drawn on the CPU from one ``torch.Generator``, so every
    device gets the same weights."""
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
        elif isinstance(mod, nn.ConvTranspose2d):  # (in, out, kh, kw): fan-in over in
            w = mod.weight
            std = math.sqrt(2.0 / (w.shape[0] * w[0, 0].numel()))
            w.copy_(torch.randn(w.shape, generator=gen) * std)
            mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model


__all__ = ["MODELS", "compute_dtype", "get_model", "init_weights",
           *(cls.__name__ for cls in MODELS.values())]
