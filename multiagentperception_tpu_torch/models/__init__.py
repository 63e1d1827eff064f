"""Model registry (port of multiagentperception_tpu/models/__init__.py:28-129).

This slice ports MIMOcom in the flagship shape: unified ResNet-18 encoder,
simple decoder, queries on, multiple outputs, float32. Anything else raises
``NotImplementedError`` naming ROADMAP.md, never a silent substitute.
``model.pallas_comm`` is accepted and has no effect: the port's pruned eval
modes always run the fused comm step (models/agents.py).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
from torch import nn

from multiagentperception_tpu_torch.models.agents import MIMOcom

_LATER = "not ported yet; see ROADMAP.md queue A"


def get_model(cfg: Mapping[str, Any], n_classes: int) -> MIMOcom:
    """Build the model of a reference-schema config dict."""
    m = cfg["model"]
    wanted = {
        "arch": "MIMOcom", "enc_backbone": "resnet_encoder",
        "dec_backbone": "simple_decoder", "shared_img_encoder": "unified",
        "attention": "general", "query": True, "multiple_output": True,
    }
    for key, value in wanted.items():
        if m.get(key) != value:
            raise NotImplementedError(f"model.{key}={m.get(key)!r}: {_LATER}")
    if (m.get("feat_squeezer") or -1) != -1:
        raise NotImplementedError(f"model.feat_squeezer={m['feat_squeezer']!r}: {_LATER}")
    if m.get("dtype") not in (None, "None", "float32") or \
            cfg.get("training", {}).get("mixed_precision"):
        raise NotImplementedError(f"mixed precision: {_LATER}")
    for key in ("agent_parallel", "agent_parallel_train"):
        if m.get(key):
            raise NotImplementedError(f"model.{key}: {_LATER}")
    rows, cols = cfg["data"]["img_rows"], cfg["data"]["img_cols"]
    if rows % 128 or cols % 128:
        raise ValueError(f"image size {rows}x{cols} must be a multiple of 128")
    return MIMOcom(
        n_classes=n_classes,
        feat_channel=m.get("feat_channel", 512),
        agent_num=m["agent_num"],
        key_size=m["key_size"],
        query_size=m["query_size"],
        img_size=(rows, cols),
    )


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


__all__ = ["MIMOcom", "get_model", "init_weights"]
