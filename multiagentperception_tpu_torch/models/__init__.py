"""Model registry (port of multiagentperception_tpu/models/__init__.py:28-129).

Every model the JAX package's ``get_model`` builds: the seven reference
architectures over the ``resnet_encoder`` / ``n_segnet_encoder`` encoders
and the ``simple_decoder`` / ``FCN_decoder`` / ``n_segnet_decoder``
decoders, with ``feat_squeezer``, ``sparse`` (sparsemax on the SRMS
attentions), MIMOcom's ``query: false`` / ``multiple_output: false`` and its
``topk`` eval (``topk_k``), in float32 or, with ``model.dtype: bfloat16``
(or the ``training.mixed_precision`` shorthand) or ``model.dtype:
float16``, computing in that type with float32 parameters and BatchNorm
statistics (``compute_dtype``). Nothing on the model surface is refused.
With a ``parallel.Layout`` whose rings hold more than one rank
(``model.agent_parallel``), MIMOcom's full-graph eval modes run the
communication step as a ring over its agent group (``parallel.ring``), and
with ``model.agent_parallel_train`` its training forward too, its
BatchNorms then taking their statistics over the ring
(``parallel.sync_bn``); ``get_model`` raises where the JAX one does
(models/__init__.py:102-127). With a layout whose model groups hold more
than one rank (``Layout(model=M)``, the mesh's ``model`` axis), every
layer of any architecture that JAX's ``param_shardings`` shards holds
this rank's output channels (``parallel.tensor``).
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
from multiagentperception_tpu_torch.models.attention import AdditiveAttention
from multiagentperception_tpu_torch.parallel import sync_bn, tensor

MODELS = {
    "Single_agent": SingleAgent,
    "All_agents": AllAgents,
    "MIMO_All_agents": MIMOAllAgents,
    "LearnWho2Com": LearnWho2Com,
    "LearnWhen2Com": LearnWhen2Com,
    "MIMOcom": MIMOcom,
    "MIMOcomWho": MIMOcomWho,
}


def compute_dtype(cfg: Mapping[str, Any]) -> torch.dtype | None:
    """The models' compute dtype (JAX models/__init__.py:57-66):
    ``model.dtype`` (``bfloat16`` or ``float16``), else ``bfloat16`` when
    ``training.mixed_precision`` is set; ``None`` for float32."""
    name = cfg["model"].get("dtype")
    if name is None and cfg.get("training", {}).get("mixed_precision"):
        name = "bfloat16"
    if name in (None, "None", "float32"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float16":
        return torch.float16
    raise KeyError(f"model.dtype={name!r}: bfloat16, float16, float32 or None")


def get_model(cfg: Mapping[str, Any], n_classes: int, layout=None) -> nn.Module:
    """Build the model of a reference-schema config dict; ``layout`` (a
    ``parallel.Layout``) gives MIMOcom its ring when its agent groups hold
    more than one rank, and shards any model over its model group when that
    holds more than one (module docstring)."""
    model = _build(cfg, n_classes, layout)
    if layout is not None and layout.model > 1:
        tensor.parallelize(model, layout.model_group)
    return model


def _build(cfg: Mapping[str, Any], n_classes: int, layout) -> nn.Module:
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


# flax's variance_scaling "truncated_normal": a unit normal cut at +-2 has
# this std, so the draw is divided by it to keep the variance asked for
TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape: tuple, std: float, gen: torch.Generator) -> torch.Tensor:
    """A normal of ``std`` cut at two of them, by the inverse CDF of a
    uniform draw (``jax.random.truncated_normal``'s method; torch 2.11's
    ``nn.init.trunc_normal_`` draws the same values from the same
    generator, torch 2.13's samples by rejection, other values 8x slower)."""
    edge = math.erf(math.sqrt(2.0))  # 2 * Phi(2) - 1
    out = torch.empty(shape).uniform_(-edge, edge, generator=gen).erfinv_()
    return out.mul_(std * math.sqrt(2.0)).clamp_(min=-2.0 * std, max=2.0 * std)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init in the JAX package's distributions, flax's
    ``variance_scaling(scale, mode, "truncated_normal")``: each weight is a
    normal of std ``sqrt(var) / TRUNC_STD`` cut at two of those stds, so
    ``|w| <= 2 sqrt(var) / TRUNC_STD`` and its std is ``sqrt(var)``. ``var``
    is he-normal's ``2 / fan_in`` for convs and transposed convs (fan-in
    over the kernel and the input channels, as flax's kernel (kh, kw, in,
    out); ``blocks.conv_init``), lecun-normal's ``1 / fan_in`` for
    AdditiveAttention's three linears (flax's default ``nn.Dense`` init,
    attention.py:56-58) and xavier-normal's ``2 / (fan_in + fan_out)`` for
    every other linear. Biases are zero and BatchNorm is fresh. Drawn on the
    CPU from one ``torch.Generator``, so every device gets the same weights;
    a layer sharded over a model group draws the whole weight and keeps its
    shard, so the shards are the one-process weights' (``parallel.tensor``)."""
    gen = torch.Generator().manual_seed(seed)
    lecun = {lin for mod in model.modules() if isinstance(mod, AdditiveAttention)
             for lin in (mod.linear_feat, mod.linear_context, mod.linear_out)}

    def draw(mod: nn.Module, var_of) -> None:
        shape = tuple(getattr(mod, "full_weight_shape", mod.weight.shape))
        full = _truncated_normal(shape, math.sqrt(var_of(shape)) / TRUNC_STD, gen)
        mod.weight.copy_(mod.take(full) if isinstance(mod, tensor.ColumnParallel) else full)
        if mod.bias is not None:
            mod.bias.zero_()

    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):  # (out, in, kh, kw)
            draw(mod, lambda s: 2.0 / math.prod(s[1:]))
        elif isinstance(mod, nn.Linear) and mod in lecun:  # (out, in)
            draw(mod, lambda s: 1.0 / s[1])
        elif isinstance(mod, nn.Linear):
            draw(mod, lambda s: 2.0 / (s[1] + s[0]))
        elif isinstance(mod, nn.ConvTranspose2d):  # (in, out, kh, kw): fan-in over in
            draw(mod, lambda s: 2.0 / (s[0] * s[2] * s[3]))
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model


__all__ = ["MODELS", "compute_dtype", "get_model", "init_weights",
           *(cls.__name__ for cls in MODELS.values())]
