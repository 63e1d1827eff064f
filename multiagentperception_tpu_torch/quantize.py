"""Post-training int8 quantization of the eval path (port of
multiagentperception_tpu/quantize.py).

Every eligible ``models.blocks.Conv2d`` of a model runs as an int8
convolution (``ops/kernels/int8_conv``, K4 on the card) while an
``Int8Convs`` swap is active, with no change to model code: the
counterpart of the JAX package's flax method interceptor. As JAX swaps
only ``type(mod) is nn.Conv``, only ``type(mod) is Conv2d`` is swapped.

- **weights**: symmetric per-output-channel int8 (scale max|w| / 127) of
  the float32 parameter, quantized once per swap and cached on the
  module's device; ``Int8Convs.clear`` drops the cache (``Evaluator``
  does so when it loads weights).
- **activations**: symmetric per-tensor int8. *Static*: scales from
  ``calibrate_activations`` (max|input| over calibration batches, / 127).
  *Dynamic*: a conv without a calibrated scale takes max|x| / 127 of its
  input at each call.
- **accumulation**: int32, then ``float(acc) * (s_x * s_w) + bias`` in
  float32, cast once to the conv's compute dtype (or its input's).

``default_skip`` keeps convs below 16 output channels (the 11-class head)
in the network dtype. BatchNorm, the communication step, the key/query
MLPs and the resize stay in the network dtype, as in JAX.

Scales are ``{module name: float}``: the name is the conv's
``named_modules`` name (``u_encoder.feature_backbone.feature_backbone.conv1``),
the port's counterpart of JAX's flax path tuple. ``convert.scales_from_flax``
carries JAX's scales across.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn

from multiagentperception_tpu_torch.models.blocks import Conv2d
from multiagentperception_tpu_torch.ops.kernels.int8_conv import (
    EPS,
    dynamic_scale,
    int8_conv,
    prepare_weight,
    quantize_input,
    quantize_weight,
)

__all__ = ["quantize_weight", "quantize_activation", "default_skip", "eligible_convs",
           "Int8Convs", "calibrate_activations", "scales_to_json", "scales_from_json",
           "quantized_apply", "make_int8_eval_fn"]

Skip = Callable[[nn.Module], bool]


def quantize_activation(x: torch.Tensor, eps: float = EPS):
    """Symmetric per-tensor dynamic int8: x -> (int8 x, float32 scalar scale)."""
    s_x = dynamic_scale(x, eps)
    return quantize_input(x, s_x), s_x


def default_skip(mod: nn.Module, min_features: int = 16) -> bool:
    """Keep tiny heads (the 11-class classifier conv) in full precision."""
    return mod.out_channels < min_features


def eligible_convs(model: nn.Module, skip: Skip | None = default_skip):
    """(name, module) of every conv the swap routes through K4."""
    return [(name, mod) for name, mod in model.named_modules()
            if type(mod) is Conv2d and not (skip and skip(mod))]


class Int8Convs:
    """While active (``with Int8Convs(model, act_scales):``), every eligible
    ``Conv2d`` of ``model`` runs through ``int8_conv``. ``act_scales``
    (``{name: scale}``) gives static activation scales; a conv without one
    scales dynamically. ``calls`` counts the swapped conv calls. Weights
    are quantized at a conv's first call and kept until ``clear``: clear
    after the model's weights change."""

    def __init__(self, model: nn.Module, act_scales: dict | None = None,
                 skip: Skip | None = default_skip):
        self.model = model
        self.act_scales = act_scales
        self.convs = eligible_convs(model, skip)
        self.calls = 0
        self._weights: dict[str, object] = {}
        self._scales: dict[str, torch.Tensor] = {}

    def clear(self) -> None:
        """Drop the quantized weights and the scales on the device."""
        self._weights.clear()
        self._scales.clear()

    def _forward(self, name: str, mod: Conv2d, x: torch.Tensor) -> torch.Tensor:
        w = self._weights.get(name)
        if w is None:
            w = self._weights[name] = prepare_weight(mod.weight)
        s_x = None
        if self.act_scales is not None and name in self.act_scales:
            s_x = self._scales.get(name)
            if s_x is None:
                s_x = self._scales[name] = torch.tensor(
                    float(self.act_scales[name]), dtype=torch.float32, device=x.device)
        self.calls += 1
        bias = None if mod.bias is None else mod.bias.detach()
        return int8_conv(x, w, s_x, bias, mod.stride, mod.padding, mod.dilation, mod.groups,
                         out_dtype=mod.compute_dtype or x.dtype)

    def __enter__(self) -> "Int8Convs":
        for name, mod in self.convs:
            mod.forward = functools.partial(self._forward, name, mod)
        return self

    def __exit__(self, *exc) -> None:
        for _, mod in self.convs:
            del mod.forward  # the instance attribute: Conv2d.forward again


def calibrate_activations(model: nn.Module, batches, skip: Skip | None = default_skip,
                          **forward_kwargs) -> dict:
    """One-off calibration: eval-mode forwards over ``batches`` (device
    tensors) record the max |input| of every eligible conv in float32 on
    the device, max-reduced across calls and batches, read back once.
    Returns ``{name: max(m / 127, 1e-8)}`` for ``Int8Convs`` /
    ``quantized_apply``. ``model.remat`` needs no remat-free twin here: it
    acts only in a training forward that records gradients."""
    maxes: dict[str, torch.Tensor] = {}

    def recorder(name: str):
        def hook(_mod, args):
            m = args[0].detach().float().abs().amax()
            maxes[name] = m if name not in maxes else torch.maximum(maxes[name], m)
        return hook

    handles = [mod.register_forward_pre_hook(recorder(name))
               for name, mod in eligible_convs(model, skip)]
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for batch in batches:
                model(batch, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if not maxes:
        return {}
    host = torch.stack(list(maxes.values())).cpu().tolist()
    return {name: max(m / 127.0, 1e-8) for name, m in zip(maxes, host)}


def scales_to_json(act_scales: dict) -> dict:
    """{name: scale} -> a JSON-serializable {name: float}."""
    return {str(name): float(s) for name, s in act_scales.items()}


def scales_from_json(obj: dict) -> dict:
    """Inverse of scales_to_json."""
    return {str(k): float(v) for k, v in obj.items()}


def quantized_apply(model: nn.Module, *args, skip: Skip | None = default_skip,
                    act_scales: dict | None = None, **kwargs):
    """``model(*args, **kwargs)`` with every eligible conv running int8
    (weights quantized for this call)."""
    with Int8Convs(model, act_scales, skip):
        return model(*args, **kwargs)


def make_int8_eval_fn(model: nn.Module, inference: str = "activated",
                      skip: Skip | None = default_skip, act_scales: dict | None = None):
    """int8 version of ``export.make_eval_fn``: images -> (class map, comm
    graph, per-frame bandwidth). The swap wraps the forward inside the
    function; the bandwidth accounting is ``export.make_eval_fn``'s."""
    from multiagentperception_tpu_torch.export import make_eval_fn

    swap = Int8Convs(model, act_scales, skip)

    def apply(images, **kwargs):
        with swap:
            return model(images, **kwargs)

    return make_eval_fn(model, inference=inference, apply_fn=apply)
