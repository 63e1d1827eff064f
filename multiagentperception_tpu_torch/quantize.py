"""Post-training int8 quantization of the eval path (port of
multiagentperception_tpu/quantize.py).

Every eligible ``models.blocks.Conv2d`` of a model runs as an int8
convolution (``ops/kernels/int8_conv``, K4 on the card) while an
``Int8Convs`` swap is active, with no change to model code: the
counterpart of the JAX package's flax method interceptor. As JAX swaps
only ``type(mod) is nn.Conv``, only ``type(mod) is Conv2d`` is swapped:
the transposed convs of the SegNet decoder and the de-squeezers
(``models.blocks.ConvTranspose2d``) stay in the network dtype.

- **weights**: symmetric per-output-channel int8 (scale max|w| / 127) of
  the float32 parameter (on the model axis, of the rank's shard: its
  scales are the slice of the whole weight's), quantized once per swap and
  cached on the module's device; ``Int8Convs.clear`` drops the cache (``Evaluator``
  does so when it loads weights).
- **activations**: symmetric per-tensor int8. *Static*: scales from
  ``calibrate_activations`` (max|input| over calibration batches, / 127).
  *Dynamic*: a conv without a calibrated scale takes max|x| / 127 of its
  input at each call.
- **accumulation**: int32, then ``float(acc) * (s_x * s_w) + bias`` in
  float32, cast once to the conv's compute dtype (or its input's): float32,
  bf16 or float16, each a route of K4 on the card (JAX quantize.py:126-132).

``default_skip`` keeps convs below 16 output channels (the 11-class head)
in the network dtype. BatchNorm, the communication step, the key/query
MLPs and the resize stay in the network dtype, as in JAX.

For a serving export, ``bake_int8`` quantizes and packs every eligible
conv's weights once, outside any trace, into a copy of the model whose
eligible convs are ``BakedInt8Conv`` modules: their buffers hold the int8
weights as the B operand of the conv's plan at the export's input shape
(the one copy of them: the GEMM's CPU version unpacks it), the per-channel
scales and the static activation scale, so that the exported
graph holds no weight quantization (JAX constant-folds them the same way,
export.py:64-67).

Scales are ``{module name: float}``: the name is the conv's
``named_modules`` name (``u_encoder.feature_backbone.feature_backbone.conv1``),
the port's counterpart of JAX's flax path tuple. ``convert.scales_from_flax``
carries JAX's scales across.
"""

from __future__ import annotations

import copy
import functools
import itertools
import weakref
from typing import Callable

import torch
from torch import nn

from multiagentperception_tpu_torch.models.blocks import Conv2d
from multiagentperception_tpu_torch.ops.kernels.int8_conv import (
    EPS,
    _check,
    dynamic_scale,
    int8_conv,
    int8_conv_ops,
    plan,
    prepare_weight,
    quantize_input,
    quantize_weight,
)
from multiagentperception_tpu_torch.parallel.collectives import all_reduce_max
from multiagentperception_tpu_torch.parallel.tensor import ColumnConv2d

__all__ = ["quantize_weight", "quantize_activation", "default_skip", "eligible_convs",
           "Int8Convs", "calibrate_activations", "scales_to_json", "scales_from_json",
           "quantized_apply", "make_int8_eval_fn", "BakedInt8Conv", "conv_input_shapes",
           "bake_int8"]

Skip = Callable[[nn.Module], bool]
_SERIALS = itertools.count()  # names a swap's quantized weights (a graph key)
_ACTIVE: "weakref.WeakKeyDictionary[nn.Module, Int8Convs]" = weakref.WeakKeyDictionary()


def active_swap(model: nn.Module) -> "Int8Convs | None":
    """The ``Int8Convs`` active on ``model``, if any."""
    return _ACTIVE.get(model)


def quantize_activation(x: torch.Tensor, eps: float = EPS):
    """Symmetric per-tensor dynamic int8: x -> (int8 x, float32 scalar scale)."""
    s_x = dynamic_scale(x, eps)
    return quantize_input(x, s_x), s_x


def default_skip(mod: nn.Module, min_features: int = 16) -> bool:
    """Keep tiny heads (the 11-class classifier conv) in full precision."""
    return mod.out_channels < min_features


def eligible_convs(model: nn.Module, skip: Skip | None = default_skip):
    """(name, module) of every conv the swap routes through K4: a
    ``Conv2d``, or its output-channel shard on the model axis
    (``parallel.tensor.ColumnConv2d``)."""
    return [(name, mod) for name, mod in model.named_modules()
            if type(mod) in (Conv2d, ColumnConv2d) and not (skip and skip(mod))]


class Int8Convs:
    """While active (``with Int8Convs(model, act_scales):``), every eligible
    ``Conv2d`` of ``model`` runs through ``int8_conv``. ``act_scales``
    (``{name: scale}``) gives static activation scales; a conv without one
    scales dynamically. ``calls`` counts the swapped conv calls. Weights
    are quantized at a conv's first call and kept until ``clear``: clear
    after the model's weights change. ``serial`` is new at construction
    and at each ``clear``: a CUDA graph captured under the swap is keyed by
    it (and holds the swap), since it reads the quantized weights where
    they lie."""

    def __init__(self, model: nn.Module, act_scales: dict | None = None,
                 skip: Skip | None = default_skip):
        self.model = model
        self.act_scales = act_scales
        self.convs = eligible_convs(model, skip)
        self.calls = 0
        self.serial = next(_SERIALS)
        self._weights: dict[str, object] = {}
        self._scales: dict[str, torch.Tensor] = {}

    def clear(self) -> None:
        """Drop the quantized weights and the scales on the device."""
        self._weights.clear()
        self._scales.clear()
        self.serial = next(_SERIALS)

    def _forward(self, name: str, mod: Conv2d, x: torch.Tensor) -> torch.Tensor:
        w = self._weights.get(name)
        if w is None:
            w = self._weights[name] = prepare_weight(mod.weight)
        s_x = None
        if self.act_scales is not None and name in self.act_scales:
            s_x = self._scales.get(name)
            if s_x is None:
                s_x = self._scales[name] = torch.full(
                    (), float(self.act_scales[name]), dtype=torch.float32, device=x.device)
        self.calls += 1
        if isinstance(mod, ColumnConv2d):  # the shard's channels, then every rank's
            return mod.gather(int8_conv(x, w, s_x, mod.local_bias(), mod.stride, mod.padding,
                                        mod.dilation, mod.groups,
                                        out_dtype=mod.compute_dtype or x.dtype))
        bias = None if mod.bias is None else mod.bias.detach()
        return int8_conv(x, w, s_x, bias, mod.stride, mod.padding, mod.dilation, mod.groups,
                         out_dtype=mod.compute_dtype or x.dtype)

    def __enter__(self) -> "Int8Convs":
        for name, mod in self.convs:
            mod.forward = functools.partial(self._forward, name, mod)
        _ACTIVE[self.model] = self
        return self

    def __exit__(self, *exc) -> None:
        for _, mod in self.convs:
            del mod.forward  # the instance attribute: Conv2d.forward again
        _ACTIVE.pop(self.model, None)


def calibrate_activations(model: nn.Module, batches, skip: Skip | None = default_skip,
                          group=None, **forward_kwargs) -> dict:
    """One-off calibration: eval-mode forwards over ``batches`` (device
    tensors) record the max |input| of every eligible conv in float32 on
    the device, max-reduced across calls and batches, read back once.
    Returns ``{name: max(m / 127, 1e-8)}`` for ``Int8Convs`` /
    ``quantized_apply``. ``model.remat`` needs no remat-free twin here: it
    acts only in a training forward that records gradients.

    ``group`` (a ``parallel.collectives.Group``): the maxes are reduced
    over its ranks in one MAX collective before the readback, so ranks that
    each see a part of the batch (the agent ring's towers) get the scales
    of the whole, as JAX's recorder takes them over the global arrays. A
    conv no rank called has no scale."""
    convs = eligible_convs(model, skip)
    maxes: dict[str, torch.Tensor] = {}

    def recorder(name: str):
        def hook(_mod, args):
            m = args[0].detach().float().abs().amax()
            maxes[name] = m if name not in maxes else torch.maximum(maxes[name], m)
        return hook

    handles = [mod.register_forward_pre_hook(recorder(name)) for name, mod in convs]
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
    if group is None:
        names = list(maxes)
        host = torch.stack(list(maxes.values())).cpu().tolist() if maxes else []
    else:  # every rank stacks every conv, -1 where it called none
        names = [name for name, _ in convs]
        unseen = torch.full((), -1.0, device=group.device)
        host = all_reduce_max(torch.stack([maxes.get(name, unseen).to(group.device)
                                           for name in names]), group).cpu().tolist()
    return {name: max(m / 127.0, 1e-8) for name, m in zip(names, host) if m >= 0.0}


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


class BakedInt8Conv(nn.Module):
    """An eligible ``Conv2d`` with its int8 weights baked in: the buffers
    ``operand`` (the int8 weight as the kernel's B operand for the plan of
    the one input shape it serves), ``s_w`` (Cout,), ``bias`` and ``s_x``
    (the static activation scale, a float32 scalar; None scales
    dynamically). Its forward is the swap's (``Int8Convs``) on these
    buffers, bit for bit, without the float weight."""

    def __init__(self, conv: Conv2d, weight, operand: torch.Tensor, s_x: float | None):
        super().__init__()
        self.weight_shape = tuple(weight.w_i8.shape)
        self.register_buffer("operand", operand)
        self.register_buffer("s_w", weight.s_w)
        self.register_buffer("bias", None if conv.bias is None else conv.bias.detach().clone())
        self.register_buffer("s_x", None if s_x is None else torch.tensor(
            float(s_x), dtype=torch.float32, device=operand.device))
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        self.compute_dtype = conv.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.compute_dtype or x.dtype
        stride, pad, _, _ = _check(x, self.weight_shape, self.stride, self.padding,
                                   self.dilation, self.groups, out_dtype)
        s_x = dynamic_scale(x) if self.s_x is None else self.s_x
        return int8_conv_ops(x, self.operand, self.s_w, s_x, self.bias, self.weight_shape[2:],
                             stride, pad, out_dtype)


def conv_input_shapes(model: nn.Module, input_shape: tuple,
                      input_dtype: torch.dtype = torch.float32, skip: Skip | None = default_skip,
                      **forward_kwargs) -> dict:
    """``{name: input shape}`` of every eligible conv in one eval-mode
    forward of images shaped ``input_shape``, run by a copy of the model on
    the ``meta`` device (nothing computed, no kernel launched). Each conv
    must see one shape."""
    shapes: dict[str, tuple] = {}

    def recorder(name: str):
        def hook(_mod, args):
            shape = tuple(args[0].shape)
            if shapes.setdefault(name, shape) != shape:
                raise ValueError(f"{name} sees inputs {shapes[name]} and {shape}: a baked "
                                 "int8 conv serves one shape")
        return hook

    meta = copy.deepcopy(model).to("meta").eval()
    for name, mod in eligible_convs(meta, skip):
        mod.register_forward_pre_hook(recorder(name))
    with torch.no_grad():
        meta(torch.empty(input_shape, dtype=input_dtype, device="meta"), **forward_kwargs)
    return shapes


@torch.no_grad()
def bake_int8(model: nn.Module, input_shape: tuple, input_dtype: torch.dtype = torch.float32,
              act_scales: dict | None = None, skip: Skip | None = default_skip,
              **forward_kwargs) -> nn.Module:
    """A copy of ``model`` in eval mode whose eligible convs are
    ``BakedInt8Conv`` modules for images shaped ``input_shape`` (each conv's
    input shape, and so its plan, from ``conv_input_shapes``): weights
    quantized and packed once, here, and ``act_scales`` (``{name: scale}``)
    as static scales; a conv without one scales dynamically. ``model`` is
    unchanged."""
    shapes = conv_input_shapes(model, input_shape, input_dtype, skip, **forward_kwargs)
    baked = copy.deepcopy(model).eval()
    for name, mod in eligible_convs(baked, skip):
        weight = prepare_weight(mod.weight)
        n, c_in, h, w = shapes[name]
        _, _, kh, kw = mod.weight.shape  # square stride and padding (BakedInt8Conv checks)
        operand = weight.operand(plan(n, c_in, h, w, mod.out_channels, kh, kw, mod.stride[0],
                                      mod.padding[0]))
        scale = None if act_scales is None else act_scales.get(name)
        parent, _, child = name.rpartition(".")
        setattr(baked.get_submodule(parent), child, BakedInt8Conv(mod, weight, operand, scale))
    return baked
