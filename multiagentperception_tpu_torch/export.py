"""Serving export (port of multiagentperception_tpu/export.py).

``make_eval_fn`` builds the eval step a server runs: images -> (int32
class map, comm graph, per-frame bandwidth ``(B,)``). The class map comes
from the decoder's pre-upsample logits through K1 ``upsample_argmax`` (or
the argmax of a SegNet decoder's full-resolution logits), as
``Evaluator.predict`` makes it (``class_map``). ``quantize.make_int8_eval_fn`` passes its
int8 forward as ``apply_fn``, so both share this bandwidth accounting.

``export_serving`` serializes that step with ``torch.export`` into bytes
that ``load_serving`` turns back into a callable ``ServingArtifact``
without the model code: the program holds the kernels as the custom ops of
``ops.kernels`` (``torch.ops.when2com.*``), so an artifact exported on the
CPU launches K1, K2 (and K4 for ``int8``) when it is moved to the card, and
one exported on the card runs there. Weights are baked into the program by
default; ``bake_weights=False`` exports the weight-hotswap variant, which
takes the model's state dict (the reference's names) before the images.
With ``int8`` and baked weights the int8 weights are quantized and packed
once, before the trace (``quantize.bake_int8``): the graph holds no
weight quantization.
"""

from __future__ import annotations

import io

import torch
from torch import nn

from multiagentperception_tpu_torch.ops.comm import per_frame_links
from multiagentperception_tpu_torch.ops.kernels.upsample_argmax import class_map


def _eval_outputs(apply, images: torch.Tensor, inference: str, topk_k: int = 2):
    """The serving step's body: (class map, graph, per-frame bandwidth).
    ``topk_k`` is the model's (JAX export.py:42-43)."""
    pre, prob, _action, num_connect = apply(images, inference=inference, full_res=False)
    if prob.dim() == 3 and prob.shape[1] == prob.shape[2]:
        nc = per_frame_links(prob, inference, prob.shape[1], topk_k=topk_k)
    else:  # SRMS single-query graphs: broadcast the model's scalar
        nc = torch.as_tensor(num_connect, dtype=torch.float32,
                             device=images.device).expand(images.shape[0])
    return class_map(pre, images.shape[-3], images.shape[-2]), prob, nc


def make_eval_fn(model: torch.nn.Module, inference: str = "activated", apply_fn=None):
    """The serving function of a comm model (its forward returns ``(pred,
    graph, action, num_connect)``) in eval mode: ``eval_fn(images)`` with
    images ``(B, N, H, W, 3)`` on the model's device returns the class map
    ``(B*N, H, W)`` int32, the graph and the per-frame bandwidth ``(B,)``,
    whose mean is the model's ``num_connect``. ``apply_fn(images,
    **kwargs)`` stands in for ``model(images, **kwargs)``. JAX's
    ``mo_flag`` argument has no counterpart: the port's models fix their
    output count when built (``model.multiple_output``)."""
    apply = apply_fn if apply_fn is not None else model

    @torch.inference_mode()
    def eval_fn(images: torch.Tensor):
        model.eval()
        return _eval_outputs(apply, images, inference, _topk_k(model))

    return eval_fn


def _topk_k(model: nn.Module) -> int:
    return getattr(model, "topk_k", 2)


class _Serving(nn.Module):
    """The exported module: ``make_eval_fn``'s body over ``model``."""

    def __init__(self, model: nn.Module, inference: str):
        super().__init__()
        self.model = model.eval()
        self.inference = inference

    def forward(self, images: torch.Tensor):
        return _eval_outputs(self.model, images, self.inference, _topk_k(self.model))


class _HotSwap(nn.Module):
    """The weight-hotswap module: ``forward(state_dict, images)`` runs the
    model on the given weights (``torch.func.functional_call``). The model
    is held outside the module's own state, so that the program carries no
    weights of its own; ``int8`` swaps the eligible convs to int8 inside the
    call, where the weights are quantized (JAX quantize.py:222-248)."""

    def __init__(self, model: nn.Module, inference: str, int8: bool, act_scales: dict | None):
        super().__init__()
        self.__dict__["_model"] = model.eval()  # not a submodule: no lifted weights
        self.inference, self.int8, self.act_scales = inference, int8, act_scales

    def forward(self, state: dict, images: torch.Tensor):
        from torch.func import functional_call

        def apply(x, **kwargs):
            return functional_call(self._model, state, (x,), kwargs, strict=True)

        topk_k = _topk_k(self._model)
        if not self.int8:
            return _eval_outputs(apply, images, self.inference, topk_k)
        from multiagentperception_tpu_torch.quantize import Int8Convs

        with Int8Convs(self._model, self.act_scales):  # a new weight cache per trace
            return _eval_outputs(apply, images, self.inference, topk_k)


def export_serving(model: nn.Module, input_shape: tuple, input_dtype: torch.dtype = torch.float32,
                   inference: str = "activated", bake_weights: bool = True, int8: bool = False,
                   act_scales: dict | None = None) -> bytes:
    """Serialize the eval step of ``model`` (on its device) for images of
    ``input_shape`` / ``input_dtype``; returns the artifact's bytes
    (``torch.export.save``).

    ``int8=True`` exports the post-training-quantized graph (quantize.py):
    the eligible convs run as K4's two ops. ``act_scales`` (from
    ``quantize.calibrate_activations``) gives static activation scales;
    without it activations are scaled at each call. ``bake_weights=False``
    takes the state dict as the first input instead of baking it."""
    device = next(model.parameters()).device
    images = torch.zeros(input_shape, dtype=input_dtype, device=device)
    model.eval()
    with torch.no_grad():
        if not bake_weights:
            state = {k: v.detach() for k, v in model.state_dict().items()}
            module, args = _HotSwap(model, inference, int8, act_scales), (state, images)
        else:
            if int8:
                from multiagentperception_tpu_torch.quantize import bake_int8

                model = bake_int8(model, input_shape, input_dtype, act_scales,
                                  inference=inference, full_res=False)
            module, args = _Serving(model, inference), (images,)
        program = torch.export.export(module, args)
    program.example_inputs = None  # not saved: a hot-swap's would be a copy of the weights
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class ServingArtifact:
    """A loaded serving artifact: callable, and self-describing. The image
    input's shape and dtype are read from the program's last user input
    (a weight-hotswap program takes its state dict first), never probed."""

    def __init__(self, program: torch.export.ExportedProgram):
        from torch.export.graph_signature import InputKind

        self.program = program
        self._module = program.module()
        names = [spec.arg.name for spec in program.graph_signature.input_specs
                 if spec.kind == InputKind.USER_INPUT]
        node = next(n for n in program.graph.nodes if n.op == "placeholder"
                    and n.name == names[-1])
        self._image = node.meta["val"]

    @property
    def input_shape(self) -> tuple:
        return tuple(int(d) for d in self._image.shape)

    @property
    def input_dtype(self) -> torch.dtype:
        return self._image.dtype

    @property
    def batch(self) -> int:
        return self.input_shape[0]

    def __call__(self, *args):
        with torch.inference_mode():
            return self._module(*args)


def load_serving(artifact: bytes, device: str | torch.device | None = None) -> ServingArtifact:
    """Rehydrate an artifact (``export_serving``'s bytes) into a callable.
    The program runs where it was exported, or on ``device`` if given
    (``torch.export.passes.move_to_device_pass``). Loads the kernels' ops,
    not the model code."""
    import multiagentperception_tpu_torch.ops.kernels  # noqa: F401 (registers the ops)

    program = torch.export.load(io.BytesIO(artifact))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    return ServingArtifact(program)
