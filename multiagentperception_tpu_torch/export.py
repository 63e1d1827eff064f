"""The serving function (port of ``make_eval_fn``, multiagentperception_tpu/export.py:20-47).

``make_eval_fn`` builds the eval step a server runs: images -> (int32
class map, comm graph, per-frame bandwidth ``(B,)``). The class map comes
from the decoder's pre-upsample logits through K1 ``upsample_argmax``, as
``Evaluator.predict`` makes it. ``quantize.make_int8_eval_fn`` passes its
int8 forward as ``apply_fn``, so both share this bandwidth accounting.

The serving artifact itself (``export_serving`` / ``load_serving``) is
not ported yet: it needs the port's kernels as ``torch.library`` custom
ops that ``torch.export`` can carry (ROADMAP.md A.8).
"""

from __future__ import annotations

import torch

from multiagentperception_tpu_torch.ops.comm import per_frame_links
from multiagentperception_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax


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
        pre, prob, _action, num_connect = apply(images, inference=inference, full_res=False)
        if prob.dim() == 3 and prob.shape[1] == prob.shape[2]:
            nc = per_frame_links(prob, inference, prob.shape[1])
        else:  # SRMS single-query graphs: broadcast the model's scalar
            nc = torch.as_tensor(num_connect, dtype=torch.float32,
                                 device=images.device).expand(images.shape[0])
        return upsample_argmax(pre, images.shape[-3], images.shape[-2]), prob, nc

    return eval_fn
