"""The port's float16 models (``model.dtype: float16``) against the JAX
package's float16 models on shared weights, on the CPU: the flagship
MIMOcom in every inference mode against JAX with ``model.pallas_comm`` (its
K2 in interpret mode), one float16 train step of the flagship, and the
flagship's int8 eval in a float16 network. The six other architectures are
in tests/test_torch_float16_zoo.py.

The helpers, shapes and rule are tests/test_torch_mixed_precision_models.py's,
read in float16 (64x64, B=2, N=3, query_size 8, key_size 64, the
flagship's projection scaled by ``PEAK``): over the seeds, the port's
float16 prediction lies no further from the port's float32 prediction than
twice the distance of JAX's float16 prediction from JAX's float32 one
(relative L2, summed over the seeds); actions and bandwidth equal JAX's but
for links within 1e-2 of the threshold or of their column's runner-up
(excused, at most 10%). float16 runs two seeds (``F16_SEEDS``) where bf16
runs four: float16's rounding is 8x finer, and the rule reads the sum.
Every float16 prediction is finite on both sides: nothing overflows at
these weights (the largest pre-BatchNorm value is far below 65504).

The train step (``Trainer`` on the CPU against JAX's eager float16
training forward): the loss within 1e-2 relative, the BatchNorm running
statistics within rtol/atol 1e-2, every parameter float32 and finite after
the Adam step, every gradient float32 and finite. No loss scaling on
either side (JAX has none): a gradient that underflows in float16 is zero
in both programs. At this toy the whole policy tower's gradients flush to
zero in float16 (98 of 166 tensors), so the bf16 test's "more than 100
tensors moved" cannot hold; instead the tensors whose gradient is exactly
zero are exactly those whose gradient is exactly zero in JAX's float16
step (``jax.grad`` of its eager training forward, ~30 s on the CPU), and
every other tensor moved.

int8 in a float16 network, and in a bf16 one beside it (static scales
calibrated by JAX, carried across by ``convert.scales_from_flax``,
128x128, the attention scaled up as tests/test_torch_int8_eval.py does):
the same actions and bandwidth as JAX's, the graph within 1e-4, and the
prediction under that file's rule for a network whose int8 values flip
(``"who2com"``: pre-upsample logits within 5e-2 of their largest
magnitude, class maps on at least 97% of the pixels), not its float32
rule (2e-2, 99.5%). In a 16-bit network the float layers between the int8
convolutions round to the 16-bit type at other places in the two
frameworks, so values near a half-step of the next grid round to
neighbouring int8 values and the flips spread down the towers, as in
LearnWho2Com's float32 value tower. Measured on this input: float16 3.78e-2
and 99.12% of the pixels, bfloat16 3.92e-2 and 99.19% (float32 4.7e-7 and
100%); the graph within 2.9e-5, actions and bandwidth equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu import quantize as jq
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.loss import get_loss_function as jax_get_loss
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu_torch import quantize as tq
from multiagentperception_tpu_torch.convert import scales_from_flax, state_dict_from_flax
from multiagentperception_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax_plain
from test_torch_int8_eval import GRAPH_ATOL, _assert_agrees, _jax_int8, _jax_setup
from test_torch_mixed_precision_models import (
    FLAGSHIP_MODES,
    flagship_against_jax,
    shared_seeds,  # noqa: F401 (a fixture)
    train_step_against_jax,
)
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import jax_kwargs, raw_cfg

F16_SEEDS = (0, 1)
INT8_N, INT8_IMG = 3, 128


@pytest.mark.parametrize("mode", FLAGSHIP_MODES)
def test_flagship_f16_matches_jax(shared_seeds, mode):  # noqa: F811
    flagship_against_jax(shared_seeds, mode, "float16", F16_SEEDS)


def _jax_zero_gradients(step: dict) -> set:
    """The parameters whose gradient is exactly zero in JAX's float16 train
    step on ``step``'s inputs (``jax.grad`` of its eager training forward
    and loss), by the port's names."""
    raw, variables = step["raw"], step["variables"]
    jcfg = jax_normalize_config(raw)
    model, loss_fn = jax_get_model(jcfg, 11), jax_get_loss(jcfg)
    img = step["images"].shape[-2]
    y = jnp.asarray(step["labels"].reshape((-1, img, img)).astype(np.uint8))

    def loss(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(step["images"]), train=True, mo_flag=True,
                             inference="softmax", mutable=["batch_stats"])
        return loss_fn(input=out[0], target=y)

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(variables["params"]))
    named = state_dict_from_flax(jcfg, {"params": grads,
                                        "batch_stats": variables["batch_stats"]})
    return {n for n in step["grads"] if not bool(named[n].any())}


def test_float16_train_step_matches_jax(shared_seeds):  # noqa: F811
    step = train_step_against_jax(shared_seeds, "float16", moved_at_least=1)
    grads = step["grads"]
    assert all(g is not None and g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())
    zero = {n for n, g in grads.items() if not bool(g.any())}
    print(f"float16 train step: {len(zero)} of {len(grads)} gradients exactly zero")
    assert zero == _jax_zero_gradients(step)
    assert set(step["moved"]) == set(grads) - zero


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_flagship_int8_16bit_matches_jax(dtype):
    cfg = raw_cfg("MIMOcom", INT8_N, (INT8_IMG, INT8_IMG), pallas_comm=True, dtype=dtype)
    jm, v, model, tcfg, x, calib = _jax_setup(cfg)
    kw = jax_kwargs(cfg, False, "activated")
    j_scales = jq.calibrate_activations(jm, v, [jnp.asarray(b) for b in calib], **kw)
    want_pre, want_cls, want_prob, want_nc = _jax_int8(jm, v, x, cfg, "activated", j_scales)
    j_action = np.asarray(jq.quantized_apply(jm, v, jnp.asarray(x), act_scales=j_scales,
                                             **kw)[2])
    swap = tq.Int8Convs(model, scales_from_flax(tcfg, j_scales))
    with swap, torch.inference_mode():
        pre, prob, action, nc = model(torch.from_numpy(x), inference="activated",
                                      full_res=False)
    assert pre.dtype == getattr(torch, dtype) and bool(torch.isfinite(pre).all())
    assert swap.calls == len(scales_from_flax(tcfg, j_scales))
    cls = upsample_argmax_plain(pre, INT8_IMG, INT8_IMG).numpy().reshape(want_cls.shape)
    _assert_agrees(pre.float().numpy(), want_pre, cls, want_cls, "who2com")
    np.testing.assert_allclose(prob.numpy(), want_prob, rtol=0, atol=GRAPH_ATOL)
    np.testing.assert_array_equal(action.numpy(), j_action)
    assert float(nc) == float(want_nc)
    assert 0 < float(want_nc) < INT8_N - 1  # a real pruning: some links kept, some not
