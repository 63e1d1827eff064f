"""Sparsemax and the SRMS attentions' ``sparse`` flag against the JAX
package, on the CPU.

- ``ops.sparsemax`` forward and backward against ``ops/sparsemax.py``'s
  custom VJP on the same logits and cotangents, to 1e-6, along either
  axis, including a row whose support is one coordinate (its gradient is
  zero) and a row of ties.
- LearnWhen2Com and LearnWho2Com with ``sparse: true`` against the JAX
  models on shared weights in every inference mode (tests/test_torch_zoo.py's
  tolerances), their graphs sparse; and one train step of each against the
  JAX trainer's, through sparsemax's backward, with
  tests/test_torch_zoo_train.py's tolerances: loss rtol 1e-5, each gradient
  within relative L2 3e-2 and cosine 0.9995 (float32 chains of
  training-mode BatchNorms), parameters after the step atol 2*lr. 64x64
  frames, B=2, N=3, query 8, key 64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)
from test_torch_zoo import (
    assert_outputs_match,
    jax_forward,
    model_inputs,
    port_forward,
    port_model,
    raw_cfg,
    shared_variables,
)
from test_torch_zoo_train import LR, STATS, _jax_step, _port_step, _rel

from multiagentperception_tpu.ops.sparsemax import sparsemax as jax_sparsemax
from multiagentperception_tpu_torch.ops.sparsemax import sparsemax

B, N, IMG = 2, 3, 64
ATOL = 1e-6
# the general attention's projection scaled beyond test_torch_zoo's ATTN_SCALE, so
# its logits spread by more than 1 and sparsemax drops some links and keeps others
SHARPEN = 3.0


def _logits() -> np.ndarray:
    z = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32) * 1.5
    z[1] = [4.0, 0.1, 0.0, -1.0, 0.2, 0.3]  # one coordinate holds the whole mass
    z[2] = [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]  # ties: uniform
    z[3] = [1.0, 1.0, -3.0, -3.0, 0.2, 0.9]  # two tie at the top, some clipped
    return z


@pytest.mark.parametrize("axis", [-1, 0])
def test_sparsemax_forward_and_backward_match_jax(axis):
    z = _logits()
    g = np.random.default_rng(1).normal(size=z.shape).astype(np.float32)
    zt = torch.from_numpy(z).requires_grad_()
    out = sparsemax(zt, dim=axis)
    out.backward(torch.from_numpy(g))
    want, vjp = jax.vjp(lambda v: jax_sparsemax(v, axis), jnp.asarray(z))
    (want_grad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(out.detach().numpy() != 0, np.asarray(want) != 0)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want_grad), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.detach().sum(dim=axis).numpy(), 1.0, rtol=0, atol=1e-6)


def test_single_coordinate_support_has_zero_gradient():
    z = torch.tensor([[4.0, 0.1, 0.0, -1.0]], requires_grad=True)
    out = sparsemax(z, dim=-1)
    assert out.detach().tolist() == [[1.0, 0.0, 0.0, 0.0]]
    out.backward(torch.tensor([[0.7, -2.0, 3.0, 1.0]]))
    assert z.grad.abs().max() == 0  # g - mean(g over the support), on the support only


def test_sparsemax_keeps_bf16_and_computes_in_float32():
    z = torch.from_numpy(_logits()).bfloat16()
    out = sparsemax(z, dim=-1)
    assert out.dtype == torch.bfloat16
    want = sparsemax(z.float(), dim=-1).bfloat16()
    assert torch.equal(out, want)


# id: (arch, model keys, modes): every mode JAX accepts for the architecture
SPARSE_CASES = {
    "when2com-general": ("LearnWhen2Com", {"attention": "general"},
                         ("softmax", "argmax_test", "activated")),
    "when2com-additive": ("LearnWhen2Com", {"attention": "additive"}, ("activated",)),
    "who2com-scaled": ("LearnWho2Com", {"attention": "scaled", "key_size": 8},
                       ("softmax", "argmax_test")),
    "who2com-general": ("LearnWho2Com", {"attention": "general"}, ("softmax", "argmax_test")),
}


@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_sparse_attention_models_match_jax(case):
    arch, keys, modes = SPARSE_CASES[case]
    cfg = raw_cfg(arch, N, (IMG, IMG), sparse=True, shared_img_encoder="unified", **keys)
    x = model_inputs(cfg, (B, N, IMG, IMG, 3), seed=4)
    variables = shared_variables(cfg, x, seed=4)
    for dense in variables["params"].get("GeneralDotAttention_0", {}).values():
        dense["kernel"] = dense["kernel"] * SHARPEN
    model = port_model(cfg, variables)
    for mode in modes:
        want = jax_forward(cfg, variables, x, mode)
        got = port_forward(cfg, model, x, mode)
        assert_outputs_match(arch, mode, got, want)
        if case == "when2com-general":  # its graph is sparse: a real projection
            assert bool((got[1] == 0).any()) and bool((got[1] != 0).sum(2).gt(1).any())


@pytest.mark.parametrize("arch", ["LearnWhen2Com", "LearnWho2Com"])
def test_sparse_train_step_matches_jax(arch, monkeypatch):
    cfg = raw_cfg(arch, N, (IMG, IMG), sparse=True, shared_img_encoder="unified")
    cfg["training"] = {"batch_size": B, "optimizer": {"name": "adam", "lr": LR},
                       "loss": {"name": "cross_entropy", "size_average": True}}
    rng = np.random.default_rng(6)
    images = (rng.standard_normal((B, N, IMG, IMG, 3)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 11, (B, N, IMG, IMG)).astype(np.int32)
    variables = shared_variables(cfg, model_inputs(cfg, images.shape), seed=6, peaked=False)
    ref = _jax_step(cfg, variables, images, labels)
    port = _port_step(cfg, variables, images, labels, None, monkeypatch)

    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    # conv biases a training-mode BatchNorm follows have no gradient, nor has
    # key_net's last bias: sparsemax, as softmax, ignores a shift shared by all keys
    zero = {n for n in port["grads"] if n.endswith("cbr_unit.0.bias")} | {"key_net.fc.4.bias"}
    checked = 0
    for name, g in port["grads"].items():
        jg = torch.as_tensor(ref["grads"][name])
        if name in zero or not jg.any():
            assert max(g.norm(), jg.norm()) < 1e-4, name
            continue
        err = _rel(g, jg)
        cos = float(torch.nn.functional.cosine_similarity(
            g.double().flatten(), jg.double().flatten(), dim=0))
        assert err <= 3e-2 and cos >= 0.9995, f"{name}: relative L2 {err:.2e}, cos {cos:.6f}"
        checked += name.startswith(("query_net", "key_net", "attention_net"))
    assert checked > 0  # the graph's gradients went through sparsemax's backward
    for name, v in port["final"].items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-4, atol=1e-5) if name.endswith(STATS) else \
            dict(rtol=1e-4, atol=2 * LR)
        np.testing.assert_allclose(v.numpy(), ref["final"][name], err_msg=name, **tol)
