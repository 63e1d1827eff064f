"""Mixed precision in the port: the config keys, the dtypes a bf16 model
keeps and returns, the float32 program left as it was, and the plain
versions of K1 and K2 on bf16 inputs against the JAX package's Pallas
kernels (interpret mode, as the JAX tests run them).

Tolerances: K1's class maps exactly equal (both upcast the bf16 logits
and resize in float32 with the same weights, strict-``>`` argmax). K2 on
bf16 Q', K and V: ``coef`` and ``soft`` within 1e-6 (float32 graphs from
the same upcast inputs) and masks equal; ``fused`` within one bf16 ulp of
the larger value plus 1e-5 (``checks.assert_within_ulp``: two
float32 sums of the same products in another order, each rounded once to
bf16; the 1e-5 covers sums that cancel to near zero, as K2's float32
tolerance does). The models' bf16 forwards against JAX are in
tests/test_torch_mixed_precision_models.py, the CLIs in
tests/test_torch_mixed_precision_cli.py.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu.ops.pallas.comm_fusion import fused_comm_step
from multiagentperception_tpu.ops.pallas.upsample_argmax import upsample_argmax_pallas
from multiagentperception_tpu_torch.config import load_config, normalize_config
from multiagentperception_tpu_torch.models import compute_dtype, get_model, init_weights
from multiagentperception_tpu_torch.models.blocks import Conv2d, Linear
from multiagentperception_tpu_torch.ops.kernels import checks
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

MODES = ("softmax", "activated", "argmax")
ARCHS = ("Single_agent", "All_agents", "MIMO_All_agents", "LearnWho2Com",
         "LearnWhen2Com", "MIMOcom", "MIMOcomWho")
IMG = 64


def _cfg(arch="MIMOcom", dtype=None, mixed=None, agents=3) -> dict:
    model = {"arch": arch, "agent_num": agents, "query_size": 8, "key_size": 64,
             "multiple_output": arch in ("MIMOcom", "MIMOcomWho", "MIMO_All_agents",
                                         "Single_agent")}
    if dtype is not None:
        model["dtype"] = dtype
    cfg = {"model": model, "data": {"img_rows": IMG, "img_cols": IMG}}
    if mixed is not None:
        cfg["training"] = {"mixed_precision": mixed}
    return normalize_config(cfg)


def _typed(a: np.ndarray, dtype: str = "bfloat16") -> tuple[torch.Tensor, jnp.ndarray]:
    """The same ``dtype`` (bfloat16 or float16) values as a torch tensor and
    a JAX array."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


# ----------------------------------------------------------------- config

@pytest.mark.parametrize("dtype,mixed,want", [
    (None, None, None), ("float32", None, None), ("None", True, None),
    ("bfloat16", None, torch.bfloat16), (None, True, torch.bfloat16),
    ("bfloat16", False, torch.bfloat16), ("float32", True, None)],
    ids=["unset", "float32", "None-mixed", "bfloat16", "mixed", "bfloat16-not_mixed",
         "float32-mixed"])
def test_compute_dtype_follows_jax(dtype, mixed, want):
    """``model.dtype`` wins; ``training.mixed_precision`` means bfloat16 only
    where ``model.dtype`` is unset (JAX models/__init__.py:57-66)."""
    assert compute_dtype(_cfg(dtype=dtype, mixed=mixed)) is want


def test_float16_is_refused_by_name():
    """Named for the refusal it once held: ``model.dtype: float16`` maps to
    ``torch.float16`` (JAX models/__init__.py:57-66) and builds a flagship
    that computes in float16: float16 predictions, a float32 graph and
    bandwidth, float32 parameters."""
    cfg = _cfg(dtype="float16")
    assert compute_dtype(cfg) is torch.float16
    model = init_weights(get_model(cfg, 11), 0).eval()
    assert all(v.dtype == torch.float32 for v in model.state_dict().values()
               if v.is_floating_point())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, IMG, IMG, 3)).astype(np.float32))
    with torch.inference_mode():
        pred, prob, action, nc = model(x, inference="activated")
    assert pred.dtype == torch.float16 and pred.shape == (3, 11, IMG, IMG)
    assert bool(torch.isfinite(pred).all())
    assert prob.dtype == torch.float32 and nc.dtype == torch.float32


def test_unknown_dtype_raises():
    with pytest.raises(KeyError, match="model.dtype"):
        get_model(_cfg(dtype="int8"), 11)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_keeps_float32_parameters(arch):
    """Every parameter and BatchNorm buffer stays float32 and every conv
    and linear layer computes in bf16, for each architecture and for both
    config keys."""
    for cfg in (_cfg(arch, dtype="bfloat16"), _cfg(arch, mixed=True)):
        model = get_model(cfg, 11)
        floats = [v for v in model.state_dict().values() if v.is_floating_point()]
        assert floats and all(v.dtype == torch.float32 for v in floats)
        layers = [m for m in model.modules() if isinstance(m, (Conv2d, Linear))]
        assert layers and all(m.compute_dtype is torch.bfloat16 for m in layers)
        assert not any(type(m) in (torch.nn.Conv2d, torch.nn.Linear) for m in model.modules())


YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*-*/*.yml"))


@pytest.mark.parametrize("yml", YAMLS, ids=lambda p: p.stem)
def test_every_reference_yaml_builds_in_bf16(yml):
    """Each of the ten reference YAMLs with ``model.dtype: bfloat16``, as
    ``chip_smoke.py`` phase 8 runs them: a port model at the YAML's own
    size whose layers compute in bf16 and whose tensors stay float32."""
    cfg = load_config(str(yml))
    cfg["model"]["dtype"] = "bfloat16"
    model = get_model(cfg, 11)
    assert {m.compute_dtype for m in model.modules()
            if isinstance(m, (Conv2d, Linear))} == {torch.bfloat16}
    assert all(v.dtype == torch.float32 for v in model.state_dict().values()
               if v.is_floating_point())


def test_flagship_bf16_outputs_dtypes():
    """bf16 predictions, a float32 graph and float32 bandwidth in every
    mode, as tests/test_mixed_precision.py:26-37 asserts for JAX."""
    model = init_weights(get_model(_cfg(mixed=True), 11), 0).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, IMG, IMG, 3)).astype(np.float32))
    with torch.inference_mode():
        for mode in ("softmax", "argmax_test", "activated"):
            pred, prob, action, nc = model(x, inference=mode)
            assert pred.dtype == torch.bfloat16 and pred.shape == (6, 11, IMG, IMG)
            assert prob.dtype == torch.float32 and nc.dtype == torch.float32
            assert action.dtype == torch.int64
            pre = model(x, inference=mode, full_res=False)[0]
            assert pre.dtype == torch.bfloat16 and pre.shape == (6, 11, IMG // 32, IMG // 32)


def test_float32_forward_is_the_plain_torch_program():
    """With no compute dtype, every ``Conv2d`` / ``Linear`` runs
    ``nn.Conv2d`` / ``nn.Linear``'s own forward: the flagship's float32
    outputs equal, bit for bit, those of the model with the base classes'
    forwards swapped in, in every mode (the float32 program before mixed
    precision was ported)."""
    model = init_weights(get_model(_cfg(), 11), 0).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, IMG, IMG, 3)).astype(np.float32))
    with torch.inference_mode():
        got = {m: model(x, inference=m) for m in ("softmax", "argmax_test", "activated")}
    saved = Conv2d.forward, Linear.forward
    Conv2d.forward, Linear.forward = torch.nn.Conv2d.forward, torch.nn.Linear.forward
    try:
        with torch.inference_mode():
            want = {m: model(x, inference=m) for m in got}
    finally:
        Conv2d.forward, Linear.forward = saved
    for mode in got:
        for a, b in zip(got[mode], want[mode]):
            assert a.dtype == b.dtype and torch.equal(a, b), mode
    assert got["softmax"][0].dtype == torch.float32


def test_bf16_train_forward_gives_float32_gradients():
    """The training forward in bf16: the loss is float32 and every
    parameter's gradient is float32 (the optimizer steps float32)."""
    from multiagentperception_tpu_torch.loss import cross_entropy2d

    model = init_weights(get_model(_cfg(mixed=True), 11), 0).train()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 3, IMG, IMG, 3)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(3).integers(0, 11, (3, IMG, IMG)))
    pred = model(x, inference="softmax")[0]
    loss = cross_entropy2d(pred, y)
    assert pred.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.requires_grad]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)
    assert all(torch.isfinite(g).all() for g in grads)
    stats = [v for k, v in model.state_dict().items() if k.endswith("running_var")]
    assert all(v.dtype == torch.float32 for v in stats)


@pytest.mark.parametrize("hw,stride", [(1, 2), (2, 2), (4, 1)])
def test_cpu_bf16_conv_is_the_float32_conv_of_rounded_operands(hw, stride):
    """On the CPU a bf16 ``Conv2d`` is the float32 convolution of the
    bf16-rounded input and weights, rounded once, forward and backward, at
    every shape: also at a 1x1 input at stride 2, where oneDNN's bf16
    weight gradient is wrong (the policy tower's ``conv5`` below 128x128)."""
    gen = torch.Generator().manual_seed(hw)
    conv = Conv2d(64, 64, 3, stride, 1, bias=True, compute_dtype=torch.bfloat16)
    ref = torch.nn.Conv2d(64, 64, 3, stride, 1, bias=True)
    with torch.no_grad():
        for p in (conv.weight, conv.bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        ref.weight.copy_(conv.weight.bfloat16().float())
        ref.bias.copy_(conv.bias.bfloat16().float())
    x = torch.randn(3, 64, hw, hw, generator=gen)
    y = conv(x)
    want = ref(x.bfloat16().float()).bfloat16()
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)
    go = torch.randn(y.shape, generator=gen).bfloat16()
    y.backward(go)
    want.float().backward(go.float())
    assert conv.weight.grad.dtype == torch.float32
    assert bool(torch.isfinite(conv.weight.grad).all())
    torch.testing.assert_close(conv.weight.grad, ref.weight.grad.bfloat16().float(),
                               rtol=0, atol=0)


# ----------------------------------------------------------------- K1

def k1_against_pallas(tie: bool, dtype: str) -> None:
    """K1's plain version on ``dtype`` logits against the Pallas kernel in
    interpret mode on the same values: class maps exactly equal."""
    x = np.ones((3, 4, 4, 11), np.float32) if tie else \
        np.random.default_rng(0).standard_normal((3, 4, 4, 11)).astype(np.float32)
    xt, xj = _typed(x, dtype)
    want = np.asarray(upsample_argmax_pallas(xj, 128, 128, interpret=True))
    got = k1.upsample_argmax_plain(xt.permute(0, 3, 1, 2), 128, 128)
    assert got.dtype == torch.int32 and got.shape == (3, 128, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    if tie:
        assert not got.any()


@pytest.mark.parametrize("tie", [False, True], ids=["random", "all_tied"])
def test_upsample_argmax_plain_bf16_matches_pallas(tie):
    k1_against_pallas(tie, "bfloat16")


def test_upsample_argmax_cpu_bf16_runs_plain():
    x = torch.randn(2, 11, 4, 4, generator=torch.Generator().manual_seed(0)).bfloat16()
    before = dict(k1.upsample_argmax.route_launches)
    got = k1.upsample_argmax(x, 64, 64)
    assert k1.upsample_argmax.route_launches == before
    assert torch.equal(got, k1.upsample_argmax_plain(x.float(), 64, 64))


# ----------------------------------------------------------------- K2

def _comm_inputs(b=2, n=6, d=64, seed=1, dtype="bfloat16"):
    """``dtype`` Q', K and (B, N, h, w, C) V; the keys' scale gives logits
    with a spread of about 2, so ``activated`` keeps off-diagonal links."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, d)).astype(np.float32)
    k = (rng.standard_normal((b, n, d)) * 2 / np.sqrt(d)).astype(np.float32)
    v = rng.standard_normal((b, n, 4, 4, 8)).astype(np.float32)
    return _typed(q, dtype), _typed(k, dtype), _typed(v, dtype)


def k2_against_pallas(mode: str, n: int, dtype: str) -> None:
    """K2's plain version on ``dtype`` Q', K and V against the Pallas kernel
    in interpret mode (module docstring's tolerances, the ulp of ``dtype``)."""
    (qt, qj), (kt, kj), (vt, vj) = _comm_inputs(n=n, dtype=dtype)
    j_fused, j_coef, j_soft = fused_comm_step(qj, kj, vj, mode=mode, diag_bias=0.001,
                                              interpret=True)
    fused, coef, soft = k2.comm_fusion_plain(qt, kt, vt, mode=mode, diag_bias=0.001)
    assert fused.dtype == getattr(torch, dtype) and j_fused.dtype == getattr(jnp, dtype)
    assert coef.dtype == soft.dtype == torch.float32
    np.testing.assert_array_equal(coef.numpy() != 0, np.asarray(j_coef) != 0)
    np.testing.assert_allclose(coef.numpy(), np.asarray(j_coef), rtol=0, atol=1e-6)
    np.testing.assert_allclose(soft.numpy(), np.asarray(j_soft), rtol=0, atol=1e-6)
    checks.assert_within_ulp(fused, torch.from_numpy(np.asarray(j_fused, np.float32)),
                             checks.K2_ATOL, getattr(torch, dtype))
    if mode == "activated":
        offdiag = (coef.numpy() != 0) & ~np.eye(n, dtype=bool)
        assert offdiag.any(axis=(1, 2)).all()


@pytest.mark.parametrize("n", [3, 6])
@pytest.mark.parametrize("mode", MODES)
def test_comm_fusion_plain_bf16_matches_pallas(mode, n):
    k2_against_pallas(mode, n, "bfloat16")


@pytest.mark.parametrize("mode", MODES)
def test_comm_fusion_plain_bf16_upcasts_first(mode):
    """The repair of K2's plain version: on bf16 inputs it is the float32
    function of the upcast inputs, with ``fused`` rounded once to bf16 and
    ``coef`` / ``soft`` exactly the float32 ones. The plain version before
    the repair took the logits as a bf16 product and fused with a bf16
    ``coef``, which this test and the Pallas comparison above both catch."""
    (qt, _), (kt, _), (vt, _) = _comm_inputs(seed=5)
    fused, coef, soft = k2.comm_fusion_plain(qt, kt, vt, mode=mode, diag_bias=0.001)
    f_fused, f_coef, f_soft = k2.comm_fusion_plain(qt.float(), kt.float(), vt.float(),
                                                   mode=mode, diag_bias=0.001)
    assert torch.equal(coef, f_coef) and torch.equal(soft, f_soft)
    assert torch.equal(fused, f_fused.to(torch.bfloat16))


def test_comm_fusion_cpu_bf16_runs_plain():
    (qt, _), (kt, _), (vt, _) = _comm_inputs()
    before = dict(k2.comm_fusion.route_launches)
    got = k2.comm_fusion(qt, kt, vt, mode="activated", diag_bias=0.001)
    want = k2.comm_fusion_plain(qt, kt, vt, mode="activated", diag_bias=0.001)
    assert k2.comm_fusion.route_launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
