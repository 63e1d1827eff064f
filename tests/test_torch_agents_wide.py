"""MIMOcom beyond 16 agents: the port against the JAX package on the CPU.

- The port's MIMOcom at N = 17 and 24 (query 8, key 64, 128x128, batch 1)
  on the JAX model's weights (``convert.state_dict_from_flax``) against the
  JAX model with its Pallas comm kernel off and on (interpret mode), in
  ``activated`` and ``argmax_test``, with tests/test_torch_model.py's
  tolerances: ``pred`` rtol 1e-3 / atol 2e-3, the graph 1e-5, actions and
  bandwidth exact. The graph's projection is scaled by PROJ_SCALE: at 1
  JAX's seeded logits at N = 17 are so sharp that the two frameworks'
  float32 towers part the graph by more than 1e-5; at 0.3 they stay within
  it and ``activated`` still keeps links (``num_connect`` > 0, asserted).
- K2's plain version against ``fused_comm_step`` (interpret) at N = 17,
  24, 33, 48, 64, 65 and 128 (the card's wide design has tile edges at 32
  and 64) in float32, bfloat16 and float16, on
  ``checks.wide_comm_inputs`` (a peaked graph, and keys repeated so the
  argmax ties): masks equal, graphs within 1e-6, fused within 1e-5 (16-bit:
  one ulp of the type + 1e-5).
- ``comm_fusion.plan`` names a design for every N up to 200 and refuses no
  agent count; ``upsample_argmax.plan`` stages fewer rows, or none, where
  16 rows of C x w floats exceed what a block holds (C x w beyond 768 needs
  more than the default 48 KB).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import _seeded_batch_stats, _to_numpy

from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.ops.pallas.comm_fusion import fused_comm_step
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.models import get_model
from multiagentperception_tpu_torch.ops.kernels import checks
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1

IMG = 128
AGENTS = (17, 24)
MODES = ("activated", "argmax_test")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
PROJ_SCALE = 0.3


def _raw_cfg(n: int, pallas_comm: bool) -> dict:
    return {"model": {"arch": "MIMOcom", "agent_num": n, "query_size": 8, "key_size": 64,
                      "multiple_output": True, "pallas_comm": pallas_comm},
            "data": {"img_rows": IMG, "img_cols": IMG, "commun_label": "mimo"}}


@pytest.fixture(scope="module", params=AGENTS, ids=[f"n{n}" for n in AGENTS])
def wide(request):
    """JAX's seeded weights (BatchNorm statistics seeded as in
    test_torch_model.py), one frame of N agents, and the port's model on
    those weights."""
    n = request.param
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((1, n, IMG, IMG, 3)) * 0.5).astype(np.float32)
    jm = jax_get_model(jax_normalize_config(_raw_cfg(n, False)), 11)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False, mo_flag=True,
                        inference="softmax")
    params = _to_numpy(variables["params"])
    proj = params["MIMOGeneralDotAttention_0"]["proj"]
    proj["kernel"] = proj["kernel"] * PROJ_SCALE
    variables = {"params": params,
                 "batch_stats": _seeded_batch_stats(_to_numpy(variables["batch_stats"]), rng)}
    cfg = normalize_config(_raw_cfg(n, True))
    model = get_model(cfg, 11)
    missing, unexpected = model.load_state_dict(state_dict_from_flax(cfg, variables),
                                                strict=True)
    assert not missing and not unexpected
    return n, x, variables, model.eval()


@pytest.mark.parametrize("pallas_comm", [False, True], ids=["plain", "fused_comm"])
@pytest.mark.parametrize("mode", MODES)
def test_wide_mimocom_matches_jax(wide, mode, pallas_comm):
    n, x, variables, model = wide
    jm = jax_get_model(jax_normalize_config(_raw_cfg(n, pallas_comm)), 11)
    j_pred, j_prob, j_act, j_nc = jm.apply(variables, jnp.asarray(x), train=False,
                                           mo_flag=True, inference=mode)
    with torch.inference_mode():
        t_pred, t_prob, t_act, t_nc = model(torch.from_numpy(x), inference=mode)
    np.testing.assert_allclose(t_pred.permute(0, 2, 3, 1).numpy(), np.asarray(j_pred),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(t_prob.numpy(), np.asarray(j_prob), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))
    assert float(t_nc) == float(j_nc)
    assert float(t_nc) > 0  # links survive: the pruned modes compare a real fusion


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [17, 24, 33, 48, 64, 65, 128])
def test_comm_fusion_plain_matches_pallas_beyond_16_agents(n, dtype):
    q, k, v = checks.wide_comm_inputs(torch.Generator().manual_seed(n), 1, n, 64, (2, 2, 8),
                                      DTYPES[dtype], "cpu")
    soft = k2.comm_fusion_plain(q, k, v)[2]
    assert bool(((soft == soft.amax(1, keepdim=True)).sum(1) > 1).any())  # argmax ties
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)) for t in (q, k, v))
    # the three modes' kernels in one compiled function (one compile a case)
    j_all = jax.jit(lambda *a: [fused_comm_step(*a, mode=mode, diag_bias=0.001, interpret=True)
                                for mode in k2.MODES])(jq, jk, jv)
    for mode, (j_fused, j_coef, j_soft) in zip(k2.MODES, j_all):
        fused, coef, soft = k2.comm_fusion_plain(q, k, v, mode=mode, diag_bias=0.001)
        np.testing.assert_array_equal(coef.numpy() != 0, np.asarray(j_coef) != 0)
        np.testing.assert_allclose(coef.numpy(), np.asarray(j_coef), rtol=0, atol=1e-6)
        np.testing.assert_allclose(soft.numpy(), np.asarray(j_soft), rtol=0, atol=1e-6)
        j_fused = torch.from_numpy(np.asarray(j_fused, np.float32))
        if dtype == "float32":
            np.testing.assert_allclose(fused.numpy(), j_fused.numpy(), rtol=0, atol=1e-5)
        else:
            checks.assert_within_ulp(fused, j_fused, checks.K2_ATOL, DTYPES[dtype])
        if mode == "activated":
            offdiag = (coef.numpy() != 0) & ~np.eye(n, dtype=bool)
            assert offdiag.any(axis=(1, 2)).all()


def test_comm_fusion_wide_check_on_the_plain_version():
    """The card's wide check (``checks.check_comm_fusion_wide``) runs here
    on the plain version: every mode, links kept, ties found."""
    errs = checks.check_comm_fusion_wide(torch.Generator().manual_seed(3), "cpu",
                                         agents=(17, 24), maps=((16, 2, 2), (40,)))
    assert set(errs) == {"17x64", "17x40", "24x64", "24x40"}
    assert max(errs.values()) < 1e-5


def test_repeatability_check_on_the_plain_version():
    """``checks.check_comm_fusion_repeatable`` (the card's same-bits check)
    runs here on the plain version, every mode, at two agent counts."""
    got = checks.check_comm_fusion_repeatable(torch.Generator().manual_seed(4), "cpu",
                                              torch.bfloat16, agents=(17, 33), rest=(16,))
    assert got == {17: 2 * len(k2.MODES), 33: 2 * len(k2.MODES)}


def test_float64_check_holds_and_rejects():
    """``checks.check_comm_fusion_against_float64`` passes the plain version
    where its logits are small (a spread of ~1), and rejects fused maps one
    part in 1e4 off and a graph 2e-6 off."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 24, 64, generator=g), torch.randn(2, 24, 64, generator=g) / 8,
               torch.randn(2, 24, 4, 8, generator=g))
    for mode in k2.MODES:
        assert checks.check_comm_fusion_against_float64(q, k, v, mode, 0.001) < 1e-5

    def off(scale_fused, shift_graph):
        def fn(*args):
            fused, coef, soft = k2.comm_fusion_plain(*args)
            return fused * scale_fused, coef, soft + shift_graph
        return fn

    for fn in (off(1 + 1e-4, 0.0), off(1.0, 2e-6)):
        with pytest.raises(AssertionError):
            checks.check_comm_fusion_against_float64(q, k, v, "softmax", 0.001, fn=fn)


def test_every_agent_count_check_on_the_plain_version():
    """``checks.check_comm_fusion_every_n`` at N = 1 .. 20 here (no design
    counted on the CPU: the plain version launches nothing)."""
    got = checks.check_comm_fusion_every_n(torch.Generator().manual_seed(4), "cpu",
                                           agents=range(1, 21), d=64, m=8)
    assert got["designs"] == {"cluster": 0, "wide": 0}


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_names_a_design_for_every_agent_count(dtype):
    t = DTYPES[dtype]
    pack = k2.ROUTES[t][2]
    for n in range(1, 201):
        assert k2.plan(2, n, 1024, 512 * 64, t) == ("cluster" if n <= 16 else "wide")
    assert k2.plan(1, 10_000, 64, pack, t) == "wide"
    with pytest.raises(ValueError, match=f"M % {pack}"):
        k2.plan(2, 24, 1024, pack + 2, t)
    for bad in ((0, 24, 1024, 64), (2, 0, 1024, 64), (2, 24, 0, 64), (70_000, 24, 1024, 64)):
        with pytest.raises(ValueError, match="unsupported"):
            k2.plan(*bad, t)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        k2.plan(2, 24, 1024, 64, torch.float64)


@pytest.mark.parametrize("c,w,rows", [
    (11, 16, 16), (11, 69, 16), (11, 70, 16), (11, 96, 16), (32, 32, 16), (1, 3628, 16),
    (1, 3629, 8), (11, 660, 8), (11, 1320, 4), (11, 2640, 2), (11, 5282, 1), (1, 58108, 1),
    (1, 58109, 0), (64, 1024, 0)])
def test_upsample_argmax_plan_stages_what_fits(c, w, rows):
    """Beyond C x w = 768 sixteen rows exceed the default 48 KB and the
    block opts in to more; rows halve where 227 KB does not hold them, and
    the direct kernel (0) takes logits one row of which does not fit."""
    assert k1.plan(c, w) == rows
    if rows:
        assert rows * (c * w * 4 + 16) <= k1.SHARED_OPTIN
    if rows != 16:
        assert (2 * rows or 1) * (c * w * 4 + 16) > k1.SHARED_OPTIN


def test_comm_fusion_cpu_takes_any_agent_count():
    """On CPU tensors the wrapper runs the plain version at any N and
    counts no launch, of any design."""
    q, k, v = checks.wide_comm_inputs(torch.Generator().manual_seed(5), 2, 33, 64, (8,),
                                      torch.float32, "cpu")
    before = (k2.comm_fusion.launches, dict(k2.comm_fusion.design_launches))
    got = k2.comm_fusion(q, k, v, mode="argmax", diag_bias=0.001)
    want = k2.comm_fusion_plain(q, k, v, mode="argmax", diag_bias=0.001)
    assert (k2.comm_fusion.launches, dict(k2.comm_fusion.design_launches)) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
