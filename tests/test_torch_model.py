"""The port's MIMOcom eval forward against the JAX MIMOcom on shared weights.

256x256 input so the policy map is 2x2 and the key/query MLPs' HWC->CHW
flatten permutation is exercised (at 128 the map is 1x1 and hides it).
BatchNorm statistics are replaced by seeded non-trivial ones so the
eval-mode normalization really runs. Tolerances: ``pred`` rtol 1e-3 /
atol 2e-3 (deep conv stacks summed in another order, as in
tests/test_parity.py); ``prob_action`` 1e-5; ``action`` and
``num_connect`` exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu_torch.config import normalize_config
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.models import get_model

B, N, IMG = 2, 3, 256
MODES = ("softmax", "argmax_test", "activated")
PROJ_SCALE = 0.01


def _raw_cfg(pallas_comm: bool) -> dict:
    return {
        "model": {"arch": "MIMOcom", "agent_num": N, "query_size": 8,
                  "key_size": 64, "multiple_output": True,
                  "pallas_comm": pallas_comm},
        "data": {"img_rows": IMG, "img_cols": IMG, "commun_label": "mimo"},
    }


def _seeded_batch_stats(tree, rng):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            if k == "mean":
                out[k] = (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
            else:
                out[k] = _seeded_batch_stats(v, rng)
        return out
    return tree


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, N, IMG, IMG, 3)) * 0.5).astype(np.float32)
    jm = jax_get_model(jax_normalize_config(_raw_cfg(False)), 11)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False,
                        mo_flag=True, inference="softmax")
    params = _to_numpy(variables["params"])
    proj = params["MIMOGeneralDotAttention_0"]["proj"]
    proj["kernel"] = proj["kernel"] * PROJ_SCALE
    variables = {"params": params,
                 "batch_stats": _seeded_batch_stats(
                     _to_numpy(variables["batch_stats"]), rng)}
    return x, variables


@pytest.fixture(scope="module")
def port_model(shared):
    """One port model for both ``pallas_comm`` settings: the port takes the
    option and ignores it (its pruned modes always run the fused step)."""
    _, variables = shared
    cfg = normalize_config(_raw_cfg(True))
    model = get_model(cfg, 11)
    missing, unexpected = model.load_state_dict(
        state_dict_from_flax(cfg, variables), strict=True)
    assert not missing and not unexpected
    return model.eval()


def test_state_dict_keys_are_the_reference_names(port_model):
    keys = set(port_model.state_dict())
    for key in ("u_encoder.feature_backbone.feature_backbone.conv1.weight",
                "u_encoder.feature_backbone.feature_backbone.layer2.0.downsample.1.running_var",
                "u_encoder.squeezer.cbr_unit.0.bias",
                "query_key_net.img_encoder.feature_backbone.feature_backbone.bn1.weight",
                "query_key_net.conv5.cbr_unit.1.running_mean",
                "key_net.fc.0.weight", "key_net.fc.4.bias", "query_net.fc.2.weight",
                "attention_net.linear.weight", "decoder.output_decoder.pred.2.weight"):
        assert key in keys


@pytest.mark.parametrize("pallas_comm", [False, True], ids=["plain", "fused_comm"])
@pytest.mark.parametrize("mode", MODES)
def test_eval_forward_matches_jax(shared, port_model, mode, pallas_comm):
    """The JAX model with its Pallas comm kernel off and on (interpret mode
    on the CPU) against the one port model."""
    x, variables = shared
    jm = jax_get_model(jax_normalize_config(_raw_cfg(pallas_comm)), 11)
    j_pred, j_prob, j_act, j_nc = jm.apply(
        variables, jnp.asarray(x), train=False, mo_flag=True, inference=mode)
    with torch.inference_mode():
        t_pred, t_prob, t_act, t_nc = port_model(torch.from_numpy(x), inference=mode)
    np.testing.assert_allclose(t_pred.permute(0, 2, 3, 1).numpy(), np.asarray(j_pred),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(t_prob.numpy(), np.asarray(j_prob), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))
    assert float(t_nc) == float(j_nc)


def test_graph_keeps_links(shared, port_model):
    """The shared weights give a graph that `activated` does not prune to
    nothing, so the pruned modes above compare a real fusion."""
    x, _ = shared
    with torch.inference_mode():
        _, _, _, nc = port_model(torch.from_numpy(x), inference="activated")
    assert float(nc) > 0


def test_pre_upsample_logits(shared, port_model):
    """full_res=False returns the decoder's logits at 1/32, whose bilinear
    x32 resize is the full-resolution prediction."""
    from multiagentperception_tpu_torch.ops.resize import bilinear_resize

    x, _ = shared
    model = port_model
    with torch.inference_mode():
        full = model(torch.from_numpy(x), inference="activated")[0]
        pre = model(torch.from_numpy(x), inference="activated", full_res=False)[0]
    assert pre.shape == (B * N, 11, IMG // 32, IMG // 32)
    torch.testing.assert_close(bilinear_resize(pre, IMG, IMG), full, rtol=0, atol=0)


def test_training_forward_refused(port_model):
    """The training forward is the soft fusion: it refuses the pruned eval
    modes (the JAX model would quietly run the soft fusion for them), and
    runs ``softmax``."""
    model = port_model
    model.train()
    try:
        with pytest.raises(ValueError, match="soft fusion"):
            model(torch.zeros(1, N, IMG, IMG, 3), inference="activated")
        pred = model(torch.zeros(1, N, IMG, IMG, 3), inference="softmax")[0]
        assert pred.shape == (N, 11, IMG, IMG) and pred.requires_grad
    finally:
        model.eval()
