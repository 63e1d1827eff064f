"""The port's zoo against the JAX models on shared weights: the SRMS
comm models here (LearnWho2Com, LearnWhen2Com), the MRMS ones and the
fusion baselines in tests/test_torch_zoo_mrms.py, image sides that are not
multiples of 128 in tests/test_torch_zoo_size.py. The helpers here serve
every ``test_torch_zoo*`` file.

256x256 inputs, so the policy map is 2x2 and the key/query MLPs'
HWC->CHW flatten permutation runs; query_size 8, key_size 64 (the scaled
attention, which dots a query with the keys, takes key_size 8); B=2, N=3.
Weights come from the JAX model's init with seeded non-trivial BatchNorm
statistics, through ``convert.state_dict_from_flax`` with ``strict=True``.
The attention weights are scaled up so the graphs are peaked: ``activated``
keeps some links and drops others. Each case builds one JAX model and one
port model (module-scoped) and compares every inference mode it has.

Tolerances: ``pred`` rtol 1e-3 / atol 2e-3 (deep conv stacks summed in
another order, as in tests/test_torch_model.py); graphs and LearnWhen2Com's
thresholded row 1e-5 (and the row's zero pattern exact); actions and
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
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

B, N, IMG = 2, 3, 256
MRMS = {"MIMOcom", "MIMOcomWho", "MIMO_All_agents"}
COMM = {"MIMOcom", "MIMOcomWho", "LearnWho2Com", "LearnWhen2Com"}
SELECTION = {"All_agents", "MIMO_All_agents"}
ATTN_SCALE = 20.0  # the attention's last weights: a peaked graph


def raw_cfg(arch: str, agents: int = N, img=(IMG, IMG), **model) -> dict:
    return {
        "model": {"arch": arch, "agent_num": agents, "query_size": 8, "key_size": 64,
                  "multiple_output": arch in MRMS or arch == "Single_agent", **model},
        "data": {"img_rows": img[0], "img_cols": img[1]},
    }


def jax_kwargs(cfg: dict, train: bool, inference: str = "softmax") -> dict:
    """The JAX trainer's forward arguments (trainer.py:248-256)."""
    arch, kw = cfg["model"]["arch"], {"train": train}
    if arch in ("MIMOcom", "MIMOcomWho"):
        kw["mo_flag"] = bool(cfg["model"]["multiple_output"])
    if arch in COMM:
        kw["inference"] = inference
    return kw


def seeded_stats(tree, rng):
    if "mean" in tree:
        return {"mean": (rng.standard_normal(tree["mean"].shape) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, tree["var"].shape).astype(np.float32)}
    return {k: seeded_stats(v, rng) for k, v in tree.items()}


def _scale_attention(params) -> None:
    for name in ("GeneralDotAttention_0", "MIMOWhoGeneralDotAttention_0",
                 "MIMOGeneralDotAttention_0", "AdditiveAttention_0"):
        if name in params:
            dense = params[name]
            last = dense["proj"] if "proj" in dense else dense[sorted(dense)[-1]]
            last["kernel"] = last["kernel"] * ATTN_SCALE


def model_inputs(cfg: dict, shape, seed: int = 0) -> np.ndarray:
    """Seeded frames in the model's input layout (Single_agent: folded views)."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)
    return x.reshape((-1,) + x.shape[2:]) if cfg["model"]["arch"] == "Single_agent" else x


def shared_variables(cfg: dict, x: np.ndarray, seed: int = 0,
                     peaked: bool = True) -> dict:
    """JAX-initialized weights with seeded BatchNorm statistics; ``peaked``
    scales the attention's last weights by ATTN_SCALE."""
    jm = jax_get_model(jax_normalize_config(cfg), 11)
    rngs = {"params": jax.random.PRNGKey(seed), "action": jax.random.PRNGKey(seed + 1)}
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(rngs, jnp.asarray(x), **jax_kwargs(cfg, False)))
    params = variables["params"]
    if peaked:
        _scale_attention(params)
    return {"params": params,
            "batch_stats": seeded_stats(variables["batch_stats"],
                                        np.random.default_rng(seed + 100))}


def port_model(cfg: dict, variables: dict) -> torch.nn.Module:
    cfg = normalize_config(cfg)
    model = get_model(cfg, 11)
    model.load_state_dict(state_dict_from_flax(cfg, variables), strict=True)
    return model.eval()


def jax_forward(cfg: dict, variables: dict, x: np.ndarray, inference: str, seed: int = 7):
    jm = jax_get_model(jax_normalize_config(cfg), 11)
    out = jm.apply(variables, jnp.asarray(x), rngs={"action": jax.random.PRNGKey(seed)},
                   **jax_kwargs(cfg, False, inference))
    return jax.tree_util.tree_map(np.asarray, out)


def port_forward(cfg: dict, model, x: np.ndarray, inference: str, rand_ids=None):
    kw = {"inference": inference} if cfg["model"]["arch"] in COMM else {}
    if rand_ids is not None:
        kw["rand_ids"] = torch.from_numpy(np.asarray(rand_ids, np.int64))
    with torch.inference_mode():
        out = model(torch.from_numpy(x), **kw)
    return out if isinstance(out, tuple) else (out,)


def jax_rand_ids(cfg: dict, out) -> np.ndarray | None:
    """The partners the JAX selection forward drew, as the port's ``rand_ids``."""
    arch, m = cfg["model"]["arch"], cfg["model"]
    if arch not in SELECTION or m.get("shuffle_features") != "selection":
        return None
    return np.array(out[1][0])  # All_agents: the supporter; MIMO: (N,) partners


def assert_outputs_match(arch: str, inference: str, got, want) -> None:
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), want[0],
                               rtol=1e-3, atol=2e-3)
    if len(want) == 2:  # selection: the partners
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        return
    if len(want) > 1:
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-5)
        if arch == "LearnWhen2Com" and inference == "activated":  # the thresholded row
            np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got[2].numpy() != 0, want[2] != 0)
        else:
            np.testing.assert_array_equal(got[2].numpy(), want[2])
    if len(want) > 3:
        assert float(got[3]) == float(want[3])


SRMS_CASES = {  # id: (arch, model keys, inference modes): each encoder mode,
    # attention and query setting once
    "who2com-unified-general": ("LearnWho2Com", {"shared_img_encoder": "unified"},
                                ("softmax", "argmax_test")),
    "who2com-only_normal-additive-noquery": (
        "LearnWho2Com", {"shared_img_encoder": "only_normal_agents", "attention": "additive",
                         "query": False}, ("softmax", "argmax_test")),
    "who2com-separate-scaled": (
        "LearnWho2Com", {"shared_img_encoder": "separate", "attention": "scaled",
                         "key_size": 8}, ("softmax", "argmax_test")),
    "when2com-unified-general": ("LearnWhen2Com", {"shared_img_encoder": "unified"},
                                 ("softmax", "argmax_test", "activated")),
    "when2com-only_normal-scaled-noquery": (
        "LearnWhen2Com", {"shared_img_encoder": "only_normal_agents", "attention": "scaled",
                          "key_size": 8, "query": False},
        ("softmax", "argmax_test", "activated")),
    "when2com-separate-additive": (
        "LearnWhen2Com", {"shared_img_encoder": "separate", "attention": "additive"},
        ("softmax", "argmax_test", "activated")),
}


@pytest.fixture(scope="module")
def built():
    """One JAX init and one port model per case, on first use."""
    cache = {}

    def get(case_id, cases):
        if case_id not in cache:
            arch, keys, _ = cases[case_id]
            cfg = raw_cfg(arch, **keys)
            x = model_inputs(cfg, (B, N, IMG, IMG, 3))
            variables = shared_variables(cfg, x)
            cache[case_id] = (cfg, x, variables, port_model(cfg, variables))
        return cache[case_id]

    return get


def _params(cases):
    return [pytest.param(cid, mode, id=f"{cid}-{mode}")
            for cid, (_, _, modes) in cases.items() for mode in modes]


@pytest.mark.parametrize("case_id,mode", _params(SRMS_CASES))
def test_srms_forward_matches_jax(built, case_id, mode):
    cfg, x, variables, model = built(case_id, SRMS_CASES)
    want = jax_forward(cfg, variables, x, mode)
    got = port_forward(cfg, model, x, mode)
    assert_outputs_match(cfg["model"]["arch"], mode, got, want)


def test_srms_graphs_are_peaked(built):
    """The shared weights make ``activated`` keep some links and drop
    others, and ``argmax_test`` pick a supporter somewhere, so the pruned
    modes above compare real selections."""
    cfg, x, _, model = built("when2com-unified-general", SRMS_CASES)
    _, prob, act, nc = port_forward(cfg, model, x, "activated")
    assert 0 < int((act != 0).sum()) < act.numel()
    _, _, action, nc_argmax = port_forward(cfg, model, x, "argmax_test")
    assert 0.0 <= float(nc_argmax) <= 1.0 and float(nc) >= 0.0
