"""The port's MIMOcomWho, MIMO_All_agents, All_agents and Single_agent
against the JAX models on shared weights, every ``shuffle_features`` mode
and every inference mode; helpers, shapes and tolerances as in
tests/test_torch_zoo.py. The selection baselines draw their partners in
JAX; the port is handed the ids JAX returned (its ``rand_action``), since
the two generators cannot agree bit for bit.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_zoo import (
    IMG,
    B,
    N,
    assert_outputs_match,
    jax_forward,
    jax_rand_ids,
    model_inputs,
    port_forward,
    port_model,
    raw_cfg,
    shared_variables,
)
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

NONE = ("-",)  # architectures without inference modes
MRMS_CASES = {
    "who2com-query": ("MIMOcomWho", {}, ("softmax", "argmax_test", "activated")),
    "who2com-noquery": ("MIMOcomWho", {"query": False}, ("softmax", "argmax_test", "activated")),
    "mimo_all-catall": ("MIMO_All_agents", {"shuffle_features": "None"}, NONE),
    "mimo_all-selection": ("MIMO_All_agents", {"shuffle_features": "selection"}, NONE),
    "mimo_all-comnet": ("MIMO_All_agents", {"shuffle_features": "ComNet"}, NONE),
    "all-catall": ("All_agents", {"shuffle_features": "None"}, NONE),
    "all-fixed2": ("All_agents", {"shuffle_features": "fixed2"}, NONE),
    "all-selection": ("All_agents", {"shuffle_features": "selection"}, NONE),
    "single-folded": ("Single_agent", {}, NONE),
}


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(case_id):
        if case_id not in cache:
            arch, keys, _ = MRMS_CASES[case_id]
            cfg = raw_cfg(arch, **keys)
            x = model_inputs(cfg, (B, N, IMG, IMG, 3))
            variables = shared_variables(cfg, x)
            cache[case_id] = (cfg, x, variables, port_model(cfg, variables))
        return cache[case_id]

    return get


@pytest.mark.parametrize("case_id,mode", [
    pytest.param(cid, mode, id=f"{cid}-{mode}" if mode != "-" else cid)
    for cid, (_, _, modes) in MRMS_CASES.items() for mode in modes])
def test_mrms_forward_matches_jax(built, case_id, mode):
    cfg, x, variables, model = built(case_id)
    inference = "softmax" if mode == "-" else mode
    want = jax_forward(cfg, variables, x, inference)
    got = port_forward(cfg, model, x, inference, rand_ids=jax_rand_ids(cfg, want))
    assert_outputs_match(cfg["model"]["arch"], inference, got, want)


def test_who2com_graph_drops_the_diagonal(built):
    """MIMOcomWho's graph is exactly zero on the diagonal and keeps
    off-diagonal links in ``activated`` (bandwidth > 0)."""
    cfg, x, _, model = built("who2com-query")
    _, prob, _, nc = port_forward(cfg, model, x, "activated")
    assert torch.all(torch.diagonal(prob, dim1=1, dim2=2) == 0)
    assert float(nc) > 0


def test_selection_needs_host_ids(built):
    cfg, x, _, model = built("mimo_all-selection")
    with pytest.raises(ValueError, match="rand_ids"):
        port_forward(cfg, model, x, "softmax")
