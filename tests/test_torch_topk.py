"""MIMOcom's bandwidth-constrained ``topk`` eval and its single-query and
query-free variants against the JAX package, on the CPU.

- ``topk_select`` and ``per_frame_links(..., "topk")`` against
  ops/comm.py on diagonal-biased graphs, with a constructed tie: JAX keeps
  every key tied with the k-th strongest (``pq >= kth``), so a tie keeps
  more than k links, and so must the port. Graphs to 1e-6, the fused maps
  to 1e-6 (relative), bandwidth equal.
- MIMOcom in ``topk`` (k 1 and 2), and with ``query: false`` and
  ``multiple_output: false`` in every mode JAX accepts for it, against the
  JAX model on shared weights (tests/test_torch_zoo.py's helpers and
  tolerances: ``pred`` rtol 1e-3 / atol 2e-3, graphs 1e-5, actions and
  bandwidth exact); 64x64 frames, query 8, key 64, 3 agents.
- ``python -m multiagentperception_tpu_torch.test --device cpu`` on
  configs/extensions/mrms_when2com_topk.yml over a 64x64 fixture, and the
  serving export of that YAML's model in ``topk`` against JAX's
  ``make_eval_fn``.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_train import drop_files, few_threads  # noqa: F401 (autouse fixtures)
from test_torch_zoo_configs import _builds_and_loads_bridged_weights
from test_torch_zoo import (
    assert_outputs_match,
    jax_forward,
    model_inputs,
    port_forward,
    port_model,
    raw_cfg,
    shared_variables,
)

from multiagentperception_tpu.config import load_config as jax_load_config
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.data.synthetic import generate_fixture
from multiagentperception_tpu.export import make_eval_fn as jax_make_eval_fn
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu.ops.comm import per_frame_links as jax_per_frame_links
from multiagentperception_tpu.ops.comm import topk_select as jax_topk_select
from multiagentperception_tpu_torch import test as port_cli
from multiagentperception_tpu_torch.config import load_config, normalize_config
from multiagentperception_tpu_torch.export import export_serving, load_serving, make_eval_fn
from multiagentperception_tpu_torch.models import get_model, init_weights
from multiagentperception_tpu_torch.ops.comm import (
    num_connect_offdiag,
    per_frame_links,
    topk_select,
)

ROOT = Path(__file__).resolve().parents[1]
TOPK_YAML = ROOT / "configs" / "extensions" / "mrms_when2com_topk.yml"
IMG, N = 64, 3
GRAPH_ATOL = 1e-6


def _graph(seed: int, b: int = 4, n: int = 6) -> np.ndarray:
    """A softmax graph over keys, diagonal-biased as MIMOcom's (+0.001 I)."""
    logits = np.random.default_rng(seed).normal(size=(b, n, n)).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    return (prob + 0.001 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _tied_graph() -> np.ndarray:
    """Sample 0: every query's keys tie in pairs (0.3, 0.3, 0.2, 0.2); sample
    1: three keys tie with the strongest of query 0. Columns are queries."""
    g = np.zeros((2, 4, 4), np.float32)
    g[0] = np.array([0.3, 0.3, 0.2, 0.2], np.float32)[:, None]
    g[1] = np.array([[0.25, 0.1, 0.4, 0.3], [0.25, 0.1, 0.3, 0.3],
                     [0.25, 0.7, 0.2, 0.2], [0.25, 0.1, 0.1, 0.2]], np.float32)
    return g


GRAPHS = {"random_6": _graph(0), "random_6_b": _graph(1), "tied": _tied_graph()}


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_topk_select_matches_jax(graph, k):
    prob = GRAPHS[graph]
    b, n = prob.shape[:2]
    vals = np.random.default_rng(k).normal(size=(b, n, 5, 2, 3)).astype(np.float32)
    fused, coef, nc = topk_select(torch.from_numpy(vals), torch.from_numpy(prob), n, k)
    # JAX's value maps are NHWC: the fusion is per element, any layout will do
    j_fused, j_coef, j_nc = jax_topk_select(jnp.asarray(vals), jnp.asarray(prob), n, k)
    np.testing.assert_allclose(coef.numpy(), np.asarray(j_coef), rtol=0, atol=GRAPH_ATOL)
    np.testing.assert_array_equal(coef.numpy() != 0, np.asarray(j_coef) != 0)
    np.testing.assert_allclose(fused.numpy(), np.asarray(j_fused), rtol=1e-6, atol=1e-6)
    assert float(nc) == float(j_nc)
    # each query keeps its mass renormalized to 1
    np.testing.assert_allclose(coef.sum(dim=1).numpy(), 1.0, rtol=0, atol=1e-6)


def test_a_tie_keeps_more_than_k_links_as_jax_does():
    prob = torch.from_numpy(_tied_graph())
    _, coef, _ = topk_select(torch.zeros(2, 4, 1), prob, 4, 1)
    kept = (coef != 0).sum(dim=1)  # (B, Q): links a query keeps
    assert kept[0].tolist() == [2, 2, 2, 2]  # k = 1, two keys tie at the top
    assert kept[1, 0] == 4  # all four keys tie at 0.25
    _, j_coef, _ = jax_topk_select(jnp.zeros((2, 4, 1, 1, 1)), jnp.asarray(_tied_graph()), 4, 1)
    np.testing.assert_array_equal(kept.numpy(), (np.asarray(j_coef) != 0).sum(axis=1))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_per_frame_links_topk_matches_jax(graph, k):
    prob = GRAPHS[graph]
    n = prob.shape[1]
    got = per_frame_links(torch.from_numpy(prob), "topk", n, topk_k=k).numpy()
    want = np.asarray(jax_per_frame_links(jnp.asarray(prob), "topk", n, topk_k=k))
    np.testing.assert_array_equal(got, want)
    # the per-frame mean is the pruned graph's num_connect
    _, coef, nc = topk_select(torch.zeros(prob.shape[0], n, 1), torch.from_numpy(prob), n, k)
    assert got.mean() == pytest.approx(float(nc), rel=1e-6)
    assert float(num_connect_offdiag(coef, n)) == float(nc)


def test_topk_yaml_builds_and_loads_bridged_weights():
    """At its own size (6 agents at 512x512: shapes only, nothing runs)."""
    model = get_model(load_config(str(TOPK_YAML)), 11)
    assert model.topk_k == 2
    _builds_and_loads_bridged_weights(load_config(str(TOPK_YAML)),
                                      jax_load_config(str(TOPK_YAML)))


# id: (model keys, inference modes): every mode the JAX MIMOcom accepts
MIMOCOM_CASES = {
    "topk_k2": ({"topk_k": 2}, ("topk",)),
    "topk_k1": ({"topk_k": 1}, ("topk",)),
    "no_query": ({"query": False}, ("softmax", "argmax_test", "activated", "topk")),
    "one_output": ({"multiple_output": False}, ("softmax", "argmax_test", "activated", "topk")),
    "no_query_one_output": ({"query": False, "multiple_output": False}, ("activated", "topk")),
}


@pytest.fixture(scope="module", params=list(MIMOCOM_CASES))
def mimocom_case(request):
    keys, modes = MIMOCOM_CASES[request.param]
    cfg = raw_cfg("MIMOcom", N, (IMG, IMG), **keys)
    x = model_inputs(cfg, (2, N, IMG, IMG, 3), seed=5)
    variables = shared_variables(cfg, x, seed=5)
    return cfg, x, variables, port_model(cfg, variables), modes


def test_mimocom_variant_matches_jax_in_every_mode(mimocom_case):
    cfg, x, variables, model, modes = mimocom_case
    n_out = 2 * (N if cfg["model"]["multiple_output"] else 1)
    for mode in modes:
        want = jax_forward(cfg, variables, x, mode)
        got = port_forward(cfg, model, x, mode)
        assert got[0].shape[0] == n_out
        assert_outputs_match("MIMOcom", mode, got, want)


def test_topk_on_another_arch_is_an_incorrect_inference_mode():
    cfg = raw_cfg("MIMOcomWho", N, (IMG, IMG))
    x = model_inputs(cfg, (1, N, IMG, IMG, 3))
    model = port_model(cfg, shared_variables(cfg, x))
    with pytest.raises(ValueError, match="Incorrect inference mode 'topk'"):
        port_forward(cfg, model, x, "topk")


@pytest.fixture(scope="module")
def topk_fixture(tmp_path_factory):
    """configs/extensions/mrms_when2com_topk.yml at 64x64 over a fixture,
    and a seeded model's reference-format .pkl."""
    tmp = tmp_path_factory.mktemp("topk")
    generate_fixture(str(tmp / "data"), target_view="6agent", img_size=IMG, frames_per_traj=2)
    cfg = yaml.safe_load(TOPK_YAML.read_text())
    cfg["data"].update(img_rows=IMG, img_cols=IMG, path=str(tmp / "data"))
    cfg["training"].update(n_workers=0)
    yml = tmp / "topk.yml"
    yml.write_text(yaml.safe_dump(cfg))
    model = init_weights(get_model(load_config(str(yml)), 11), 0)
    pkl = tmp / "MIMOcom_airsim_seed0.pkl"
    torch.save({"epoch": 0, "model_state": model.state_dict(), "best_iou": 0.0}, pkl)
    return yml, pkl, model.eval()


def test_eval_cli_on_the_topk_yaml(topk_fixture, capsys):
    """``test --device cpu`` evaluates in the YAML's ``eval_inference:
    topk``: every frame's bandwidth is the pruned graph's, at most
    ``topk_k`` links a query (none tie here), and the same as the model's
    own topk forward over the test split."""
    yml, pkl, model = topk_fixture
    metrics = port_cli.main(["--config", str(yml), "--model_path", str(pkl), "--device", "cpu"])
    assert "Bandwidth:" in capsys.readouterr().out
    cfg = load_config(str(yml))
    from multiagentperception_tpu_torch.data import DataLoader, get_loader

    ds = get_loader("airsim")(root=cfg["data"]["path"], split="test", img_size=(IMG, IMG),
                              commun_label="mimo", target_view="6agent")
    want = []
    for batch in DataLoader(ds, cfg["training"]["batch_size"]):
        with torch.inference_mode():
            out = model(torch.as_tensor(np.asarray(batch[0])), inference="topk", full_res=False)
        want.append(float(out[3]))
        assert float(out[3]) <= cfg["model"]["topk_k"]
    assert metrics.count == len(want)
    assert metrics.get_avg_bandW() == pytest.approx(float(np.mean(want)), rel=1e-6)


def test_topk_serving_export_matches_jax_make_eval_fn():
    """The flagship topk YAML's model (3 agents at 64x64) exported in its
    ``topk`` mode: the loaded artifact's graph within 1e-5 of JAX's
    ``make_eval_fn(..., inference="topk")`` on shared weights, its per-frame
    bandwidth (``per_frame_links`` with the model's ``topk_k``) equal and
    its class maps on 99.9% of the pixels; the eager function's equal to
    the artifact's."""
    cfg = yaml.safe_load(TOPK_YAML.read_text())
    cfg["model"].update(agent_num=N, query_size=8, key_size=64, topk_k=1)
    cfg["data"].update(img_rows=IMG, img_cols=IMG)
    x = model_inputs(cfg, (2, N, IMG, IMG, 3), seed=9)
    variables = shared_variables(cfg, x, seed=9)
    model = port_model(cfg, variables)
    art = load_serving(export_serving(model, x.shape, inference="topk"))
    got = art(torch.from_numpy(x))
    eager = make_eval_fn(model, inference="topk")(torch.from_numpy(x))
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    jm = jax_get_model(jax_normalize_config(cfg), 11)
    want = jax_make_eval_fn(jm, True, "topk")(variables, jnp.asarray(x))
    assert (got[0].numpy() == np.asarray(want[0])).mean() >= 0.999
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_train_export_and_serve_clis_on_the_topk_yaml(topk_fixture, tmp_path, monkeypatch, capsys):
    """The topk YAML through ``train`` (2 iterations; its closing test-split
    eval in ``topk``), ``export_serving`` (the artifact in the YAML's
    ``eval_inference``) and ``serve``, on the CPU."""
    from multiagentperception_tpu_torch import export_serving as export_cli
    from multiagentperception_tpu_torch import serve as serve_cli
    from multiagentperception_tpu_torch import train as train_cli

    yml, pkl, _ = topk_fixture
    cfg = yaml.safe_load(Path(yml).read_text())
    cfg["training"].update(train_iters=2, val_interval=2, print_interval=1)
    short = tmp_path / "topk_short.yml"
    short.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    results = train_cli.main(["--config", str(short), "--device", "cpu"])
    assert len(results) == 1
    out = capsys.readouterr().out
    assert "Bandwidth:" in out  # the closing eval reports the topk graph's links

    artifact = str(tmp_path / "topk.pt2")
    export_cli.main(["--config", str(yml), "--model_path", str(pkl), "--out", artifact,
                     "--batch", "1", "--device", "cpu"])
    import json

    meta = json.loads(Path(artifact + ".meta.json").read_text())
    assert meta["inference"] == "topk"
    stats = serve_cli.main(["--config", str(yml), "--artifact", artifact, "--limit", "2",
                            "--out", str(tmp_path / "preds"), "--device", "cpu"])
    assert stats["frames"] == 2 and stats["maps"] == 2 * 6
    assert 0 < stats["bandwidth"] <= cfg["model"]["topk_k"]


def test_int8_hotswap_artifact_in_topk_serves_two_weight_sets():
    """The weight-hotswap int8 artifact (``bake_weights=False``, ``int8``,
    static scales: ``export._HotSwap``'s int8 branch) of a 64x64 MIMOcom in
    ``topk``: two weight sets, each held to the bit against
    ``quantize.make_int8_eval_fn`` on those weights (the class map, the
    graph within 1e-6, the per-frame bandwidth), and the two differ."""
    from multiagentperception_tpu_torch import quantize as tq

    cfg = raw_cfg("MIMOcom", N, (IMG, IMG), topk_k=1)
    x = torch.from_numpy(model_inputs(cfg, (2, N, IMG, IMG, 3), seed=21))
    tcfg = normalize_config(cfg)
    model = init_weights(get_model(tcfg, 11), 20).eval()
    scales = tq.calibrate_activations(model, [x], inference="topk", full_res=False)
    art = load_serving(export_serving(model, tuple(x.shape), inference="topk",
                                      bake_weights=False, int8=True, act_scales=scales))
    outs = []
    for seed in (22, 23):
        other = init_weights(get_model(tcfg, 11), seed).eval()
        state = {k: v.detach() for k, v in other.state_dict().items()}
        got = art(state, x)
        want = tq.make_int8_eval_fn(other, inference="topk", act_scales=scales)(x)
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
        assert torch.equal(got[2], want[2])
        outs.append(got[0])
    assert not torch.equal(*outs)
