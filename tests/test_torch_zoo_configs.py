"""The port builds every model the reference YAMLs reach, at their own size,
and refuses what it does not carry by name; image sides that are not
multiples of 128 run and match JAX.

- Each of the ten YAMLs builds a port model, and the weight bridge's
  output for the JAX model of that YAML (shapes from ``jax.eval_shape``,
  so nothing runs at 512x512) loads into it with ``strict=True``; so do
  the model keys the port refused before it carried them (the ``topk``
  extension YAML: tests/test_torch_topk.py). What it still does not
  carry is refused naming its key; an unknown backbone is a KeyError, as
  in JAX.
- 192x320 inputs (policy map 2x3, where ``256*(H/128)*(W/128)`` would be
  wrong) through MIMOcom and LearnWhen2Com against the JAX forward, with
  the tolerances of tests/test_torch_zoo.py.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu.config import load_config as jax_load_config
from multiagentperception_tpu.config import normalize_config as jax_normalize_config
from multiagentperception_tpu.models import get_model as jax_get_model
from multiagentperception_tpu_torch.config import load_config, normalize_config
from multiagentperception_tpu_torch.convert import state_dict_from_flax
from multiagentperception_tpu_torch.models import get_model
from test_torch_zoo import (
    B,
    assert_outputs_match,
    jax_forward,
    jax_kwargs,
    model_inputs,
    port_forward,
    port_model,
    raw_cfg,
    shared_variables,
)
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted((ROOT / "configs").glob("*-*/*.yml"))
TOPK = ROOT / "configs" / "extensions" / "mrms_when2com_topk.yml"


def test_the_ten_reference_yamls():
    assert len(YAMLS) == 10


def _builds_and_loads_bridged_weights(cfg: dict, jcfg: dict) -> None:
    model = get_model(cfg, 11)
    m, d = jcfg["model"], jcfg["data"]
    n = m["agent_num"]
    shape = (1, n, d["img_rows"], d["img_cols"], 3)
    if m["arch"] == "Single_agent":
        shape = (n, d["img_rows"], d["img_cols"], 3)
    rngs = {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)}
    abstract = jax.eval_shape(
        lambda x: jax_get_model(jcfg, 11).init(rngs, x, **jax_kwargs(jcfg, False)),
        jax.ShapeDtypeStruct(shape, jnp.float32))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), abstract)
    model.load_state_dict(state_dict_from_flax(cfg, variables), strict=True)


@pytest.mark.parametrize("yml", YAMLS, ids=lambda p: p.stem)
def test_yaml_builds_and_loads_bridged_weights(yml):
    _builds_and_loads_bridged_weights(load_config(str(yml)), jax_load_config(str(yml)))


def test_topk_extension_is_refused_by_name(caplog):
    """The topk YAML builds (tests/test_torch_topk.py); on another
    architecture its keys are refused by name, as in JAX: ``topk_k`` is
    ignored with a warning naming it, and ``topk`` is an incorrect
    inference mode."""
    cfg = load_config(str(TOPK))
    cfg["model"]["arch"] = "MIMOcomWho"
    cfg["data"]["img_rows"] = cfg["data"]["img_cols"] = 64
    model = get_model(cfg, 11).eval()
    assert "model.topk_k is a MIMOcom extension" in caplog.text
    with pytest.raises(ValueError, match="Incorrect inference mode 'topk'"), torch.no_grad():
        model(torch.zeros(1, 6, 64, 64, 3), inference="topk")


@pytest.mark.parametrize("arch,key,value", [
    ("MIMOcom", "agent_parallel_train", True), ("MIMOcomWho", "dtype", "float16"),
    ("Single_agent", "agent_parallel", True), ("All_agents", "dtype", "float16"),
    ("MIMO_All_agents", "dtype", "float16"), ("LearnWho2Com", "agent_parallel", True)])
def test_unported_model_keys_are_refused(arch, key, value, caplog):
    """float16 is still refused; the ring's keys are ported: without a
    ring of ranks ``agent_parallel_train`` raises as in JAX, and the other
    architectures ignore ``agent_parallel`` with a warning."""
    cfg = normalize_config(raw_cfg(arch, **{key: value}))
    if key == "dtype":
        with pytest.raises(NotImplementedError, match=key):
            get_model(cfg, 11)
    elif arch == "MIMOcom":
        with pytest.raises(ValueError, match="agent_parallel_train requires"):
            get_model(cfg, 11)
    else:
        get_model(cfg, 11)
        assert f"model.{key} is a MIMOcom extension" in caplog.text


@pytest.mark.parametrize("arch,key,value", [
    ("LearnWhen2Com", "sparse", True), ("MIMOcomWho", "feat_squeezer", 128),
    ("Single_agent", "enc_backbone", "n_segnet_encoder"),
    ("All_agents", "dec_backbone", "FCN_decoder")])
def test_keys_once_refused_build_and_load_bridged_weights(arch, key, value):
    """What the port refused before it carried it: ``feat_squeezer`` 128,
    neither 2 nor 4, keeps the squeezer at stride 1, as in JAX."""
    raw = raw_cfg(arch, img=(128, 128), **{key: value})
    _builds_and_loads_bridged_weights(normalize_config(raw), jax_normalize_config(raw))


@pytest.mark.parametrize("key,value", [("enc_backbone", "vgg_encoder"),
                                       ("dec_backbone", "fcn_decoder")])
def test_unknown_backbones_raise_key_error(key, value):
    with pytest.raises(KeyError, match=f"{value} not available"):
        get_model(normalize_config(raw_cfg("All_agents", **{key: value})), 11)


def test_mimocom_extension_keys_on_another_arch_warn(caplog):
    get_model(normalize_config(raw_cfg("Single_agent", pallas_comm=True)), 11)
    assert "model.pallas_comm is a MIMOcom extension" in caplog.text


SIDES = (192, 320)


@pytest.mark.parametrize("arch,mode", [("MIMOcom", "activated"),
                                       ("LearnWhen2Com", "activated")])
def test_sides_not_multiples_of_128_match_jax(arch, mode):
    cfg = raw_cfg(arch, img=SIDES)
    x = model_inputs(cfg, (B, 3, *SIDES, 3), seed=3)
    variables = shared_variables(cfg, x, seed=3)
    model = port_model(cfg, variables)
    assert model.key_net.fc[0].in_features == 256 * 2 * 3
    want = jax_forward(cfg, variables, x, mode)
    got = port_forward(cfg, model, x, mode)
    assert got[0].shape[-2:] == torch.Size(SIDES)
    assert_outputs_match(arch, mode, got, want)
