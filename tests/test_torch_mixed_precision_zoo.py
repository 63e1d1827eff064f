"""The six other architectures in bf16 against the JAX package's bf16
models on shared weights, each in its eval default mode, under the bf16
rule of tests/test_torch_mixed_precision_models.py (whose helpers, shapes
and seeds these are): over the seeds, the port's bf16 prediction lies no
further from its float32 one than twice JAX's bf16 prediction from JAX's
float32 one (relative L2, summed over the seeds). One case per
architecture, in a file of its own so the test runner's workers take it
beside the flagship's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiagentperception_tpu_torch.evaluate import EVAL_DEFAULT
from test_torch_mixed_precision_models import (
    SEEDS,
    _assert_ratio,
    _four_way,
    _pred,
    _rel,
    shared_seeds,  # noqa: F401 (a fixture)
)
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)

OTHERS = {  # id: (arch, model keys)
    "Single_agent": ("Single_agent", {}),
    "All_agents": ("All_agents", {"shuffle_features": "None"}),
    "MIMO_All_agents": ("MIMO_All_agents", {"shuffle_features": "None"}),
    "LearnWho2Com": ("LearnWho2Com", {"shared_img_encoder": "unified"}),
    "LearnWhen2Com": ("LearnWhen2Com", {"shared_img_encoder": "unified"}),
    "MIMOcomWho": ("MIMOcomWho", {}),
}


def other_arch_against_jax(shared_seeds, case: str, dtype: str = "bfloat16",
                           seeds=SEEDS) -> None:
    """Architecture ``case`` of ``OTHERS`` in ``dtype`` against JAX's under
    the rule, over ``seeds``."""
    arch, keys = OTHERS[case]
    mode = EVAL_DEFAULT.get(arch, "softmax")
    errs = {"port": [], "jax": []}
    for seed in seeds:
        cfg, cfg16, x, variables = shared_seeds(arch, keys, seed, dtype)
        out = _four_way(cfg, cfg16, x, variables, mode)
        assert out["port16"][0].dtype == getattr(torch, dtype)
        assert out["jax16"][0].dtype == getattr(jnp, dtype)
        assert bool(torch.isfinite(out["port16"][0]).all())
        errs["port"].append(_rel(_pred(out["port16"]), _pred(out["port32"])))
        errs["jax"].append(_rel(np.asarray(out["jax16"][0], np.float32), out["jax32"][0]))
    _assert_ratio(errs, f"{arch} {dtype} {mode}")


@pytest.mark.parametrize("case", list(OTHERS))
def test_other_archs_bf16_match_jax(shared_seeds, case):
    other_arch_against_jax(shared_seeds, case)
