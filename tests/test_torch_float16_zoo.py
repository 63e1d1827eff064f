"""The six other architectures in float16 against the JAX package's float16
models on shared weights, each in its eval default mode, under the rule of
tests/test_torch_mixed_precision_models.py (whose helpers, shapes and seeds
these are, as tests/test_torch_mixed_precision_zoo.py runs them in bf16):
over ``F16_SEEDS`` (two, where bf16 runs four), the port's float16
prediction lies no further from its float32 one than twice JAX's float16
prediction from JAX's float32 one (relative L2, summed over the seeds), and
every float16 prediction is finite. In a file of its own so the test
runner's workers take it beside the flagship's.
"""

from __future__ import annotations

import pytest

from test_torch_float16_models import F16_SEEDS
from test_torch_mixed_precision_models import shared_seeds  # noqa: F401 (a fixture)
from test_torch_mixed_precision_zoo import OTHERS, other_arch_against_jax
from test_torch_train import few_threads  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("case", list(OTHERS))
def test_other_archs_f16_match_jax(shared_seeds, case):  # noqa: F811
    other_arch_against_jax(shared_seeds, case, "float16", F16_SEEDS)
