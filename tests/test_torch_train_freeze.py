"""The ``training.freeze_bn_stats`` variant of tests/test_torch_train.py:
the same four tests (imported from there, tolerances stated there), run
on this file's ``runs`` fixture. A file of its own, so that the test
runner's workers take it beside the other variants."""

from __future__ import annotations

import pytest

from test_torch_train import (  # noqa: F401 (fixtures and tests collected here)
    _jax_run,
    _port_run,
    few_threads,
    jax_first_grads,
    shared,
    test_bn_statistics_match_jax,
    test_gradients_match_jax,
    test_loss_matches_jax,
    test_parameters_after_k_steps_match_jax,
)


@pytest.fixture(scope="module", params=["freeze_bn_stats"])
def runs(request, shared, jax_first_grads):  # noqa: F811
    variant = request.param
    return (variant, _port_run(variant, shared),
            _jax_run(variant, shared, jax_first_grads(variant)))
