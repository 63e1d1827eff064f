"""K3, the fused eval-mode ResNet basic block, on the CPU: the port's
``fold_bn`` and ``fused_basic_block`` (its plain version on CPU tensors)
against the JAX package's on the same numpy inputs, and the bfloat16
comparator that ``ops/kernels/checks.py`` holds the CUDA kernel to.

Tolerances: float32 rtol/atol 1e-4 (tests/test_fused_block.py's bound);
``fold_bn`` rtol 1e-6 / atol 1e-7 (one ulp: XLA fuses ``b - m * s`` into
an FMA); bfloat16 by ``checks.assert_bf16_close`` against the
Pallas kernel (the same rounding points: float32 sums, y1 rounded to
bfloat16), and against the JAX reference, which also rounds each
convolution's output to bfloat16, within 4 bf16 ulps + 2e-2.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multiagentperception_tpu.ops.pallas import fused_block as jax_k3
from multiagentperception_tpu_torch.ops.kernels import checks
from multiagentperception_tpu_torch.ops.kernels import fused_block as k3


def _params(rng, c):
    def bn():
        return (rng.uniform(0.5, 1.5, c), rng.normal(size=c) * 0.1, rng.normal(size=c) * 0.1,
                rng.uniform(0.5, 1.5, c))

    w1, w2 = (rng.normal(size=(3, 3, c, c)) * 0.05 for _ in range(2))
    (g1, be1, m1, v1), (g2, be2, m2, v2) = bn(), bn()
    raw = [np.asarray(a, np.float32) for a in (w1, g1, be1, m1, v1, w2, g2, be2, m2, v2)]
    j = [jnp.asarray(a) for a in raw]
    j_params = (j[0], *jax_k3.fold_bn(*j[1:5]), j[5], *jax_k3.fold_bn(*j[6:10]))
    t = [torch.from_numpy(a) for a in raw]
    t_params = (t[0], *k3.fold_bn(*t[1:5]), t[5], *k3.fold_bn(*t[6:10]))
    return j_params, t_params


def test_fold_bn_matches_jax():
    j, t = _params(np.random.default_rng(0), 64)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("c,hw,tile,pair", [(64, 64, 32, True), (64, 64, 32, False),
                                            (128, 32, 32, False)],
                         ids=["layer1_pair", "layer1_plain", "layer2"])
def test_matches_the_pallas_kernel(c, hw, tile, pair):
    rng = np.random.default_rng(1)
    j, t = _params(rng, c)
    x = rng.normal(size=(2, hw, hw, c)).astype(np.float32)
    want = jax_k3.fused_basic_block(jnp.asarray(x), *j, tile=tile, pair=pair, interpret=True)
    got = k3.fused_basic_block(torch.from_numpy(x), *t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_border_zero_padding():
    """A biased input makes any error of conv2's ring at the border visible."""
    rng = np.random.default_rng(2)
    j, t = _params(rng, 64)
    x = (rng.normal(size=(1, 64, 64, 64)) + 1.0).astype(np.float32)
    want = jax_k3.fused_basic_block(jnp.asarray(x), *j, tile=32, interpret=True)
    got = k3.fused_basic_block(torch.from_numpy(x), *t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w", [(20, 28), (17, 9)])
def test_odd_sizes_match_the_jax_reference(h, w):
    rng = np.random.default_rng(3)
    j, t = _params(rng, 64)
    x = rng.normal(size=(2, h, w, 64)).astype(np.float32)
    want = jax_k3.fused_basic_block_reference(jnp.asarray(x), *j)
    got = k3.fused_basic_block(torch.from_numpy(x), *t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_bfloat16_matches_jax():
    rng = np.random.default_rng(4)
    j, t = _params(rng, 64)
    x = rng.normal(size=(1, 32, 32, 64)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    got = k3.fused_basic_block(xt, *t)
    assert got.dtype == torch.bfloat16
    pallas = torch.from_numpy(np.asarray(jax_k3.fused_basic_block(
        xj, *j, tile=32, interpret=True), np.float32)).bfloat16()
    checks.assert_bf16_close(got, pallas)
    ref = torch.from_numpy(np.asarray(jax_k3.fused_basic_block_reference(xj, *j), np.float32))
    err = (got.float() - ref).abs()
    assert bool((err <= 4 * checks.bf16_ulp(ref) + 2e-2).all()), err.max()


def _ring_fed_relu_b1(x, w1, s1, b1, w2, s2, b2):
    """K3 done wrong: conv2's ring outside the image holds relu(b1), not 0."""
    xc = x.permute(0, 3, 1, 2).float()
    oihw = lambda w: w.to(x.dtype).float().permute(3, 2, 0, 1)  # noqa: E731
    y = torch.relu(F.conv2d(xc, oihw(w1), padding=1) * s1[:, None, None] + b1[:, None, None])
    ring = torch.relu(b1)[None, :, None, None].expand(y.shape[0], -1, y.shape[2] + 2,
                                                      y.shape[3] + 2).clone()
    ring[:, :, 1:-1, 1:-1] = y
    y = ring.to(x.dtype).float()
    y = F.conv2d(y, oihw(w2)) * s2[:, None, None] + b2[:, None, None] + xc
    return torch.relu(y).to(x.dtype).permute(0, 2, 3, 1)


@pytest.mark.parametrize("hw", [32, 128])
def test_bf16_comparator_refuses_a_wrong_ring(hw):
    """The negative control: the bound that passes the kernel (checks.py)
    fails a block whose ring is fed relu(b1), even where the border is only
    3% of a 128x128 image."""
    rng = np.random.default_rng(5)
    _, t = _params(rng, 64)
    x = torch.from_numpy(rng.normal(size=(1, hw, hw, 64)).astype(np.float32)).bfloat16()
    right = k3.fused_basic_block_plain(x, *t)
    checks.assert_bf16_close(right, right)
    assert float(torch.relu(t[2]).sum()) > 0
    with pytest.raises(AssertionError, match="K3 bf16 disagrees"):
        checks.assert_bf16_close(_ring_fed_relu_b1(x, *t), right)


def test_wrapper_refuses_other_layouts():
    with pytest.raises(ValueError, match="B, H, W, C"):
        k3.fused_basic_block(torch.zeros(2, 3, 64), *(torch.zeros(1),) * 6)


# The C = 256/512 cases keep the ids they had when a CUDA-core route ("fma")
# took those widths, so that each case keeps its name.
@pytest.mark.parametrize("dtype,c,want", [(torch.bfloat16, 64, "wgmma"),
                                          (torch.bfloat16, 128, "wgmma"),
                                          (torch.bfloat16, 256, "wgmma_conv"),
                                          (torch.bfloat16, 512, "wgmma_conv"),
                                          (torch.float32, 64, "tf32x3"),
                                          (torch.float32, 128, "tf32x3"),
                                          (torch.float32, 256, "tf32x3_conv"),
                                          (torch.float32, 512, "tf32x3_conv")],
                         ids=["dtype0-64-wgmma", "dtype1-128-wgmma", "dtype2-256-fma",
                              "dtype3-512-fma", "dtype4-64-tf32x3", "dtype5-128-tf32x3",
                              "dtype6-256-fma", "dtype7-512-fma"])
def test_route(dtype, c, want):
    assert k3.route(dtype, c) == want


@pytest.mark.parametrize("dtype,c,err", [(torch.float16, 64, TypeError),
                                         (torch.bfloat16, 96, ValueError),
                                         (torch.float32, 96, ValueError)])
def test_route_refuses(dtype, c, err):
    with pytest.raises(err):
        k3.route(dtype, c)


@pytest.mark.parametrize("c", [64, 128])
def test_wgmma_weights_layout(c):
    """wgmma_weights puts w[dy, dx, ci, co] at [conv][3*dy + dx][ci // 64]
    [(ci % 64) // 8][co][ci % 8], in bf16."""
    rng = np.random.default_rng(6)
    w1, w2 = (torch.from_numpy(rng.normal(size=(3, 3, c, c)).astype(np.float32))
              for _ in range(2))
    got = k3.wgmma_weights(w1, w2)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, c // 64, 8, c, 8)
    assert got.is_contiguous()
    for conv, w in enumerate((w1, w2)):
        for dy, dx, ci, co in [(0, 0, 0, 0), (1, 2, 5, 7), (2, 1, c - 1, 3), (2, 2, 63, c - 1),
                               (0, 1, c // 2 + 9, c // 2 + 1)]:
            want = w[dy, dx, ci, co].to(torch.bfloat16)
            assert got[conv, 3 * dy + dx, ci // 64, (ci % 64) // 8, co, ci % 8] == want
