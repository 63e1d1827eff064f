"""K3's float32 route on the tensor cores (``route`` ``"tf32x3"``,
``csrc/fused_block_tf32.cu``) on the CPU: its arithmetic, emulated.

The kernel splits every float32 operand into TF32 ``hi = rna(v)`` and
``lo = rna(v - hi)`` and forms each product as ``hi*hi + hi*lo + lo*hi``.
Here ``tf32_round`` is held against a numpy emulation of
``cvt.rna.tf32.f32``, and the 3xTF32 block (the three products summed in
float64 by ``F.conv2d``, y1 and the epilogues in float32 as the kernel
rounds them) against the plain version and the JAX reference within the
float32 check's rtol/atol 1e-4 (``checks.K3_F32_TOL``). The negative
control: a block of single TF32 products (``hi*hi`` only) fails that
bound, which is why the route pays for three products. The kernel itself
runs only on the card (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multiagentperception_tpu.ops.pallas import fused_block as jax_k3
from multiagentperception_tpu_torch import bench_fused_block as bench
from multiagentperception_tpu_torch.ops.kernels import checks
from multiagentperception_tpu_torch.ops.kernels import fused_block as k3


def _rna_np(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on float32 bits: add half of the 13 dropped bits'
    weight to the magnitude (ties away from zero), then drop them."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = torch.from_numpy(_rna_np(v.numpy()))
    return hi, torch.from_numpy(_rna_np((v - hi).numpy()))


def _block_tf32(x, w1, s1, b1, w2, s2, b2, products: int):
    """The block as the tf32x3 kernel computes it (``products`` 3), or with
    single TF32 products (``products`` 1)."""
    def conv(v, w, s, b):
        (vh, vl), (wh, wl) = _split(v), _split(w.permute(3, 2, 0, 1).contiguous())
        terms = [(vh, wh)] if products == 1 else [(vl, wh), (vh, wl), (vh, wh)]
        acc = sum(F.conv2d(a.double(), bb.double(), padding=1) for a, bb in terms).float()
        return acc * s[:, None, None] + b[:, None, None]

    xc = x.permute(0, 3, 1, 2).contiguous()
    y = torch.relu(conv(xc, w1, s1, b1))
    return torch.relu(conv(y, w2, s2, b2) + xc).permute(0, 2, 3, 1)


def _inputs(rng, b, h, w, c):
    def bn():
        return (rng.uniform(0.5, 1.5, c), rng.normal(size=c) * 0.1, rng.normal(size=c) * 0.1,
                rng.uniform(0.5, 1.5, c))

    w1, w2 = (rng.normal(size=(3, 3, c, c)) * 0.05 for _ in range(2))
    raw = [np.asarray(a, np.float32) for a in (w1, *bn(), w2, *bn())]
    j = [jnp.asarray(a) for a in raw]
    j_params = (j[0], *jax_k3.fold_bn(*j[1:5]), j[5], *jax_k3.fold_bn(*j[6:10]))
    t = [torch.from_numpy(a) for a in raw]
    t_params = (t[0], *k3.fold_bn(*t[1:5]), t[5], *k3.fold_bn(*t[6:10]))
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return x, j_params, t_params


def test_tf32_round_matches_rna():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096),
                        # exact ties: the 13 dropped bits 0x1000, both signs
                        np.array([1 + 2 ** -11, -(1 + 2 ** -11), 3 * 2 ** -11 + 1, 0.0, -0.0])]
                       ).astype(np.float32)
    got = k3.tf32_round(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _rna_np(v).view(np.uint32))
    assert got[4096] == np.float32(1 + 2 ** -10) and got[4097] == -np.float32(1 + 2 ** -10)
    assert not (got.view(np.uint32) & 0x1FFF).any()
    hi, lo = k3.tf32_split(torch.from_numpy(v))
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()
    # hi + lo is float32's value to within 2^-22 of it
    err = np.abs((hi + lo).numpy().astype(np.float64) - v) / np.maximum(np.abs(v), 1e-30)
    assert err.max() <= 2.0 ** -22


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("h,w", [(9, 13), (20, 28)])
def test_3xtf32_block_meets_the_float32_check(c, h, w):
    x, j, t = _inputs(np.random.default_rng(1), 2, h, w, c)
    got = _block_tf32(torch.from_numpy(x), *t, products=3)
    plain = k3.fused_basic_block_plain(torch.from_numpy(x), *t)
    tol = checks.K3_F32_TOL
    torch.testing.assert_close(got, plain, rtol=tol, atol=tol)
    ref = np.asarray(jax_k3.fused_basic_block_reference(jnp.asarray(x), *j))
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("c", [64, 128])
def test_single_tf32_block_fails_the_float32_check(c):
    """The negative control: hi*hi alone is plain TF32, ~1e-3 off."""
    x, _, t = _inputs(np.random.default_rng(2), 2, 20, 28, c)
    plain = k3.fused_basic_block_plain(torch.from_numpy(x), *t)
    one = _block_tf32(torch.from_numpy(x), *t, products=1)
    tol = checks.K3_F32_TOL
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one, plain, rtol=tol, atol=tol)
    three = _block_tf32(torch.from_numpy(x), *t, products=3)
    assert (one - plain).abs().max() > 10 * (three - plain).abs().max()


@pytest.mark.parametrize("c", [64, 128])
def test_tf32x3_weights_layout(c):
    """tf32x3_weights puts w[dy, dx, ci, co]'s hi and lo at [conv][3*dy + dx]
    [ci // KS][0 or 1][(ci % KS) // 4][co][ci % 4], KS = TF32X3_STAGE[c]."""
    ks = k3.TF32X3_STAGE[c]
    rng = np.random.default_rng(3)
    w1, w2 = (torch.from_numpy(rng.normal(size=(3, 3, c, c)).astype(np.float32))
              for _ in range(2))
    got = k3.tf32x3_weights(w1, w2)
    assert got.dtype == torch.float32 and got.shape == (2, 9, c // ks, 2, ks // 4, c, 4)
    assert got.is_contiguous()
    for conv, w in enumerate((w1, w2)):
        for dy, dx, ci, co in [(0, 0, 0, 0), (1, 2, 5, 7), (2, 1, c - 1, 3), (2, 2, 63, c - 1),
                               (0, 1, c // 2 + 9, c // 2 + 1)]:
            v = w[dy, dx, ci, co].numpy()
            hi = _rna_np(v[None])[0]
            lo = _rna_np(np.float32(v - hi)[None])[0]
            at = got[conv, 3 * dy + dx, ci // ks, :, (ci % ks) // 4, co, ci % 4]
            assert at[0].item() == hi and at[1].item() == lo


@pytest.mark.parametrize("dtype,c,hw,b,want_ms", [
    (torch.float32, 64, 128, 12, 3 * 4 * 12 * 128 * 128 * 9 * 64 * 64 / 495e12 * 1e3),
    (torch.float32, 128, 64, 12, 3 * 4 * 12 * 64 * 64 * 9 * 128 * 128 / 495e12 * 1e3),
    (torch.float32, 256, 32, 12, 3 * 4 * 12 * 32 * 32 * 9 * 256 * 256 / 495e12 * 1e3),
    (torch.bfloat16, 512, 16, 120, 4 * 120 * 16 * 16 * 9 * 512 * 512 / 989e12 * 1e3)],
    # the last two ids name the CUDA-core route that took C = 256/512 before
    # the tensor-core conv routes; kept so that each case keeps its name
    ids=["tf32x3_layer1", "tf32x3_layer2", "fma_f32_layer3", "fma_bf16_layer4"])
def test_bench_bound_follows_the_route(dtype, c, hw, b, want_ms):
    """bench_fused_block.bound_ms: three TF32 products per operation on the
    float32 routes (tf32x3 and tf32x3_conv: 0.1757 ms at every eval
    geometry), bf16 tensor cores otherwise."""
    got, by = bench.bound_ms(torch.zeros(b, hw, hw, c, dtype=dtype))
    assert by == "operations"
    assert got == pytest.approx(want_ms, rel=1e-12)
    if dtype == torch.float32:
        assert k3.route(dtype, c).startswith("tf32x3")
        assert got == pytest.approx(0.1757, abs=5e-5)
