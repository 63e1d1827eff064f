"""K3 at C = 256 and 512 (routes ``wgmma_conv`` in bfloat16 and
``tf32x3_conv`` in float32) on the CPU: the weight layouts the kernels
stream, and their arithmetic, emulated.

Each route runs the block as two implicit-GEMM convolutions: conv1 into a
y1 tensor rounded to ``x.dtype``, then conv2 over y1 (zero outside the
image) with the residual. The tensor cores sum one stage (a tap x 64 input
channels in bfloat16; a tap x 32 channels in float32, each of the two
warpgroups taking half of every 64-channel chunk, their sums added at the
end) and CUDA-core float32 adds sum the stages. Here each stage is summed
in float64 and rounded to float32 (the float32 route's products as its
``hi*hi + hi*lo + lo*hi`` of TF32 halves), and the decomposition is held
within rtol/atol 1e-4 (``checks.K3_F32_TOL``) of the JAX package's
``fused_basic_block`` (the Pallas kernel in interpret mode, ``tile=8``) and
of its reference in float32; in bfloat16 by ``checks.assert_bf16_close``
against the Pallas kernel and the plain version, and no further from the
JAX reference (which rounds at other points) than the plain version. The negative control: the same decomposition with y1 padded by
``relu(b1)`` instead of zeros fails those checks. The kernels themselves run
only on the card (tests/test_torch_cuda.py).
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

WIDE = (256, 512)


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


def _conv_staged(vp: torch.Tensor, w: torch.Tensor, tf32x3: bool) -> torch.Tensor:
    """One 3x3 conv over ``vp`` (B, H+2, W+2, C), already padded, as the
    route sums it: stages in float64 rounded to float32, summed in float32
    in the kernel's order (64-channel chunk, then tap)."""
    bsz, hp, wp, c = vp.shape
    h, wd = hp - 2, wp - 2
    ks = 32 if tf32x3 else 64
    acc = [torch.zeros(bsz, h, wd, c) for _ in range(64 // ks)]
    for kc in range(c // 64):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for half in range(64 // ks):
                ch = slice(kc * 64 + half * ks, kc * 64 + (half + 1) * ks)
                a, b = vp[:, dy:dy + h, dx:dx + wd, ch], w[dy, dx, ch, :]
                if tf32x3:
                    (ah, al), (bh, bl) = k3.tf32_split(a), k3.tf32_split(b)
                    part = sum(p.double() @ q.double() for p, q in ((al, bh), (ah, bl), (ah, bh)))
                else:
                    part = a.double() @ b.double()
                acc[half] += part.float()
    return acc[0] + acc[1] if tf32x3 else acc[0]


def _two_launches(x, w1, s1, b1, w2, s2, b2, ring: str = "zero") -> torch.Tensor:
    """The route's block: conv1 into y1 (rounded to x.dtype), conv2 over y1
    padded by zeros (or, for the negative control, ``ring="relu_b1"``, by
    relu(b1)), the residual and relu in float32."""
    tf32x3 = x.dtype == torch.float32
    xf = x.float()
    wr = [wt.to(x.dtype).float() for wt in (w1, w2)]
    y1 = torch.relu(_conv_staged(F.pad(xf, (0, 0, 1, 1, 1, 1)), wr[0], tf32x3) * s1 + b1)
    y1 = y1.to(x.dtype).float()
    if ring == "zero":
        yp = F.pad(y1, (0, 0, 1, 1, 1, 1))
    else:
        bsz, h, w, c = y1.shape
        yp = torch.relu(b1).to(x.dtype).float().expand(bsz, h + 2, w + 2, c).clone()
        yp[:, 1:-1, 1:-1] = y1
    out = _conv_staged(yp, wr[1], tf32x3) * s2 + b2 + xf
    return torch.relu(out).to(x.dtype)


def _check(got: torch.Tensor, want: torch.Tensor) -> None:
    if got.dtype == torch.bfloat16:
        checks.assert_bf16_close(got, want.bfloat16())
    else:
        torch.testing.assert_close(got, want, rtol=checks.K3_F32_TOL, atol=checks.K3_F32_TOL)


@pytest.mark.parametrize("c", WIDE)
def test_wgmma_conv_weights_layout(c):
    """wgmma_conv_weights puts w[dy, dx, ci, co] at [conv][co // 128]
    [ci // 64][3*dy + dx][(ci % 64) // 8][co % 128][ci % 8], in bf16."""
    rng = np.random.default_rng(7)
    w1, w2 = (torch.from_numpy(rng.normal(size=(3, 3, c, c)).astype(np.float32))
              for _ in range(2))
    got = k3.wgmma_conv_weights(w1, w2)
    assert got.dtype == torch.bfloat16 and got.shape == (2, c // 128, c // 64, 9, 8, 128, 8)
    assert got.is_contiguous()
    for conv, w in enumerate((w1, w2)):
        for dy, dx, ci, co in [(0, 0, 0, 0), (1, 2, 5, 7), (2, 1, c - 1, 3), (2, 2, 63, c - 1),
                               (0, 1, c // 2 + 9, c // 2 + 1), (1, 1, 200, 130)]:
            want = w[dy, dx, ci, co].to(torch.bfloat16)
            at = got[conv, co // 128, ci // 64, 3 * dy + dx, (ci % 64) // 8, co % 128, ci % 8]
            assert at == want


@pytest.mark.parametrize("c", WIDE)
def test_tf32x3_conv_weights_layout(c):
    """tf32x3_conv_weights puts w[dy, dx, ci, co]'s TF32 hi and lo at [conv]
    [co // 64][ci // 64][3*dy + dx][0 or 1][(ci % 64) // 4][co % 64][ci % 4]."""
    rng = np.random.default_rng(8)
    w1, w2 = (torch.from_numpy(rng.normal(size=(3, 3, c, c)).astype(np.float32))
              for _ in range(2))
    got = k3.tf32x3_conv_weights(w1, w2)
    assert got.dtype == torch.float32
    assert got.shape == (2, c // 64, c // 64, 9, 2, 16, 64, 4) and got.is_contiguous()
    for conv, w in enumerate((w1, w2)):
        for dy, dx, ci, co in [(0, 0, 0, 0), (1, 2, 5, 7), (2, 1, c - 1, 3), (2, 2, 63, c - 1),
                               (0, 1, c // 2 + 9, c // 2 + 1), (1, 1, 200, 130)]:
            hi, lo = k3.tf32_split(w[dy, dx, ci, co].reshape(1))
            at = got[conv, co // 64, ci // 64, 3 * dy + dx, :, (ci % 64) // 4, co % 64, ci % 4]
            assert at[0] == hi[0] and at[1] == lo[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", WIDE)
def test_two_launches_match_jax(c, dtype):
    """The routes' decomposition against the Pallas kernel (interpret mode,
    tile 8) and the JAX reference on a (1, 8, 16, C) image."""
    x, j, t = _inputs(np.random.default_rng(9), 1, 8, 16, c)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xt = torch.from_numpy(x).to(dtype)
    got = _two_launches(xt, *t)
    assert got.dtype == dtype and got.shape == xt.shape
    pallas = jax_k3.fused_basic_block(jnp.asarray(x, jdt), *j, tile=8, interpret=True)
    _check(got, torch.from_numpy(np.asarray(pallas, np.float32)))
    _check(got, k3.fused_basic_block_plain(xt, *t).float())
    ref = torch.from_numpy(np.asarray(
        jax_k3.fused_basic_block_reference(jnp.asarray(x, jdt), *j), np.float32))
    if dtype == torch.float32:
        _check(got, ref)
        return
    # In bfloat16 the JAX reference also rounds each conv's output to
    # bfloat16, which at 9*C = 2304-4608 terms moves outputs by up to ~0.25:
    # the decomposition lies no further from it than the plain version.
    far = 4 * checks.bf16_ulp(ref) + 2e-2
    err = {side: (v.float() - ref).abs()
           for side, v in (("two", got), ("plain", k3.fused_basic_block_plain(xt, *t)))}
    assert int((err["two"] > far).sum()) <= int((err["plain"] > far).sum())
    assert float(err["two"].mean()) <= 1.01 * float(err["plain"].mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", WIDE)
def test_two_launches_with_a_relu_b1_ring_fail(c, dtype):
    """The negative control: y1 padded by relu(b1), not zeros, fails the
    check that the right decomposition passes."""
    x, _, t = _inputs(np.random.default_rng(10), 1, 8, 16, c)
    xt = torch.from_numpy(x).to(dtype)
    plain = k3.fused_basic_block_plain(xt, *t)
    _check(_two_launches(xt, *t), plain.float())
    assert float(torch.relu(t[2]).sum()) > 0
    with pytest.raises(AssertionError):
        _check(_two_launches(xt, *t, ring="relu_b1"), plain.float())
