"""The port's CUDA kernels on the card: each against its plain PyTorch
version at the flagship shapes, through the checks ``chip_smoke.py`` also
runs (``ops/kernels/checks.py``, which states the tolerances), what the
wrappers refuse, and one training step on the card. Every test here needs
an NVIDIA card and skips without one. It imports nothing of JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import contextlib
import copy
import os

import numpy as np
import pytest
import torch

from multiagentperception_tpu_torch.ops.kernels import checks
from multiagentperception_tpu_torch.bench_fused_block import block_inputs
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import fused_block as k3
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1

pytestmark = pytest.mark.cuda
# cuBLAS picks the same kernels on every stream with a fixed workspace: the
# graph-against-eager training test runs deterministic (set before cuBLAS starts)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def cuda():
    """The card, or a skip: a CUDA kernel has no CPU mode to run here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_upsample_argmax_kernel_matches_plain(cuda):
    x = torch.randn(12, 11, 16, 16, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = k1.upsample_argmax.launches
    checks.check_upsample_argmax(x, 512, 512)
    assert k1.upsample_argmax.launches == before + 2  # the logits and the tie case


@pytest.mark.parametrize("h,w,out_h,out_w", [(8, 8, 256, 256), (16, 16, 500, 300),
                                             (5, 7, 17, 29)],
                         ids=["8x8_to_256", "16x16_to_500x300", "5x7_to_17x29"])
def test_upsample_argmax_kernel_other_shapes(cuda, h, w, out_h, out_w):
    """The span path at x32 (8x8 -> 256) and the per-pixel path where runs
    of 4 columns straddle a tap change or the width is not a multiple of 4."""
    x = torch.randn(3, 11, h, w, generator=torch.Generator().manual_seed(2)).to(cuda)
    before = k1.upsample_argmax.launches
    checks.check_upsample_argmax(x, out_h, out_w)
    assert k1.upsample_argmax.launches == before + 2


def test_upsample_argmax_kernel_refuses_non_contiguous(cuda):
    x = torch.randn(2, 16, 16, 11, device=cuda).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k1.upsample_argmax(x, 512, 512)


@pytest.mark.parametrize("h,w,out_h,out_w", [(16, 16, 512, 512), (5, 7, 17, 29)],
                         ids=["16x16_to_512", "5x7_to_17x29"])
def test_upsample_argmax_bf16_route_matches_plain(cuda, h, w, out_h, out_w):
    """bf16 logits (the mixed-precision decoder's) take the bf16 entry
    point, on the span path at the flagship's shape and the per-pixel path
    elsewhere; the check's plain version upcasts the same values."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(12, 11, h, w, generator=g).to(cuda, torch.bfloat16)
    before = dict(k1.upsample_argmax.route_launches)
    checks.check_upsample_argmax(x, out_h, out_w)
    assert k1.upsample_argmax.route_launches["bf16"] == before["bf16"] + 2
    assert k1.upsample_argmax.route_launches["f32"] == before["f32"]


def test_upsample_argmax_kernel_refuses_float16(cuda):
    """Named for the refusal it once held: float16 takes its own route now
    (``test_upsample_argmax_f16_route_matches_plain``); float64, which no
    route takes, is refused and launches nothing."""
    x = torch.randn(2, 11, 16, 16, device=cuda, dtype=torch.float64)
    before = dict(k1.upsample_argmax.route_launches)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        k1.upsample_argmax(x, 512, 512)
    assert k1.upsample_argmax.route_launches == before
    checks.check_upsample_argmax(x.half(), 512, 512)
    assert k1.upsample_argmax.route_launches == {**before, "f16": before["f16"] + 2}


@pytest.mark.parametrize("h,w,out_h,out_w", [(16, 16, 512, 512), (5, 7, 17, 29)],
                         ids=["16x16_to_512", "5x7_to_17x29"])
def test_upsample_argmax_f16_route_matches_plain(cuda, h, w, out_h, out_w):
    """float16 logits (the float16 decoder's) take the f16 entry point, on
    the span path at the flagship's shape and the per-pixel path elsewhere;
    the check's plain version upcasts the same values."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(12, 11, h, w, generator=g).to(cuda, torch.float16)
    before = dict(k1.upsample_argmax.route_launches)
    checks.check_upsample_argmax(x, out_h, out_w)
    assert k1.upsample_argmax.route_launches == {**before, "f16": before["f16"] + 2}


@pytest.mark.parametrize("mode", k2.MODES)
def test_comm_fusion_kernel_matches_plain(cuda, mode):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 6, 1024, generator=g).to(cuda)
    k = (torch.randn(2, 6, 1024, generator=g) * 2 / 1024 ** 0.5).to(cuda)  # links survive
    v = torch.randn(2, 6, 512, 16, 16, generator=g).to(cuda)
    before = k2.comm_fusion.launches
    checks.check_comm_fusion(q, k, v, mode, diag_bias=0.001)
    assert k2.comm_fusion.launches == before + 1


@pytest.mark.parametrize("b,n,d,rest,mode", [
    (1, 6, 1024, (512, 16, 16), "activated"), (1, 6, 1024, (512, 16, 16), "argmax"),
    (2, 1, 1000, (64, 16, 16), "softmax"), (2, 1, 1000, (64, 16, 16), "argmax"),
    (20, 6, 37, (257, 4), "softmax"), (20, 6, 37, (257, 4), "activated"),
    (20, 6, 37, (257, 4), "argmax"),
    (2, 16, 5, (3, 100), "softmax"), (2, 16, 5, (3, 100), "activated"),
    (2, 16, 5, (3, 100), "argmax"),
    (20, 16, 1024, (2, 514), "activated")],
    ids=["b1_n6_activated", "b1_n6_argmax", "b2_n1_softmax", "b2_n1_argmax",
         "b20_n6_m1028_softmax", "b20_n6_m1028_activated", "b20_n6_m1028_argmax",
         "b2_n16_m300_softmax", "b2_n16_m300_activated", "b2_n16_m300_argmax",
         "b20_n16_m1028_activated"])
def test_comm_fusion_kernel_other_shapes(cuda, b, n, d, rest, mode):
    """B from 1 to 20, N from 1 to 16 (one agent has no link to keep, so
    ``activated`` is checked from N=6), D shorter than the cluster's eight
    slices, and M (C*h*w) that is no multiple of a CTA's 256 float4 columns."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(b, n, d, generator=g).to(cuda)
    k = (torch.randn(b, n, d, generator=g) * 3 / d ** 0.5).to(cuda)  # links survive
    v = torch.randn(b, n, *rest, generator=g).to(cuda)
    before = k2.comm_fusion.launches
    checks.check_comm_fusion(q, k, v, mode, diag_bias=0.001)
    assert k2.comm_fusion.launches == before + 1


@pytest.mark.parametrize("what", ["non_contiguous", "m_not_a_multiple_of_4"])
def test_comm_fusion_kernel_refuses(cuda, what):
    q, k = (torch.randn(2, 6, 64, device=cuda) for _ in range(2))
    if what == "non_contiguous":
        v, err = torch.randn(2, 6, 16, 16, 8, device=cuda).transpose(2, 4), "contiguous"
    else:
        v, err = torch.randn(2, 6, 3, 5, device=cuda), "M % 4"
    with pytest.raises(ValueError, match=err):
        k2.comm_fusion(q, k, v, mode="softmax")


def test_comm_fusion_kernel_refuses_bf16(cuda):
    """bf16 V streams in 16-byte loads of 8 values: M % 8 != 0 is refused
    (M = 1028 passes float32's M % 4); so are bf16 Q' and K beside a
    float32 V (the kernel takes one type)."""
    q, k = (torch.randn(2, 6, 1024, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    v = torch.randn(2, 6, 2, 514, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="M % 8"):
        k2.comm_fusion(q, k, v, mode="activated")
    with pytest.raises(TypeError, match="all bfloat16"):
        k2.comm_fusion(q, k, v.float(), mode="activated")


def test_comm_fusion_kernel_refuses_float16(cuda):
    """Named for the refusal it once held: float16 takes its own route now,
    checked here at the flagship's shapes; float64 is refused, and float16
    V, like bf16, streams in 16-byte loads of 8 values (M % 8 == 0)."""
    before = dict(k2.comm_fusion.route_launches)
    q, k = (torch.randn(2, 6, 1024, device=cuda, dtype=torch.float64) for _ in range(2))
    v = torch.randn(2, 6, 512, 16, 16, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="all float16"):
        k2.comm_fusion(q, k, v, mode="activated")
    with pytest.raises(ValueError, match="M % 8"):
        k2.comm_fusion(q.half(), k.half(), torch.randn(2, 6, 2, 514, device=cuda).half(),
                       mode="activated")
    assert k2.comm_fusion.route_launches == before
    k = k * 2 / 1024 ** 0.5  # links survive
    checks.check_comm_fusion(q.half(), k.half(), v.half(), "activated", diag_bias=0.001)
    assert k2.comm_fusion.route_launches == {**before, "f16": before["f16"] + 1}


@pytest.mark.parametrize("b,n,d,rest,mode", [
    (2, 6, 1024, (512, 16, 16), "softmax"), (2, 6, 1024, (512, 16, 16), "activated"),
    (2, 6, 1024, (512, 16, 16), "argmax"), (16, 6, 1024, (512, 16, 16), "activated"),
    (20, 6, 37, (257, 8), "activated"), (2, 16, 5, (3, 104), "argmax"),
    (2, 1, 1000, (64, 16, 16), "softmax")],
    ids=["flagship_softmax", "flagship_activated", "flagship_argmax", "b16_activated",
         "b20_n6_m2056_activated", "b2_n16_m312_argmax", "b2_n1_softmax"])
def test_comm_fusion_bf16_route_matches_plain(cuda, b, n, d, rest, mode):
    """bf16 Q', K and V take the bf16 entry point: the flagship's shapes at
    the YAML's batch and the bench's (16), D shorter than the cluster's
    slices and unaligned to 8, M no multiple of a CTA's columns, 1 to 16
    agents. Fused within one bf16 ulp + 1e-5 of the plain version."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(b, n, d, generator=g).to(cuda, torch.bfloat16)
    k = (torch.randn(b, n, d, generator=g) * 3 / d ** 0.5).to(cuda, torch.bfloat16)
    v = torch.randn(b, n, *rest, generator=g).to(cuda, torch.bfloat16)
    before = dict(k2.comm_fusion.route_launches)
    checks.check_comm_fusion(q, k, v, mode, diag_bias=0.001)
    assert k2.comm_fusion.route_launches["bf16"] == before["bf16"] + 1
    assert k2.comm_fusion.route_launches["f32"] == before["f32"]


@pytest.mark.parametrize("b,n,d,rest,mode", [
    (2, 6, 1024, (512, 16, 16), "softmax"), (2, 6, 1024, (512, 16, 16), "activated"),
    (2, 6, 1024, (512, 16, 16), "argmax"), (16, 6, 1024, (512, 16, 16), "activated"),
    (20, 6, 37, (257, 8), "activated"), (2, 16, 5, (3, 104), "argmax"),
    (2, 1, 1000, (64, 16, 16), "softmax")],
    ids=["flagship_softmax", "flagship_activated", "flagship_argmax", "b16_activated",
         "b20_n6_m2056_activated", "b2_n16_m312_argmax", "b2_n1_softmax"])
def test_comm_fusion_f16_route_matches_plain(cuda, b, n, d, rest, mode):
    """float16 Q', K and V take the f16 entry point at bf16's shapes. Fused
    within one float16 ulp + 1e-5 of the plain version and of float64."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(b, n, d, generator=g).to(cuda, torch.float16)
    k = (torch.randn(b, n, d, generator=g) * 3 / d ** 0.5).to(cuda, torch.float16)
    v = torch.randn(b, n, *rest, generator=g).to(cuda, torch.float16)
    before = dict(k2.comm_fusion.route_launches)
    checks.check_comm_fusion(q, k, v, mode, diag_bias=0.001)
    assert k2.comm_fusion.route_launches["f16"] == before["f16"] + 1
    assert k2.comm_fusion.route_launches["f32"] == before["f32"]


WIDE_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["f32", "bf16", "f16"])
def test_comm_fusion_wide_design_matches_plain(cuda, dtype):
    """K2 beyond 16 agents (the wide design) at the agent counts and value
    maps of chip_smoke.py phase 18 (a), in every mode: graphs within 1e-6
    of float64, masks equal with links kept and argmax ties to the lowest
    key, fused by the type's rule. Every call launches the wide design."""
    before = dict(k2.comm_fusion.design_launches)
    errs = checks.check_comm_fusion_wide(torch.Generator().manual_seed(18), cuda, dtype)
    calls = 3 * len(checks.WIDE_AGENTS) * len(checks.WIDE_MAPS)
    assert k2.comm_fusion.design_launches == {**before, "wide": before["wide"] + calls}
    assert len(errs) == len(checks.WIDE_AGENTS) * len(checks.WIDE_MAPS)


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["f32", "bf16", "f16"])
def test_comm_fusion_takes_every_agent_count(cuda, dtype):
    """N from 1 to 200: none refused, the cluster design up to 16 agents and
    the wide one above (each call's design counted by the check)."""
    got = checks.check_comm_fusion_every_n(torch.Generator().manual_seed(19), cuda, dtype)
    assert got["designs"] == {"cluster": 16, "wide": 184}


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["f32", "bf16", "f16"])
def test_comm_fusion_wide_design_ragged(cuda, dtype):
    """The wide design at a D no multiple of anything (37), a ragged M of
    13 packs and more keys than a fusion CTA stages at once (65, 130)."""
    m = 13 * k2.ROUTES[dtype][2]
    checks.check_comm_fusion_wide(torch.Generator().manual_seed(20), cuda, dtype,
                                  agents=(17, 65, 130), maps=((m,),), d=37)


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["f32", "bf16", "f16"])
def test_comm_fusion_wide_design_at_tile_edges(cuda, dtype):
    """The wide design at every edge of its tiles (checks.WIDE_EDGE_AGENTS:
    8-query graph clusters, 16-key mma steps, 32- and 64-query fusion tiles,
    64-key chunks) on the sweep's value maps and on an M that no fusion
    CTA's 128 columns divide (13 packs), every mode with argmax ties."""
    m = 13 * k2.ROUTES[dtype][2]
    errs = checks.check_comm_fusion_wide(torch.Generator().manual_seed(22), cuda, dtype,
                                         agents=checks.WIDE_EDGE_AGENTS,
                                         maps=((512, 8, 8), (m,)))
    assert len(errs) == 2 * len(checks.WIDE_EDGE_AGENTS)


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["f32", "bf16", "f16"])
def test_comm_fusion_wide_design_at_d37_and_beyond_shared_memory(cuda, dtype):
    """D = 37 (no 16-byte loads: the graph stages by value) at the tile
    edges, and N = checks.WIDE_BEYOND: the graph CTA keeps its logits in
    soft and coef, and the fusion CTA streams V's rows again per query
    tile."""
    m = 13 * k2.ROUTES[dtype][2]
    errs = checks.check_comm_fusion_wide(
        torch.Generator().manual_seed(23), cuda, dtype,
        agents=checks.WIDE_EDGE_AGENTS + (checks.WIDE_BEYOND,), maps=((m,),), d=37)
    assert f"{checks.WIDE_BEYOND}x{m}" in errs


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["f32", "bf16", "f16"])
def test_comm_fusion_wide_design_returns_the_same_bits(cuda, dtype):
    """Two calls on the same inputs give the same bits in every output, at
    N = 24, 48 and 200 in every mode: no sum depends on timing."""
    got = checks.check_comm_fusion_repeatable(torch.Generator().manual_seed(24), cuda, dtype)
    assert sorted(got) == [24, 48, 200]


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["f32", "bf16", "f16"])
def test_comm_fusion_wide_design_replays_in_a_cuda_graph(cuda, dtype):
    """The two kernels (the fusion one a programmatic dependent launch of
    the graph one) captured in a CUDA graph and replayed on new inputs
    equal an eager call bit for bit, in every mode."""
    got = checks.check_comm_fusion_graph_replay(torch.Generator().manual_seed(25), dtype)
    assert got["launches"] == 3 * len(k2.MODES)


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["f32", "bf16", "f16"])
def test_upsample_argmax_at_wide_logits(cuda, dtype):
    """K1 where 16 staged rows exceed 48 KB (C = 11 at w = 70 and 96, C = 32
    at w = 32: opted in), where a block stages 8, 4, 2 and 1 rows, and where
    one row exceeds what a block holds (C = 64 at w = 1024: the direct
    kernel), against its plain version."""
    before = k1.upsample_argmax.launches
    got = checks.check_upsample_argmax_wide(torch.Generator().manual_seed(21), cuda, dtype)
    assert [r["rows"] for r in got.values()] == [16, 16, 16, 8, 4, 2, 1, 0]
    assert k1.upsample_argmax.launches == before + 2 * len(checks.K1_WIDE_SHAPES)


@pytest.mark.parametrize("dtype,b,hw,c", [(torch.float32, 12, 128, 64),
                                          (torch.float32, 12, 64, 128),
                                          (torch.bfloat16, 24, 128, 64),
                                          (torch.bfloat16, 24, 64, 128),
                                          (torch.float32, 2, 20, 256),
                                          (torch.bfloat16, 2, 9, 512)],
                         ids=["f32_c64", "f32_c128", "bf16_c64", "bf16_c128", "f32_c256_odd",
                              "bf16_c512_odd"])
def test_fused_block_kernel_matches_plain(cuda, dtype, b, hw, c):
    x, params = block_inputs(b, hw, hw + 3, c, dtype, cuda)
    before = k3.fused_basic_block.launches
    route = k3.route(dtype, c)
    before_route = k3.fused_basic_block.route_launches[route]
    _check_block(x, params)
    assert k3.fused_basic_block.launches == before + 1
    assert k3.fused_basic_block.route_launches[route] == before_route + 1


@pytest.mark.parametrize("b,h,w,c", [(1, 16, 16, 64), (1, 8, 16, 128), (2, 37, 45, 64),
                                     (2, 37, 45, 128), (1, 5, 7, 64), (1, 7, 13, 128)],
                         ids=["c64_one_tile", "c128_one_tile", "c64_ragged", "c128_ragged",
                              "c64_smaller_than_a_tile", "c128_smaller_than_a_tile"])
def test_fused_block_wgmma_route_matches_plain(cuda, b, h, w, c):
    """bfloat16 at C = 64/128 takes the wgmma kernel: B = 1, H and W that
    are no multiple of the tile (16x16 at C=64, 8x16 at C=128), so TMA
    fills the halo past the image with zeros, and images smaller than one
    tile."""
    x, params = block_inputs(b, h, w, c, torch.bfloat16, cuda, seed=1)
    before = dict(k3.fused_basic_block.route_launches)
    checks.check_fused_block(x, *params)
    assert k3.fused_basic_block.route_launches == {**before, "wgmma": before["wgmma"] + 1}


@pytest.mark.parametrize("b,h,w,c", [(1, 16, 16, 64), (1, 8, 16, 128), (1, 5, 7, 64),
                                     (1, 5, 7, 128), (1, 7, 13, 64), (1, 7, 13, 128),
                                     (1, 37, 45, 64), (1, 37, 45, 128)],
                         ids=["c64_one_tile", "c128_one_tile", "c64_5x7", "c128_5x7",
                              "c64_7x13", "c128_7x13", "c64_37x45", "c128_37x45"])
def test_fused_block_tf32x3_route_matches_plain(cuda, b, h, w, c):
    """float32 at C = 64/128 takes the 3xTF32 kernel, held to the float32
    check (rtol/atol 1e-4): B = 1, images smaller than a tile (16x16 at
    C=64, 8x16 at C=128), and H, W that are no multiple of it."""
    x, params = block_inputs(b, h, w, c, torch.float32, cuda, seed=1)
    before = dict(k3.fused_basic_block.route_launches)
    checks.check_fused_block(x, *params)
    assert k3.fused_basic_block.route_launches == {**before, "tf32x3": before["tf32x3"] + 1}


def _check_block(x, params, more_seeds=()) -> None:
    """checks.check_fused_block; in bfloat16 at C >= 256 also the far-bound
    rule against float64, summed over this input and ``more_seeds``."""
    got = checks.check_fused_block(x, *params)
    if "beyond_far_from_float64" in got:
        b, h, w, c = x.shape
        results = [got]
        for seed in more_seeds:
            xs, ps = block_inputs(b, h, w, c, x.dtype, x.device, seed=seed)
            results.append(checks.check_fused_block(xs, *ps))
        checks.assert_far_no_worse(results)


WIDE_CASES = [(1, 5, 7), (1, 9, 12), (2, 20, 23), (1, 37, 45)]
WIDE_IDS = ["5x7", "9x12", "b2_20x23", "37x45"]


@pytest.mark.parametrize("c", [256, 512])
@pytest.mark.parametrize("b,h,w", [*WIDE_CASES, (1, 8, 16), ("bench", 0, 0)],
                         ids=[*WIDE_IDS, "one_tile", "bench"])
def test_fused_block_wgmma_conv_route_matches_plain(cuda, b, h, w, c):
    """bfloat16 at C = 256/512 takes the wgmma_conv kernels (two launches a
    block), held by checks.assert_bf16_wide: B = 1, an image smaller than a
    tile (8x16), one tile, H and W that are no multiple of it, and the
    bench geometry (B*N = 120 at 32x32 or 16x16, seeds 0 and 6 summed)."""
    more = ()
    if b == "bench":
        b, h, w, more = 120, 8192 // c, 8192 // c, (6,)
    x, params = block_inputs(b, h, w, c, torch.bfloat16, cuda, seed=0 if more else 1)
    before = dict(k3.fused_basic_block.route_launches)
    _check_block(x, params, more)
    assert k3.fused_basic_block.route_launches == {
        **before, "wgmma_conv": before["wgmma_conv"] + 1 + len(more)}


@pytest.mark.parametrize("c", [256, 512])
@pytest.mark.parametrize("b,h,w", [*WIDE_CASES, (1, 8, 8), ("eval", 0, 0)],
                         ids=[*WIDE_IDS, "one_tile", "eval"])
def test_fused_block_tf32x3_conv_route_matches_plain(cuda, b, h, w, c):
    """float32 at C = 256/512 takes the tf32x3_conv kernels (two launches a
    block), held to rtol/atol 1e-4: B = 1, an image smaller than a tile
    (8x8), one tile, H and W that are no multiple of it, and the eval
    geometry (B*N = 12 at 32x32 or 16x16)."""
    if b == "eval":
        b, h, w = 12, 8192 // c, 8192 // c
    x, params = block_inputs(b, h, w, c, torch.float32, cuda, seed=1)
    before = dict(k3.fused_basic_block.route_launches)
    _check_block(x, params)
    assert k3.fused_basic_block.route_launches == {
        **before, "tf32x3_conv": before["tf32x3_conv"] + 1}


@pytest.mark.parametrize("c", [256, 512])
@pytest.mark.parametrize("route,reference", [("wgmma_conv", k3.wgmma_conv_weights),
                                             ("tf32x3_conv", k3.tf32x3_conv_weights)],
                         ids=["wgmma_conv", "tf32x3_conv"])
def test_conv_weights_arranged_on_the_card(cuda, route, reference, c):
    """The conv routes' entry points arrange the HWIO weights on the card
    into their scratch tensor exactly as the layout's reference in
    fused_block.py does (bf16 rounding; TF32 hi/lo split)."""
    import ctypes

    from multiagentperception_tpu_torch.ops.kernels import _build

    dtype = torch.bfloat16 if route == "wgmma_conv" else torch.float32
    x, (w1, s1, b1, w2, s2, b2) = block_inputs(1, 8, 16, c, dtype, cuda, seed=2)
    per_cc, wk_dtype = k3.WEIGHT_SCRATCH[route]
    wk = torch.empty(per_cc * c * c, dtype=wk_dtype, device=cuda)
    y1, out = torch.empty_like(x), torch.empty_like(x)
    sb = torch.cat([s1, b1, s2, b2])
    source, entry = k3.KERNELS[route]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = getattr(_build.load(source), entry)(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), wk.data_ptr(), sb.data_ptr(), y1.data_ptr(),
        out.data_ptr(), 1, 8, 16, c, stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = reference(w1, w2).flatten()
    assert torch.equal(wk.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("what", ["non_contiguous", "channels_96", "float16"])
def test_fused_block_kernel_refuses(cuda, what):
    c = 96 if what == "channels_96" else 64
    x, params = block_inputs(1, 16, 16, c, torch.float32, cuda)
    if what == "non_contiguous":
        x, err = x.transpose(1, 2), "contiguous"
    elif what == "float16":
        x, err = x.half(), "float32 or bfloat16"
    else:
        err = "C in"
    with pytest.raises((ValueError, TypeError), match=err):
        k3.fused_basic_block(x, *params)


def test_one_training_step_on_the_card(cuda):
    """A small MIMOcom takes one Adam step on the card: finite loss, and
    parameters that moved."""
    import numpy as np

    from multiagentperception_tpu_torch.config import normalize_config
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import init_weights
    from multiagentperception_tpu_torch.trainer import Trainer

    cfg = normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": 3, "query_size": 8, "key_size": 64,
                  "multiple_output": True},
        "data": {"img_rows": 128, "img_cols": 128, "commun_label": "mimo"},
        "training": {"batch_size": 2, "optimizer": {"name": "adam", "lr": 1e-4}}})
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device=cuda)
    init_weights(trainer.model, 0)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    rng = np.random.default_rng(0)
    x, y = trainer._batch((rng.standard_normal((2, 3, 128, 128, 3)) * 0.5).astype(np.float32),
                          rng.integers(0, 11, (2, 3, 128, 128)).astype(np.int32))
    loss = float(trainer.train_step(x, y))
    assert np.isfinite(loss) and trainer.step == 1
    moved = [n for n, p in trainer.model.named_parameters() if not torch.equal(p, before[n])]
    assert len(moved) > 100


ZOO = {"Single_agent": {}, "All_agents": {"shuffle_features": "selection"},
       "MIMO_All_agents": {"shuffle_features": "selection"}, "MIMOcom": {},
       "MIMOcomWho": {"query": False}, "LearnWhen2Com": {},
       "LearnWho2Com": {"shared_img_encoder": "only_normal_agents"}}
MRMS = {"Single_agent", "MIMO_All_agents", "MIMOcom", "MIMOcomWho"}


@pytest.mark.parametrize("arch", ZOO)
def test_eval_step_of_every_arch_launches_k1(cuda, arch, monkeypatch):
    """One eval step of each architecture (3 agents at 128x128) on the card:
    the class map comes from K1, which launches once, and the evaluator
    hands its wrapper a card tensor (a CPU one would take the plain
    version). The confusion matrix counts every labelled pixel."""
    import numpy as np

    from multiagentperception_tpu_torch import evaluate
    from multiagentperception_tpu_torch.config import normalize_config
    from multiagentperception_tpu_torch.models import init_weights

    mrms = arch in MRMS
    cfg = normalize_config({
        "model": {"arch": arch, "agent_num": 3, "query_size": 8, "key_size": 64,
                  "multiple_output": mrms, **ZOO[arch]},
        "data": {"img_rows": 128, "img_cols": 128,
                 "commun_label": "mimo" if mrms else "when2com"}})
    ev = evaluate.Evaluator(cfg, device=cuda)
    init_weights(ev.model, 0)
    devices = []
    wrapper = evaluate.class_map  # K1's wrapper where the decoder has pre-upsample logits

    def spy(x, out_h, out_w):
        devices.append(x.device.type)
        return wrapper(x, out_h, out_w)

    monkeypatch.setattr(evaluate, "class_map", spy)
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((2, 3, 128, 128, 3)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 11, (2, 3, 128, 128)).astype(np.int32)
    commun = (np.stack([rng.integers(0, 2, (2, 3)), rng.integers(0, 3, (2, 3))], axis=1)
              if mrms else rng.integers(-1, 2, (2,)))
    before = k1.upsample_argmax.launches
    res = ev.eval_step(images, labels, commun)
    torch.cuda.synchronize()
    assert k1.upsample_argmax.launches == before + 1
    assert devices == ["cuda"]
    assert int(res["hist"].sum()) == (labels.size if mrms and arch != "All_agents"
                                      else labels[:, 0].size)
    assert int(res["hist_pos"].sum() + res["hist_neg"].sum()) == int(res["hist"].sum())


def _mixed_eval_step(cuda, arch: str, dtype: str) -> None:
    """One eval step of ``arch`` with ``model.dtype: dtype`` on the card: K1
    takes the 16-bit logits on the dtype's route, MIMOcom's ``activated``
    step runs K2's, and no other route runs."""
    import numpy as np

    from multiagentperception_tpu_torch import evaluate
    from multiagentperception_tpu_torch.config import normalize_config
    from multiagentperception_tpu_torch.models import init_weights

    mrms = arch in MRMS
    cfg = normalize_config({
        "model": {"arch": arch, "agent_num": 3, "query_size": 8, "key_size": 64,
                  "multiple_output": mrms, "dtype": dtype, **ZOO[arch]},
        "data": {"img_rows": 128, "img_cols": 128,
                 "commun_label": "mimo" if mrms else "when2com"}})
    ev = evaluate.Evaluator(cfg, device=cuda)
    init_weights(ev.model, 0)
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((2, 3, 128, 128, 3)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 11, (2, 3, 128, 128)).astype(np.int32)
    route = k1.ROUTES[getattr(torch, dtype)][0]
    k1_before = dict(k1.upsample_argmax.route_launches)
    k2_before = dict(k2.comm_fusion.route_launches)
    res = ev.eval_step(images, labels)
    torch.cuda.synchronize()
    assert k1.upsample_argmax.route_launches == {**k1_before, route: k1_before[route] + 1}
    k2_runs = 1 if arch == "MIMOcom" else 0
    assert k2.comm_fusion.route_launches == {**k2_before, route: k2_before[route] + k2_runs}
    assert int(res["hist"].sum()) == (labels.size if mrms and arch != "All_agents"
                                      else labels[:, 0].size)


@pytest.mark.parametrize("arch", ZOO)
def test_bf16_eval_step_of_every_arch_takes_the_bf16_routes(cuda, arch):
    """``_mixed_eval_step`` in bfloat16."""
    _mixed_eval_step(cuda, arch, "bfloat16")


@pytest.mark.parametrize("arch", ZOO)
def test_f16_eval_step_of_every_arch_takes_the_f16_routes(cuda, arch):
    """``_mixed_eval_step`` in float16: finite class maps from K1's f16 route."""
    _mixed_eval_step(cuda, arch, "float16")


def test_mixed_precision_training_step_on_the_card(cuda):
    """A small MIMOcom with ``training.mixed_precision`` takes one Adam step
    on the card: finite float32 loss and gradients, float32 parameters and
    BatchNorm statistics that moved."""
    _mixed_train_step(cuda, {"mixed_precision": True})


def test_float16_training_step_on_the_card(cuda):
    """The same with ``model.dtype: float16``, no loss scaling (JAX has none)."""
    _mixed_train_step(cuda, {"dtype": "float16"})


def _mixed_train_step(cuda, keys: dict) -> None:
    import numpy as np

    from multiagentperception_tpu_torch.config import normalize_config
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import init_weights
    from multiagentperception_tpu_torch.trainer import Trainer

    model = {"arch": "MIMOcom", "agent_num": 3, "query_size": 8, "key_size": 64,
             "multiple_output": True, **{k: v for k, v in keys.items() if k == "dtype"}}
    cfg = normalize_config({
        "model": model,
        "data": {"img_rows": 128, "img_cols": 128, "commun_label": "mimo"},
        "training": {"batch_size": 2, "mixed_precision": bool(keys.get("mixed_precision")),
                     "optimizer": {"name": "adam", "lr": 1e-4}}})
    trainer = Trainer(cfg, None, get_loss_function(cfg), None, None, device=cuda)
    init_weights(trainer.model, 0)
    before = {n: v.detach().clone() for n, v in trainer.model.state_dict().items()}
    rng = np.random.default_rng(0)
    x, y = trainer._batch((rng.standard_normal((2, 3, 128, 128, 3)) * 0.5).astype(np.float32),
                          rng.integers(0, 11, (2, 3, 128, 128)).astype(np.int32))
    loss = trainer.train_step(x, y)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert all(p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all())
               for p in trainer.model.parameters() if p.grad is not None)
    state = trainer.model.state_dict()
    floats = {n: v for n, v in state.items() if v.is_floating_point()}
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in floats.values())
    moved = [n for n, v in floats.items() if not torch.equal(v, before[n])]
    assert len(moved) > 100 and any(n.endswith("running_var") for n in moved)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_eval_on_the_card(cuda, dtype):
    """The bench's eval at a small batch (2 x 3 agents at 128x128): K1 and
    K2 launch once per step on the dtype's route (``bench_eval`` raises
    otherwise), and the trace holds device time for both."""
    from multiagentperception_tpu_torch import bench

    r = bench.bench_eval(batch=2, img=128, agents=3, k_lo=1, k_hi=3, dtype=dtype,
                         device=cuda)
    route = bench.ROUTE[dtype]
    assert r["steps"] == 4 * (1 + 3) + 3  # warm-up and three timed runs per length, the trace
    for name in ("upsample_argmax", "comm_fusion"):
        assert r["route_launches"][name][route] == r["steps"], name
    assert r["device_ms"] > 0 and 0 < r["busy"] <= 1.05
    assert set(r["kernel_device_ms"]) == {"upsample_argmax", "comm_fusion"}


def test_remat_train_step_on_the_card(cuda):
    """One bf16 ``Trainer`` step of a small MIMOcom with ``model.remat``
    against one without, from the same weights and batch: the loss and the
    BatchNorm buffers equal within rtol 1e-5 (both come from the first
    forward, the same kernels on the same values), the running statistics
    updated once (``num_batches_tracked`` 1), every gradient finite."""
    import numpy as np

    from multiagentperception_tpu_torch.config import normalize_config
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import get_model, init_weights
    from multiagentperception_tpu_torch.trainer import Trainer

    def cfg(remat):
        return normalize_config({
            "model": {"arch": "MIMOcom", "agent_num": 3, "query_size": 8, "key_size": 64,
                      "multiple_output": True, "remat": remat},
            "data": {"img_rows": 128, "img_cols": 128, "commun_label": "mimo"},
            "training": {"batch_size": 2, "mixed_precision": True,
                         "optimizer": {"name": "adam", "lr": 1e-4}}})

    state = init_weights(get_model(cfg(False), 11), 0).state_dict()
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((2, 3, 128, 128, 3)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 11, (2, 3, 128, 128)).astype(np.int32)
    out = {}
    for remat in (False, True):
        trainer = Trainer(cfg(remat), None, get_loss_function(cfg(remat)), None, None,
                          device=cuda)
        trainer.model.load_state_dict(state)
        loss = trainer.train_step(*trainer._batch(images, labels))
        assert all(bool(torch.isfinite(p.grad).all()) for p in trainer.model.parameters())
        out[remat] = (float(loss), {n: b.cpu() for n, b in trainer.model.named_buffers()})
    (loss0, bufs0), (loss1, bufs1) = out[False], out[True]
    assert loss1 == pytest.approx(loss0, rel=1e-5)
    for name, buf in bufs0.items():
        if name.endswith("num_batches_tracked"):
            assert int(buf) == int(bufs1[name]) == 1, name
        else:
            torch.testing.assert_close(bufs1[name], buf, rtol=1e-5, atol=1e-6, msg=name)


# ------------------------------------------------------------------ K4: int8_conv

# (Cin, Cout, side, kernel, stride, padding, bias, images, GEMM route): every
# route of the kernel at ragged geometry. M not a multiple of the 128-pixel
# tile (every one but multi_*), Cout 72 (a partial NB) and 512 (two N
# slices), sides 5 and 8 (tiles wider than the image; the 16 x 8 halo
# tile), Cin 16 and 48 (one and three 16-channel planes of a 64-channel
# chunk), the stem (space to depth, odd side), Cin 3 and 8 (16 channels,
# the rest zero) on the halo and the gather, a 41x41 stride-2 kernel whose
# s2d halo would not fit (the gather), stride 2, 3 and 1x1, and tiles
# enough that every CTA takes several (the warpgroups' turns at NB 64 and
# 128; both on one tile at NB 256)
K4_CONVS = {
    "stem_7x7s2_cin3": (3, 64, 67, 7, 2, 3, False, 3, "s2d"),
    "s2d_3x3s2_cin4": (4, 32, 20, 3, 2, 1, True, 3, "s2d"),
    "halo_cin3_s1": (3, 16, 9, 3, 1, 1, False, 3, "halo"),
    "halo_cin8": (8, 24, 11, 3, 1, 1, True, 3, "halo"),
    "gather16_cin8_1x1": (8, 24, 11, 1, 1, 0, True, 3, "gather16"),
    "gather16_cin3_7x7s1": (3, 64, 21, 7, 1, 3, False, 3, "gather16"),
    "gather16_cin3_41x41s2": (3, 16, 45, 41, 2, 20, False, 2, "gather16"),
    "3x3s1": (64, 64, 19, 3, 1, 1, False, 3, "halo"),
    "3x3s1_bias_ragged": (512, 72, 5, 3, 1, 1, True, 3, "halo"),
    "halo_side8_cout512": (256, 512, 8, 3, 1, 1, False, 3, "halo"),
    "cin16_bias": (16, 24, 9, 3, 1, 1, True, 3, "halo"),
    "cin48": (48, 40, 10, 3, 1, 1, False, 3, "halo"),
    "3x3s2": (128, 256, 17, 3, 2, 1, False, 3, "gather16"),
    "1x1s2": (64, 128, 17, 1, 2, 0, False, 3, "gather16"),
    "5x5s1": (32, 64, 12, 5, 1, 2, True, 3, "gather16"),
    "3x3s3": (16, 32, 13, 3, 3, 1, False, 3, "gather16"),
    "multi_halo64": (64, 64, 128, 3, 1, 1, False, 3, "halo"),
    "multi_halo512": (256, 512, 32, 3, 1, 1, False, 12, "halo"),
    "multi_gather512": (256, 512, 32, 3, 2, 1, False, 48, "gather16"),
    "multi_gather128": (64, 128, 64, 1, 2, 0, True, 40, "gather16"),
    "multi_stem": (3, 64, 256, 7, 2, 3, False, 4, "s2d"),
    "multi_halo128_cout96": (128, 96, 64, 3, 1, 1, True, 5, "halo"),
    "multi_halo256_cout200": (64, 200, 64, 3, 1, 1, False, 5, "halo"),
    "multi_halo256_side8": (256, 256, 8, 3, 1, 1, True, 140, "halo"),
    # the flagship's 3x3 stride-4 squeezer (model.feat_squeezer 4) at 512x512
    "squeezer_3x3s4": (512, 512, 16, 3, 4, 1, True, 12, "gather16")}


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", list(K4_CONVS))
def test_int8_conv_kernel_matches_plain(cuda, name, dtype, static):
    """Operands, int32 sums and outputs to the bit (``checks.check_int8_conv``;
    float16 also within one float16 ulp of the float32 rescale)."""
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4

    cin, cout, side, k, stride, pad, bias, n, route = K4_CONVS[name]
    assert k4.plan(n, cin, side, side, cout, k, k, stride, pad).route == route
    gen = torch.Generator().manual_seed(cin + cout + side)
    out_dtype = getattr(torch, dtype)
    x = torch.randn(n, cin, side, side, generator=gen).to(
        cuda, torch.float32 if cin == 3 else out_dtype)
    w = (torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5).to(cuda)
    b = torch.randn(cout, generator=gen).to(cuda) if bias else None
    s_x = torch.tensor(0.8 * float(x.float().abs().amax()) / 127, device=cuda) if static else None
    before, routed = k4.int8_conv.launches, k4.int8_conv.geometry_launches[route]
    checks.check_int8_conv(x, w, b, stride, pad, s_x, out_dtype)
    assert k4.int8_conv.launches == before + 2  # the sums, then the output
    assert k4.int8_conv.geometry_launches[route] == routed + 2


@pytest.mark.parametrize("what", ["groups", "dilation", "float16", "mismatch", "bias16",
                                  "scale", "not_contiguous"])
def test_int8_conv_kernel_refuses(cuda, what):
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4

    x = torch.randn(2, 16, 8, 8, device=cuda)
    w = k4.prepare_weight(torch.randn(32, 16, 3, 3, device=cuda))
    kw, err = {"padding": 1}, ValueError
    if what == "groups":
        kw["groups"] = 2
    elif what == "dilation":
        kw["dilation"] = 2
    elif what == "float16":  # the case's old input, now ported: float64 is refused
        x, err = x.double(), TypeError
    elif what == "mismatch":
        w = k4.prepare_weight(torch.randn(32, 16, 3, 3))
    elif what == "bias16":
        kw["bias"], err = torch.randn(32, device=cuda).bfloat16(), TypeError
    elif what == "scale":
        kw["s_x"], err = torch.ones(2, device=cuda), TypeError
    else:
        x = x.permute(0, 1, 3, 2)
    before = k4.int8_conv.launches
    with pytest.raises(err):
        k4.int8_conv(x, w, **kw)
    assert k4.int8_conv.launches == before


def test_int8_eval_on_the_card_launches_k4_per_conv(cuda):
    """A small MIMOcom's int8 eval through ``Evaluator.evaluate(int8=True)``
    on the card: K4 once per swapped conv call (48 a batch), K1 and K2 on
    their route, and the class maps within 1% of the pixels of the CPU's
    int8 eval from the same weights and scales (chip_smoke.py
    ``int8_card_vs_cpu`` says why not closer)."""
    import numpy as np

    from multiagentperception_tpu_torch.config import normalize_config
    from multiagentperception_tpu_torch.evaluate import Evaluator
    from multiagentperception_tpu_torch.models import get_model, init_weights
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
    from multiagentperception_tpu_torch.quantize import Int8Convs

    cfg = normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": 3, "query_size": 8, "key_size": 64,
                  "multiple_output": True},
        "data": {"img_rows": 128, "img_cols": 128, "commun_label": "mimo"},
        "training": {"batch_size": 2}})
    state = init_weights(get_model(cfg, 11), 0).state_dict()
    rng = np.random.default_rng(0)
    batches = [((rng.standard_normal((2, 3, 128, 128, 3)) * 0.5).astype(np.float32),
                rng.integers(0, 11, (2, 3, 128, 128)).astype(np.int32),
                rng.integers(0, 2, (2, 2, 3)).astype(np.int64)) for _ in range(3)]
    metrics = {}
    for dev in ("cuda", "cpu"):
        ev = Evaluator(cfg, device=dev)
        ev.model.load_state_dict(state)
        if dev == "cuda":
            before = k4.int8_conv.launches
            ev.evaluate(batches[1:], int8=True, calib_loader=batches[:1])
            assert k4.int8_conv.launches - before == ev.int8_convs.calls == 48 * 2
            scales = ev.int8_convs.act_scales
        else:
            with Int8Convs(ev.model, scales):
                ev.evaluate(batches[1:])
        metrics[dev] = ev.last_eval_metrics.confusion_matrix.astype(np.int64)
    moved = np.abs(metrics["cuda"] - metrics["cpu"]).sum() // 2
    assert moved <= 0.01 * metrics["cpu"].sum()


# ------------------------------------------------------------------ the ops and the serving export

def test_upsample_argmax_op_launches_and_counts(cuda):
    """``torch.ops.when2com.upsample_argmax`` called directly, not through
    the wrapper: its CUDA implementation launches K1 and counts."""
    x = torch.randn(12, 11, 16, 16, generator=torch.Generator().manual_seed(6)).to(cuda)
    before = k1.upsample_argmax.launches
    checks.check_upsample_argmax(x, 512, 512, fn=torch.ops.when2com.upsample_argmax)
    assert k1.upsample_argmax.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_comm_fusion_op_launches_and_counts(cuda, dtype):
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, 6, 1024, generator=g).to(cuda, dtype)
    k = (torch.randn(2, 6, 1024, generator=g) * 2 / 1024 ** 0.5).to(cuda, dtype)
    v = torch.randn(2, 6, 512, 16, 16, generator=g).to(cuda, dtype)
    before = dict(k2.comm_fusion.route_launches)
    checks.check_comm_fusion(q, k, v, "activated", 0.001, fn=torch.ops.when2com.comm_fusion)
    route = k2.ROUTES[dtype][0]
    assert k2.comm_fusion.route_launches == {**before, route: before[route] + 1}


@pytest.mark.parametrize("name", ["stem_7x7s2_cin3", "3x3s1", "3x3s2", "multi_halo64"])
def test_int8_ops_launch_and_count(cuda, name):
    """K4's two ops called directly: the scratch, the sums and the output
    equal their plain versions; the GEMM op counts its launches."""
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4

    cin, cout, side, k, stride, pad, bias, n, route = K4_CONVS[name]
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(n, cin, side, side, generator=gen).to(cuda)
    w = (torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5).to(cuda)
    b = torch.randn(cout, generator=gen).to(cuda) if bias else None
    before, routed = k4.int8_conv.launches, k4.int8_conv.geometry_launches[route]
    checks.check_int8_conv(x, w, b, stride, pad, None, torch.float32, ops=True)
    assert k4.int8_conv.launches == before + 2
    assert k4.int8_conv.geometry_launches[route] == routed + 2


def _toy_mimocom(device, size: int = 128):
    from multiagentperception_tpu_torch.config import normalize_config
    from multiagentperception_tpu_torch.models import get_model, init_weights

    cfg = normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": 3, "query_size": 8, "key_size": 64,
                  "multiple_output": True},
        "data": {"img_rows": size, "img_cols": size}})
    model = init_weights(get_model(cfg, 11), 0).to(device).eval()
    x = torch.randn(2, 3, size, size, 3, generator=torch.Generator().manual_seed(8)) * 0.5
    return model, x.to(device)


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_serving_artifact_on_the_card(cuda, int8):
    """An artifact exported on the card runs there: tracing launches
    nothing, the call launches K1 and K2 once (and K4 48 times in int8), and
    its outputs equal the eager serving function's."""
    from multiagentperception_tpu_torch import quantize as tq
    from multiagentperception_tpu_torch.export import export_serving, load_serving, make_eval_fn
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4

    model, x = _toy_mimocom(cuda)
    scales = tq.calibrate_activations(model, [x], inference="activated", full_res=False) \
        if int8 else None
    kernels = (k1.upsample_argmax, k2.comm_fusion, k4.int8_conv)
    before = [kern.launches for kern in kernels]
    artifact = load_serving(export_serving(model, tuple(x.shape), int8=int8, act_scales=scales))
    assert [kern.launches for kern in kernels] == before  # the trace ran the fake kernels
    cls, prob, nc = artifact(x)
    assert [kern.launches - b for kern, b in zip(kernels, before)] == [1, 1, 48 if int8 else 0]
    eager = tq.make_int8_eval_fn(model, act_scales=scales) if int8 else make_eval_fn(model)
    want = eager(x)
    assert torch.equal(cls, want[0])
    torch.testing.assert_close(prob, want[1], rtol=0, atol=1e-6)
    assert torch.equal(nc, want[2])


def test_cpu_artifact_moved_to_the_card_launches_the_kernels(cuda):
    """An artifact exported on the CPU, loaded with ``device='cuda'``, runs
    K1 and K2 on the card and gives the eager card outputs."""
    from multiagentperception_tpu_torch.export import export_serving, load_serving, make_eval_fn

    model, x = _toy_mimocom("cpu")
    artifact = load_serving(export_serving(model, tuple(x.shape)), device=cuda)
    before = (k1.upsample_argmax.launches, k2.comm_fusion.launches)
    cls, prob, nc = artifact(x.to(cuda))
    assert (k1.upsample_argmax.launches, k2.comm_fusion.launches) == \
        (before[0] + 1, before[1] + 1)
    want = make_eval_fn(model.to(cuda))(x.to(cuda))
    assert torch.equal(cls, want[0])
    torch.testing.assert_close(prob, want[1], rtol=0, atol=1e-6)
    assert torch.equal(nc, want[2])


# ------------------------------------------------------------------ the rest of the model surface

def test_comm_fusion_kernel_at_the_squeezed_value_maps(cuda):
    """K2 at (2, 6, 512, 8, 8) and (2, 6, 512, 4, 4), the flagship's value
    maps with ``feat_squeezer`` 2 and 4, in every mode (the check that
    chip_smoke.py's phase 12 runs)."""
    before = k2.comm_fusion.launches
    errs = checks.check_comm_fusion_squeezed(torch.Generator().manual_seed(12), cuda)
    assert set(errs) == {"8x8", "4x4"}
    assert k2.comm_fusion.launches == before + 3 * 2


LAG_TIMEOUT_S = 120  # the launches alone; a deadlocked mbarrier wait traps after ~9 s


@pytest.mark.parametrize("name", ["multi_gather128", "multi_halo64"],
                         ids=["one_stage_1x1s2_gather16_nb128", "3x3s1_halo"])
def test_int8_conv_with_a_lagging_warp(cuda, name):
    """K4's debug build ``int8_conv_lag`` (``_build.VARIANTS``: warp 1 of
    each consumer warpgroup spins ~200k cycles after every epilogue, so its
    warpgroup's other warps run a tile ahead) at the one-stage geometry
    (64 -> 128, 1x1 stride 2, gather16, NB 128, several tiles a CTA) and at
    3x3 stride 1 (halo): the turn barriers hold the ring's order, so the
    launches finish, within a timeout of their own (in a subprocess), and
    every output is bit-exact against the plain version."""
    import subprocess
    import sys
    from pathlib import Path

    from multiagentperception_tpu_torch.ops.kernels import _build
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4

    cin, cout, side, k, stride, pad, bias, n, route = K4_CONVS[name]
    geometry = k4.plan(n, cin, side, side, cout, k, k, stride, pad)
    assert geometry.route == route and (name != "multi_gather128" or geometry.nb == 128)
    _build.build(("int8_conv_lag",))  # nvcc, outside the launches' timeout
    code = f"""
import torch
from multiagentperception_tpu_torch.ops.kernels import checks
from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
k4.LIBRARY = "int8_conv_lag"
gen = torch.Generator().manual_seed({cin + cout + side})
x = torch.randn({n}, {cin}, {side}, {side}, generator=gen).to("cuda")
w = (torch.randn({cout}, {cin}, {k}, {k}, generator=gen) / {(cin * k * k) ** 0.5}).to("cuda")
b = torch.randn({cout}, generator=gen).to("cuda") if {bias} else None
for dtype in (torch.float32, torch.bfloat16):
    checks.check_int8_conv(x.to(dtype), w, b, {stride}, {pad}, None, dtype)
torch.cuda.synchronize()
assert k4.int8_conv.launches == 4, k4.int8_conv.launches
print("lagging warp ok")
"""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=LAG_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "lagging warp ok" in out.stdout


@pytest.mark.parametrize("override,k1_launches,k2_launches", [
    ({"enc_backbone": "n_segnet_encoder", "dec_backbone": "n_segnet_decoder"}, 0, 1),
    ({"dec_backbone": "FCN_decoder"}, 1, 1), ({"feat_squeezer": 2}, 1, 1),
    ({"feat_squeezer": 4}, 1, 1), ({"query": False}, 1, 1),
    ({"multiple_output": False}, 1, 0), ({"eval_inference": "topk"}, 1, 0)],
    ids=["segnet", "fcn", "squeezer2", "squeezer4", "no_query", "one_output", "topk"])
def test_model_options_eval_step_on_the_card(cuda, override, k1_launches, k2_launches,
                                             monkeypatch):
    """A small MIMOcom with each option the port builds beyond the
    reference YAMLs: one eval step in the config's mode on the card, K1 and
    K2 counted (the SegNet decoder has no pre-upsample logits: no K1; the
    single-query graph and ``topk`` take the plain selections: no K2), and
    the class map, graph and bandwidth against the CPU's from the same
    weights, TF32 off as chip_smoke.py's card-vs-CPU checks run (actions
    and bandwidth equal, class maps on 99.9% of pixels)."""
    import numpy as np

    from multiagentperception_tpu_torch.config import normalize_config
    from multiagentperception_tpu_torch.evaluate import Evaluator
    from multiagentperception_tpu_torch.models import get_model, init_weights

    cfg = normalize_config({
        "model": {"arch": "MIMOcom", "agent_num": 3, "query_size": 8, "key_size": 64,
                  "multiple_output": True, **override},
        "data": {"img_rows": 128, "img_cols": 128}})
    state = init_weights(get_model(cfg, 11), 0).state_dict()
    images = (np.random.default_rng(9).standard_normal((2, 3, 128, 128, 3)) * 0.5).astype(
        np.float32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    out = {}
    for dev in ("cuda", "cpu"):
        ev = Evaluator(cfg, device=dev)
        ev.model.load_state_dict(state)
        k1.upsample_argmax.launches = k2.comm_fusion.launches = 0
        out[dev] = [t.cpu() for t in ev.predict(images)]
        if dev == "cuda":
            assert (k1.upsample_argmax.launches, k2.comm_fusion.launches) == \
                (k1_launches, k2_launches)
    (g_cls, g_act, g_nc), (c_cls, c_act, c_nc) = out["cuda"], out["cpu"]
    assert torch.equal(g_act, c_act) and float(g_nc) == float(c_nc)
    assert (g_cls == c_cls).float().mean().item() >= 0.999


# ------------------------------------------------------------------ CUDA graphs

def _graph_cfg(arch="MIMOcom", dtype=None, **model):
    from multiagentperception_tpu_torch.config import normalize_config

    mrms = arch in MRMS
    m = {"arch": arch, "agent_num": 3, "query_size": 8, "key_size": 64,
         "multiple_output": mrms, **ZOO.get(arch, {}), **model}
    if dtype:
        m["dtype"] = dtype
    return normalize_config({
        "model": m, "data": {"img_rows": 128, "img_cols": 128,
                             "commun_label": "mimo" if mrms else "when2com"},
        "training": {"batch_size": 2, "optimizer": {"name": "adam", "lr": 1e-4},
                     "loss": {"name": "cross_entropy", "size_average": True}}})


def _graph_batches(cfg, count, b=2, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    n, size = cfg["model"]["agent_num"], cfg["data"]["img_rows"]
    out = []
    for _ in range(count):
        images = (rng.standard_normal((b, n, size, size, 3)) * 0.5).astype(np.float32)
        labels = rng.integers(0, 11, (b, n, size, size)).astype(np.int32)
        labels[rng.random(labels.shape) < 0.02] = 250
        if cfg["data"]["commun_label"] == "mimo":
            cl = np.stack([rng.integers(0, 2, (b, n)), rng.integers(0, n, (b, n))], axis=1)
        else:
            cl = rng.integers(-1, n - 1, (b,))
        out.append((images, labels, cl))
    return out


def _counters():
    return (k1.upsample_argmax.launches, dict(k1.upsample_argmax.route_launches),
            k2.comm_fusion.launches, dict(k2.comm_fusion.route_launches))


def _graph_vs_eager(cfg, batches, state, swap_scales=None, loss_fn=None, **step_kw):
    """Each batch's eval results through graphs and eagerly, on the host,
    with the launch counts each way."""
    from multiagentperception_tpu_torch.evaluate import Evaluator
    from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
    from multiagentperception_tpu_torch.quantize import Int8Convs

    out = {}
    for graphs in (True, False):
        ev = Evaluator(cfg, device="cuda", graphs=graphs, loss_fn=loss_fn)
        ev.model.load_state_dict(state)
        k1.upsample_argmax.launches = k2.comm_fusion.launches = k4.int8_conv.launches = 0
        swap = Int8Convs(ev.model, swap_scales) if swap_scales is not None else None
        with swap if swap is not None else contextlib.nullcontext():
            res = [{k: v.cpu() for k, v in r.items()}
                   for r, _ in ev._pipelined(batches, **step_kw)]
        torch.cuda.synchronize()
        out[graphs] = {"res": res, "k1": k1.upsample_argmax.launches,
                       "k2": k2.comm_fusion.launches, "k4": k4.int8_conv.launches,
                       "calls": None if swap is None else swap.calls, "ev": ev}
    return out


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "with_loss", "float16",
                                  "int8_float16"])
def test_graph_eval_equals_eager(cuda, kind):
    """The eval step as a CUDA graph against the eager step at 128x128,
    bit for bit: class maps, the three confusion matrices, actions,
    bandwidth (and the loss, with_loss), per batch over 4 batches and a
    ragged tail of 1 (eager in both). K1, K2 and K4 count exactly their
    per-batch launches under replay; the Int8Convs swap's calls too."""
    from multiagentperception_tpu_torch.evaluate import Evaluator
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import get_model, init_weights

    dtype = {"bfloat16": "bfloat16", "float16": "float16", "int8_float16": "float16"}
    cfg = _graph_cfg(dtype=dtype.get(kind))
    state = init_weights(get_model(cfg, 11), 0).state_dict()
    batches = _graph_batches(cfg, 4) + _graph_batches(cfg, 1, b=1, seed=1)
    scales, kw = None, {"keep_pred": True}
    if kind.startswith("int8"):
        ev = Evaluator(cfg, device=cuda, graphs=False)
        ev.model.load_state_dict(state)
        scales = ev._calibrate_int8(batches, "activated", calib_loader=batches[:1])
    if kind == "with_loss":
        kw["with_loss"] = True
    runs = _graph_vs_eager(cfg, batches, state, scales, get_loss_function(cfg), **kw)
    graph, eager = runs[True], runs[False]
    for g, e in zip(graph["res"], eager["res"]):
        assert set(g) == set(e) and "pred" in g and ("loss" in g) == (kind == "with_loss")
        for key in e:
            assert torch.equal(g[key], e[key]), key
    want = 0 if kind == "with_loss" else len(batches)  # the softmax forward runs neither
    assert (graph["k1"], graph["k2"]) == (eager["k1"], eager["k2"]) == (want, want)
    if kind.startswith("int8"):
        assert graph["k4"] == eager["k4"] == 48 * len(batches)
        assert graph["calls"] == eager["calls"] == 48 * len(batches)
    entries = graph["ev"]._eval_graphs.entries
    assert sum(1 for v in entries.values() if hasattr(v, "replay")) == 1


@pytest.mark.parametrize("arch", ZOO)
def test_graph_eval_of_every_arch(cuda, arch):
    """Every architecture's eval step in its default mode captures, and its
    graph gives the eager step's results bit for bit (the selection
    baselines' draws go in as a static input)."""
    from multiagentperception_tpu_torch.models import get_model, init_weights

    cfg = _graph_cfg(arch)
    state = init_weights(get_model(cfg, 11), 0).state_dict()
    runs = _graph_vs_eager(cfg, _graph_batches(cfg, 3), state)
    for g, e in zip(runs[True]["res"], runs[False]["res"]):
        for key in e:
            assert torch.equal(g[key], e[key]), key
    assert runs[True]["k1"] == runs[False]["k1"] == 3


def test_a_host_sync_inside_a_capture_raises(cuda, monkeypatch):
    """A host sync in the captured step raises ``CaptureError`` naming the
    key; the evaluator does not fall back to the eager step, and the card
    keeps working."""
    from multiagentperception_tpu_torch.evaluate import Evaluator
    from multiagentperception_tpu_torch.graphs import CaptureError
    from multiagentperception_tpu_torch.models import init_weights

    cfg = _graph_cfg()
    ev = Evaluator(cfg, device=cuda)
    init_weights(ev.model, 0)
    forward = ev.model.forward

    def syncing(x, **kw):
        float(x.sum())  # a readback: a host sync
        return forward(x, **kw)

    monkeypatch.setattr(ev.model, "forward", syncing)
    batches = _graph_batches(cfg, 2)
    ev.graph_eval_step(*batches[0])  # the warm-up is eager: the sync is legal there
    with pytest.raises(CaptureError, match="'eval'"):
        ev.graph_eval_step(*batches[1])
    assert float(torch.ones(4, device=cuda).sum()) == 4.0


def _graph_trainer(cfg, batches, graphs, loss_fn=None, **training):
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.trainer import Trainer

    cfg = copy.deepcopy(cfg)
    cfg["training"].update(print_interval=1, val_interval=1000, watchdog_secs=0, **training)
    tr = Trainer(cfg, None, loss_fn or get_loss_function(cfg), batches, batches[:1],
                 device="cuda", graphs=graphs)
    return tr


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode,
    TF32 off; restored after."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = saved[:4]
        torch.use_deterministic_algorithms(saved[4], warn_only=saved[5])


@pytest.mark.parametrize("variant", ["plain", "remat", "nan_guard", "selection", "float16"])
def test_graph_train_steps_match_eager(cuda, variant, monkeypatch, tmp_path):
    """K = 4 train steps a chunk by graph replays against K eager steps over
    9 iterations (chunks 4, 4, 1; the first step eager in both), both
    optimizers capturable from the start (the same arithmetic), in
    deterministic mode (training on the card is not reproducible without
    it: backward atomics): losses, parameters, BatchNorm statistics and
    the optimizer's state equal bit for bit. ``nan_guard``: step 6 (a
    replay) has a non-finite loss; both runs drop it (the guard's counters
    equal), and over that replay the parameters did not move. ``remat``,
    the selection baseline's draws and ``model.dtype: float16`` under the
    graph."""
    from multiagentperception_tpu_torch import graphs as graphs_mod
    from multiagentperception_tpu_torch.loss import get_loss_function
    from multiagentperception_tpu_torch.models import get_model, init_weights
    from multiagentperception_tpu_torch.optimizers import lr_tensor, make_capturable

    monkeypatch.chdir(tmp_path)
    arch = "MIMO_All_agents" if variant == "selection" else "MIMOcom"
    cfg = _graph_cfg(arch, remat=True) if variant == "remat" else \
        _graph_cfg(arch, dtype="float16") if variant == "float16" else _graph_cfg(arch)
    state = init_weights(get_model(cfg, 11), 0).state_dict()
    batches = _graph_batches(cfg, 9, seed=3)
    loss_fn, keys = None, {}
    if variant == "nan_guard":
        base = get_loss_function(cfg)
        batches[5][1][0, 0, 0, 0] = 249

        def loss_fn(input, target):
            hit = (target == 249).any()
            return base(input=input, target=torch.where(target == 249, 250, target)) * \
                torch.where(hit, torch.inf, 1.0)
        keys = {"nan_guard": 2}
    replay = graphs_mod.Graph.replay
    runs = {}
    for graphs in (True, False):
        tr = _graph_trainer(cfg, batches, graphs, loss_fn, train_iters=9, steps_per_call=4,
                            **keys)
        tr.model.load_state_dict(state)
        make_capturable(tr.optimizer, lr_tensor(1e-4, cuda))
        moved = []

        def watched(self):
            before = [p.detach().clone() for p in tr.model.parameters()]
            replay(self)
            moved.append(any(not torch.equal(a, p) for a, p in
                             zip(before, tr.model.parameters())))

        with monkeypatch.context() as m, _deterministic():
            m.setattr(graphs_mod.Graph, "replay", watched)
            tr.train()
        runs[graphs] = {"losses": [tr.loss_history[i] for i in range(1, 10)],
                        "state": {k: v.detach().cpu() for k, v in tr.model.state_dict().items()},
                        "opt": [t.detach().cpu() for st in tr.optimizer.state.values()
                                for t in st.values() if isinstance(t, torch.Tensor)],
                        "graph": tr._train_graph, "applied": tr._applied_count(),
                        "guard": tr.guard.state_dict() if tr.guard else None, "moved": moved}
    graph, eager = runs[True], runs[False]
    assert graph["graph"] is not None and eager["graph"] is None and not eager["moved"]
    assert graph["losses"] == eager["losses"]
    for name, value in eager["state"].items():
        assert torch.equal(graph["state"][name], value), name
    assert len(graph["opt"]) == len(eager["opt"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(graph["opt"], eager["opt"]))
    if variant == "nan_guard":
        want = {"notfinite_count": 0, "last_finite": True, "total_notfinite": 1}
        assert graph["guard"] == eager["guard"] == want
        assert graph["applied"] == eager["applied"] == 8
        assert not np.isfinite(graph["losses"][5])
        # replays run steps 2..9; step 6 is the fifth of them
        assert graph["moved"] == [True, True, True, True, False, True, True, True]
    else:
        assert graph["applied"] == eager["applied"] == 9
        assert graph["moved"] == [True] * 8


def test_graph_train_with_chunks_of_one(cuda, monkeypatch, tmp_path):
    """``steps_per_call: 4`` with ``val_interval: 1``: every chunk is one
    step; the first runs eagerly, the second is captured and replayed, the
    third replays, validating after each."""
    from multiagentperception_tpu_torch.models import get_model, init_weights

    monkeypatch.chdir(tmp_path)
    cfg = _graph_cfg()
    batches = _graph_batches(cfg, 3, seed=4)
    tr = _graph_trainer(cfg, batches, True, train_iters=3, steps_per_call=4)
    tr.cfg["training"]["val_interval"] = 1
    tr.model.load_state_dict(init_weights(get_model(cfg, 11), 0).state_dict())
    tr.train()
    assert tr._train_graph is not None and tr.step == tr.applied == 3
    assert sorted(tr.loss_history) == [1, 2, 3]
    assert all(np.isfinite(v) for v in tr.loss_history.values())


@pytest.mark.parametrize("opt_cfg", [
    {"name": "sgd", "lr": 0.1}, {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True,
                                 "weight_decay": 1e-2},
    {"name": "adam", "lr": 1e-2}, {"name": "adam", "lr": 1e-2, "weight_decay": 1e-2},
    {"name": "asgd", "lr": 1e-2, "weight_decay": 1e-3, "lambd": 1e-2},
    {"name": "adamax", "lr": 1e-2}, {"name": "adadelta", "lr": 1.0},
    {"name": "adagrad", "lr": 1e-1}, {"name": "rmsprop", "lr": 1e-2, "momentum": 0.9}],
    ids=lambda c: "-".join(str(v) for v in c.values()))
def test_every_optimizer_steps_under_capture(cuda, opt_cfg):
    """Each optimizer, made capturable after one eager update, captured in a
    CUDA graph and replayed 5 times with new gradients and a new lr each
    time (filled outside the graph), against the same capturable optimizer
    stepping eagerly: equal within rtol 1e-6 / atol 1e-7."""
    from multiagentperception_tpu_torch.optimizers import (
        get_optimizer,
        lr_tensor,
        make_capturable,
        set_lr,
    )

    g = torch.Generator().manual_seed(0)
    start = torch.randn(64, 33, generator=g)
    grads = [torch.randn(64, 33, generator=g).to(cuda) for _ in range(6)]
    cfg = {"training": {"optimizer": dict(opt_cfg)}}
    out = {}
    for mode in ("graph", "eager"):
        p = torch.nn.Parameter(start.clone().to(cuda))
        opt = get_optimizer(cfg, [p], opt_cfg["lr"])
        p.grad = grads[0].clone()
        opt.step()  # the eager update that makes the state
        lr = lr_tensor(opt_cfg["lr"], cuda)
        make_capturable(opt, lr)
        static = p.grad
        if mode == "graph":
            graph = torch.cuda.CUDAGraph()
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.graph(graph, stream=stream):
                opt.step()
        for t, grad in enumerate(grads[1:]):
            static.copy_(grad)
            set_lr(opt, opt_cfg["lr"] * 0.9 ** (t + 1))
            graph.replay() if mode == "graph" else opt.step()
        torch.cuda.synchronize()
        out[mode] = p.detach().cpu()
    torch.testing.assert_close(out["graph"], out["eager"], rtol=1e-6, atol=1e-7)
    assert not torch.equal(out["graph"], start)
