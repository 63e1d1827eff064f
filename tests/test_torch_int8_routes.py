"""What surrounds K4's GEMM (``ops/kernels/int8_conv.py``), on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py); here the
plain Python that decides how it runs is held to the kernel's limits and to
the JAX package's int8 convolution:

- ``plan``'s route, NB, tiles, TMA box and shared memory at every conv shape
  of the flagship's eval step (``chip_smoke.K4_SHAPES``) and at every
  eligible conv of the ten reference YAMLs over a range of sides: boxes of
  at most 256 per dimension with a 16-byte inner box, at most 227 KB of
  shared memory laid out without overlap, and a packed weight of the plan's
  layout. Its instantiations (``RINGS``) are the ones the kernel source
  compiles.
- ``pack_weight`` (any Cin, any NB) unpacks to ``w_i8`` with zeros
  everywhere else.
- The s2d route: the stride-1 convolution of ``s2d_weight`` over the
  space-to-depth scratch gives the int32 sums of JAX's stride-2
  ``lax.conv_general_dilated`` (quantize.py:106-117) on the same int8 arrays.
- The refusals: a packed weight of another layout, a scratch of another
  shape, a plan beyond 227 KB.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

import chip_smoke
from multiagentperception_tpu_torch.config import load_config
from multiagentperception_tpu_torch.models import get_model
from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
from multiagentperception_tpu_torch.quantize import eligible_convs

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted((ROOT / "configs").glob("*-*/*.yml"))
N_FLAGSHIP = 120  # the bench's batch 20 x 6 agents
# the GEMM route of each of chip_smoke.K4_SHAPES: the stem by space to depth,
# stride-1 3x3 by the halo, stride 2 and 1x1 by the cp.async gather
WANT_ROUTE = {(7, 2): "s2d", (3, 1): "halo", (3, 2): "gather16", (1, 2): "gather16"}


def _assert_fits(g: k4.Plan) -> None:
    assert g.smem <= k4.SMEM_LIMIT, g
    assert g.nb in (64, 128, 256) and g.tiles > 0 and g.stages > 0, g
    assert (g.tps, g.ns) == k4.RINGS[g.route, g.nb], g
    # the regions in order, none overlapping the next: the halo's chunks (4
    # planes each), the ring, the epilogues, the mbarriers (8 bytes each),
    # the base's alignment; TMA and bulk copies land on 128-byte boundaries
    stage = k4.K_STEP * g.nb * g.tps + (0 if g.box else k4.TILE_M * k4.K_STEP)
    epi = 64 * (k4.TILE_M + 4) * 4 + 2 * g.nb * 4
    assert g.off_ring >= k4.HALO_CHUNKS * 4 * g.plane and g.off_ring % 128 == 0, g
    assert g.off_epi >= g.off_ring + g.ns * stage and g.off_epi % 16 == 0, g
    assert g.off_bar >= g.off_epi + (2 if g.nb < 256 else 1) * epi and g.off_bar % 8 == 0, g
    assert g.smem >= g.off_bar + (2 * g.ns + 2 * k4.HALO_CHUNKS + 2) * 8 + 128, g
    if g.box is not None:
        assert g.plane % 128 == 0 and g.plane >= g.box[1] * g.box[2] * 16, g
    if g.route in ("halo", "s2d"):
        assert g.box is not None and all(1 <= d <= 256 for d in g.box), g
        assert g.box[0] * 1 % 16 == 0, g  # the inner box: 16 int8 channels, 16 bytes
        assert g.tw * g.th == k4.TILE_M and g.tw in (8, 16), g
        assert g.gemm[2] % 16 == 0 and g.gemm[5] == 1, g  # TMA's 16-byte strides, stride 1
    else:
        assert g.box is None, g


@pytest.mark.parametrize("shape", chip_smoke.K4_SHAPES, ids=lambda s: "{}-{}_{}_{}x{}s{}".format(
    s[0], s[1], s[2], s[3], s[3], s[4]) + ("_bias" if s[6] else ""))
def test_plan_at_the_flagship_shapes(shape):
    cin, cout, side, k, stride, pad, _, _ = shape
    g = k4.plan(N_FLAGSHIP, cin, side, side, cout, k, k, stride, pad)
    _assert_fits(g)
    assert g.route == WANT_ROUTE[(k, stride)]
    oh = (side + 2 * pad - k) // stride + 1
    assert g.out == (oh, oh) and g.pad == pad
    if g.route == "halo":
        assert g.tw == (16 if oh > 8 else 8)
        assert g.tiles == -(-oh // g.tw) * -(-oh // g.th) * N_FLAGSHIP * g.slices
        assert g.box == (16, g.tw + 2, g.th + 2, 1)
    elif g.route == "gather16":
        assert g.tiles == -(-(N_FLAGSHIP * oh * oh) // k4.TILE_M) * g.slices
    else:  # the stem: 7x7/2 over 3 channels is 4x4/1 over 16-byte blocks
        assert g.gemm == (side // 2, side // 2, 16, 4, 4, 1, 2) and g.stages == 4
    # the tiles fill half the 132 SMs at least, or NB is already 64
    assert g.tiles >= k4.SMS // 2 or g.nb == 64
    w = k4.prepare_weight(torch.randn(cout, cin, k, k))
    operand = w.operand(g)
    assert tuple(operand.shape) == (g.slices, g.stages, 4, g.nb, 16)
    k4._check_operand(operand, g)


@functools.lru_cache(maxsize=None)
def _zoo_geometries():
    """(YAML, Cin, Cout, k, stride, pad) of every eligible conv of the ten
    reference YAMLs' models, deduplicated per YAML."""
    out = []
    for yml in YAMLS:
        model = get_model(load_config(str(yml)), 11)
        seen = set()
        for _, mod in eligible_convs(model):
            key = (mod.in_channels, mod.out_channels, mod.kernel_size[0], mod.stride[0],
                   mod.padding[0])
            if key not in seen:
                seen.add(key)
                out.append((yml.stem, *key))
    return tuple(out)


def test_the_zoo_has_geometries_for_every_yaml():
    assert len(YAMLS) == 10
    assert {g[0] for g in _zoo_geometries()} == {p.stem for p in YAMLS}


@pytest.mark.parametrize("yml", YAMLS, ids=lambda p: p.stem)
def test_plan_for_every_zoo_conv(yml):
    geoms = [g[1:] for g in _zoo_geometries() if g[0] == yml.stem]
    assert geoms
    for cin, cout, k, stride, pad in geoms:
        for side in (512, 256, 128, 64, 32, 16, 8, 5, 3):
            if side + 2 * pad < k:
                continue
            for n in (1, 12, 120):
                g = k4.plan(n, cin, side, side, cout, k, k, stride, pad)
                _assert_fits(g)
                packed = k4.prepare_weight(torch.zeros(cout, cin, k, k)).operand(g)
                assert tuple(packed.shape) == (g.slices, g.stages, 4, g.nb, 16), (yml, g)


@pytest.mark.parametrize("cout,cin,k,nb", [(64, 3, 7, None), (64, 64, 3, None), (72, 512, 3, None),
                                           (512, 256, 3, None), (24, 16, 3, None),
                                           (128, 64, 1, None), (8, 20, 3, None),
                                           (300, 48, 5, None), (256, 128, 3, 64),
                                           (512, 256, 1, 128), (24, 8, 1, None),
                                           (16, 3, 3, 64)])
def test_pack_weight_unpacks_to_w_i8(cout, cin, k, nb):
    rng = np.random.default_rng(cout + cin + k)
    w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8))
    packed = k4.pack_weight(w, nb)
    nb = nb or k4.tile_n(cout)
    stages = k4.k_stages(cin, k, k)
    assert tuple(packed.shape) == (-(-cout // nb), stages, 4, nb, 16)
    assert torch.equal(k4.unpack_weight(packed, "halo", 0, cout, cin, k, k), w)
    # everything but w_i8's bytes is zero: padding channels, K's tail, Cout's tail
    assert int(packed.ne(0).sum()) == int(w.ne(0).sum())


@pytest.mark.parametrize("cout,cin,k,pad,nb", [(64, 3, 7, 3, 64), (64, 3, 7, 3, 128),
                                               (16, 4, 3, 1, 64), (24, 1, 5, 2, 64),
                                               (8, 2, 4, 1, 64), (300, 3, 2, 0, 256)])
def test_unpack_weight_inverts_pack_s2d(cout, cin, k, pad, nb):
    """The s2d route's B operand back to the OIHW weight: what the GEMM op's
    CPU version convolves with."""
    rng = np.random.default_rng(cout + cin + k + pad)
    w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8))
    packed = k4.pack_s2d(w, pad, nb)
    assert torch.equal(k4.unpack_weight(packed, "s2d", pad, cout, cin, k, k), w)


def test_pack_orders_k_by_chunk_then_tap():
    """Stage s is (64-channel chunk s // taps, tap s % taps); its 4 planes
    are 16 channels each; a channel's bytes are one row of NB. Below 64
    channels the chunk's other channels are zero, as at Cin 3."""
    w = torch.zeros(64, 128, 3, 3, dtype=torch.int8)
    w[5, 70, 1, 2] = 9  # chunk 1, tap 5, channel 6 of the chunk
    packed = k4.pack_weight(w)
    assert int(packed[0, 1 * 9 + 5, 0, 5, 6]) == 9
    w = torch.zeros(64, 3, 7, 7, dtype=torch.int8)
    w[2, 1, 3, 4] = 7  # chunk 0, tap 3 * 7 + 4 = 25, channel 1: plane 0, byte 1
    packed = k4.pack_weight(w)
    assert tuple(packed.shape) == (1, 49, 4, 64, 16) and int(packed[0, 25, 0, 2, 1]) == 7


@pytest.mark.parametrize("k,pad,side", [(7, 3, 20), (7, 3, 17), (7, 3, 5), (3, 1, 9),
                                        (1, 0, 6), (5, 2, 11), (4, 1, 10), (2, 0, 7)])
def test_s2d_route_sums_equal_jax_stride2_conv(k, pad, side):
    rng = np.random.default_rng(k * 100 + side)
    cin, cout = 3, 8
    x_i8 = rng.integers(-127, 128, (2, side, side, cin), dtype=np.int8)
    w_i8 = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    dn = lax.conv_dimension_numbers(x_i8.shape, w_i8.shape, ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x_i8), jnp.asarray(w_i8), (2, 2), [(pad, pad)] * 2,
        dimension_numbers=dn, preferred_element_type=jnp.int32))
    g = k4.plan(2, cin, side, side, cout, k, k, 2, pad)
    assert g.route == "s2d" and g.out == want.shape[1:3]
    h2, w2, cp, kh2, kw2, stride, pad2 = g.gemm
    scratch = k4.space_to_depth(F.pad(torch.from_numpy(x_i8), (0, 1)).contiguous())
    assert tuple(scratch.shape) == (2, h2, w2, cp) == (2, -(-side // 2), -(-side // 2), 16)
    wt = k4.s2d_weight(torch.from_numpy(w_i8).permute(3, 2, 0, 1), pad)
    assert tuple(wt.shape) == (cout, kh2, kw2, 16) and kw2 % 4 == 0 and stride == 1
    # the kernel's halo: pad2 blocks of zeros before, TMA's zero fill after
    xin = F.pad(scratch.permute(0, 3, 1, 2).double(), (pad2, kw2, pad2, kh2))
    got = F.conv2d(xin, wt.permute(0, 3, 1, 2).double())[:, :, :g.out[0], :g.out[1]]
    np.testing.assert_array_equal(got.round().to(torch.int32).permute(0, 2, 3, 1).numpy(), want)
    # the packed operand: dense (tap, 16 channels) K, 4 taps a stage
    packed = k4.pack_s2d(torch.from_numpy(w_i8).permute(3, 2, 0, 1), pad, 64)
    assert tuple(packed.shape) == (1, g.stages, 4, 64, 16)
    assert torch.equal(packed.permute(0, 3, 1, 2, 4).reshape(64, -1)[:cout],
                       wt.reshape(cout, -1))


def test_space_to_depth_layout():
    """Block (by, bx) holds pixels (2by + r, 2bx + c) at bytes (2r + c) * 4 +
    channel; past an odd side the block is zero."""
    x = torch.arange(3 * 5 * 4, dtype=torch.int8).reshape(1, 3, 5, 4)
    s = k4.space_to_depth(x)
    assert tuple(s.shape) == (1, 2, 3, 16)
    for by in range(2):
        for bx in range(3):
            for r in range(2):
                for c in range(2):
                    iy, ix = 2 * by + r, 2 * bx + c
                    want = x[0, iy, ix] if iy < 3 and ix < 5 else torch.zeros(4, dtype=torch.int8)
                    assert torch.equal(s[0, by, bx, (2 * r + c) * 4:(2 * r + c) * 4 + 4], want)


@pytest.mark.parametrize("shape,route", [((1, 3, 16, 16), "s2d"), ((1, 8, 9, 9), "halo"),
                                         ((2, 64, 9, 9), "halo"), ((2, 64, 9, 9), "gather16"),
                                         ((2, 8, 9, 9), "gather16")])
def test_scratch_plain_is_the_scratch_the_route_reads(shape, route):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    s = k4.dynamic_scale(x)
    stride = 1 if route == "halo" else 2
    g = k4.plan(shape[0], shape[1], shape[2], shape[3], 32, 3, 3, stride, 1)
    assert g.route == route
    got = k4.scratch_plain(x, s, g)
    assert tuple(got.shape[1:]) == g.gemm[:3]
    q = k4.quantize_input(x, s).permute(0, 2, 3, 1)
    if route == "s2d":
        assert torch.equal(got[:, :, :, :3], q[:, 0::2, 0::2])  # block row 0, column 0
        assert torch.equal(got[:, :, :, 12:15], q[:, 1::2, 1::2])  # row 1, column 1
    else:  # Cin rounded up to 16 channels, the rest zero
        assert got.shape[-1] == -(-shape[1] // 16) * 16 and not got[..., shape[1]:].any()
        assert torch.equal(got[..., :shape[1]], q)


def test_plan_is_cached_and_adapts_nb_to_the_card():
    g = k4.plan(120, 256, 8, 8, 256, 3, 3, 2, 1)
    assert g is k4.plan(120, 256, 8, 8, 256, 3, 3, 2, 1)
    # 15 tiles of 128 pixels: NB drops to 64, 4 slices, 60 tiles
    assert (g.nb, g.slices, g.tiles) == (64, 4, 60)
    assert k4.plan(120, 256, 32, 32, 256, 3, 3, 1, 1).nb == 256


def test_refusals_before_any_launch():
    w = k4.prepare_weight(torch.randn(32, 64, 3, 3))
    g = k4.plan(2, 64, 8, 8, 32, 3, 3, 1, 1)
    with pytest.raises(ValueError, match="layout"):
        k4._check_operand(k4.pack_weight(w.w_i8, 128), g)  # another NB
    with pytest.raises(ValueError, match="layout"):
        k4._check_operand(w.packed[:, :-1].contiguous(), g)
    with pytest.raises(ValueError, match="scratch"):
        k4.conv_nhwc(torch.zeros(2, 8, 8, 32, dtype=torch.int8), w, torch.ones(()), None, g,
                     torch.float32)
    with pytest.raises(ValueError, match="scratch"):
        k4.conv_nhwc(torch.zeros(2, 8, 8, 64, dtype=torch.uint8), w, torch.ones(()), None, g,
                     torch.float32)
    big = dataclasses.replace(g, smem=k4.SMEM_LIMIT + 16)
    with pytest.raises(ValueError, match="shared memory"):
        k4._check_operand(w.packed, big)


def test_instantiations_are_the_kernel_sources():
    """``RINGS`` lists exactly the (route, NB, TPS, NS) that
    csrc/int8_conv.cu's INT8_CONV_KERNELS compiles: a plan can ask for no
    other, and each route has every NB."""
    src = (ROOT / "multiagentperception_tpu_torch" / "csrc" / "int8_conv.cu").read_text()
    table = src[src.index("#define INT8_CONV_KERNELS(X)"):]
    table = table[:table.index("\n\n")]
    names = {"kHalo": "halo", "kGather16": "gather16", "kS2d": "s2d"}
    compiled = {(names[r], int(nb)): (int(tps), int(ns))
                for r, nb, tps, ns in re.findall(r"X\((k\w+), (\d+), (\d+), (\d+)\)", table)}
    assert compiled == k4.RINGS
    assert set(k4.RINGS) == {(r, nb) for r in k4.ROUTE_IDS for nb in (64, 128, 256)}
    ids = dict(re.findall(r"(k\w+) = (\d)", src[src.index("enum Route"):].split(";")[0]))
    assert {names[k]: int(v) for k, v in ids.items()} == k4.ROUTE_IDS


@pytest.mark.parametrize("cin,k,stride,route", [(3, 3, 1, "halo"), (8, 3, 1, "halo"),
                                                (8, 1, 1, "gather16"), (3, 7, 1, "gather16"),
                                                (12, 3, 2, "gather16"), (4, 3, 2, "s2d"),
                                                (3, 41, 2, "gather16")])
def test_small_cin_pads_to_16_channels(cin, k, stride, route):
    """Below 16 channels the scratch has 16 (zeros past Cin) and the halo or
    the gather takes the geometry; stride 2 over at most 4 channels is s2d
    where its halo fits 227 KB (a 41x41 kernel's does not: gather16)."""
    pad = k // 2
    g = k4.plan(2, cin, 45, 45, 16, k, k, stride, pad)
    _assert_fits(g)
    assert g.route == route
    if route != "s2d":
        assert g.gemm[2] == 16 and g.stages == k * k
        w = torch.from_numpy(np.random.default_rng(cin).integers(
            -127, 128, (16, cin, k, k), dtype=np.int8))
        packed = k4.pack_weight(w)
        assert torch.equal(k4.unpack_weight(packed, route, pad, 16, cin, k, k), w)
    if k == 41:
        assert k4._plan("s2d", 2, 16, (23, 23, 16, 21, 24, 1, 10), 126, g.out, pad).smem > \
            k4.SMEM_LIMIT


def test_bench_kernels_times_the_smoke_shapes_and_needs_a_card(monkeypatch, capsys):
    """``bench_kernels`` holds the 16 shapes (48 calls a step) and the timer
    that ``chip_smoke.py`` uses, and refuses to run without a card."""
    from multiagentperception_tpu_torch import bench_kernels

    assert chip_smoke.K4_SHAPES is bench_kernels.K4_SHAPES and len(chip_smoke.K4_SHAPES) == 16
    assert sum(shape[-1] for shape in bench_kernels.K4_SHAPES) == 48
    assert chip_smoke._time_ms is bench_kernels.time_ms
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_kernels.main(["--iters", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
