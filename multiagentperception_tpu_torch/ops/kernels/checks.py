"""Each CUDA kernel held against its plain PyTorch version on the same
inputs on the card. ``chip_smoke.py`` runs these checks at the flagship
shapes, and ``tests/test_torch_cuda.py`` runs them too. Each check raises
``AssertionError`` when the kernel and its plain version disagree, and
returns what it measured.

Tolerances:
- K1 (``upsample_argmax``), float32, bfloat16 or float16 logits: at least
  99.99% of pixels agree. At every pixel that differs, the plain version's
  top two upsampled logits (in float32, as both sides upcast 16-bit logits
  first) lie within 1e-4 (a near-tie), because the kernel sums its taps in
  another order than the dense matmuls. An all-equal input gives class 0.
- K2 (``comm_fusion``): masks equal to the plain version's; ``coef`` and
  ``soft`` within atol 1e-6 of the plain version run in float64 on the
  same values (the graph of the exact sums), in both types. The plain
  version in float32 is no reference to 1e-6: its logits are sums of
  D = 1024 products, and at the bench's batch 20 x 6 its graph lies
  beyond 1e-6 from float64's at a few elements, where the kernel's (its
  sums split over threads, warps and the cluster) lies well inside
  (``chip_smoke.k2_graph_against_float64`` prints both; PERF.md section
  6). fused: float32 within rtol/atol 1e-5; bfloat16
  (both sides sum in float32 and round once) within one bf16 ulp of the
  larger of the two values plus atol 1e-5, the float32 route's atol, for
  sums that cancel to near zero, where an ulp is tiny. float16 within one
  float16 ulp plus 1e-5 of the plain version and of ``coef``^T V in
  float64 (both rounded once from a sum within float32 rounding of the
  exact one).
  On a model's own Q', K and V, whose logits reach ~250, the plain
  version's float32 sums lie beyond 1e-6 from float64's graph, so there
  ``check_comm_fusion_against_float64`` holds every output to the function
  in float64 with the same tolerances. Beyond 16 agents
  (``check_comm_fusion_wide``, the wide design) the same tolerances hold,
  on inputs whose graph is peaked (``wide_comm_inputs``: links survive
  ``activated`` at any N) and whose argmax ties, at every edge of its tiles
  (``WIDE_EDGE_AGENTS``) and beyond what its CTAs keep in shared memory
  (``WIDE_BEYOND``); two calls give the same bits
  (``check_comm_fusion_repeatable``) and a CUDA graph's replay equals an
  eager call (``check_comm_fusion_graph_replay``).
- K1 at wide logits (``check_upsample_argmax_wide``): the same rule, where
  a block stages fewer than 16 rows or none (``upsample_argmax.plan``).
- K3 (``fused_basic_block``), with TF32 off for the plain version's
  convolutions: float32 within rtol/atol 1e-4 (tests/test_fused_block.py's
  bound). bfloat16: both sides form exact bf16 products and sum them in
  float32 in another order, so they differ only where a rounding to bf16
  falls the other way: the output's (one ulp) or one of the 9·C y1 values
  conv2 reads (that y1 ulp times a weight, which moves the output by
  ~1e-4, rarely by a few 1e-3). So every element lies within
  4 ulp + 1e-2 of the plain value, and at most a share 1e-4 · C/64 of the
  elements (the flips grow with the 9·C values each output reads) lies
  beyond 1 ulp + 1e-3. A conv2 ring fed ``relu(b1)`` instead of zeros
  moves every border output (4/H of the image or more) by several 1e-3
  and fails the second bound (tests/test_torch_fused_block.py holds that
  negative control). Every route of K3 is held to these bounds. The
  tensor-core routes sum each weight stage on the tensor cores and the
  stages in float: against a float64 computation the wgmma route's
  bfloat16 outputs lie no further off than the plain version's on images
  of 37x45 and larger. The float32 tensor-core route (``tf32x3``) meets
  1e-4 because it forms each product from three TF32 products of split
  operands (tests/test_torch_tf32x3.py shows that one TF32 product does
  not).
  The share bound is a rate, and on a 5x7 image at C=128 (4480 elements)
  two elements beyond the near bound exceed it; over 16 seeds there the
  wgmma kernel left 3 elements beyond the near bound from float64 where
  the plain version left none (chip_smoke.py phase 1 on an H100; an open
  question in PERF.md section 7). The checks run C=128 images of at
  least 7x13, where the two agree with float64 alike.

  bfloat16 at C >= 256 (``K3_BF16_WIDE``): the share beyond the near bound
  from the plain version is held as above, but the far bound is read
  against the block in float64 (``block_float64``, y1 rounded to bfloat16
  as both sides round it) instead of against the plain version. A y1 ulp
  (up to 0.0625 at these values) times a weight moves an output by up to
  ~1.2e-2 when one side's float32 sum of the 9*C products rounds y1 the
  other way, beyond 4 ulp + 1e-2, and the chance of such a flip grows with
  the 9*C values each output reads: on an H100 the plain version itself
  lay that far from float64 at 2 of 31.5M elements at the bench's layer3
  (PERF.md section 6). Such an element says which side rounded y1 wrongly,
  which a kernel-against-plain difference cannot. So the rule is: summed
  over the seeds run at a geometry (``assert_far_no_worse``), the kernel
  has no more elements beyond the far bound from float64 than the plain
  version has. No bound at C <= 128 changes.
- K4 (``int8_conv``): exact. The int8 operands the quantize pass writes
  (NHWC) equal the plain quantizer's, the int32 sums equal the plain
  version's exact float64 sums, and the output equals the plain version's
  to the bit in float32 and in bfloat16 (both sides form
  ``float(acc) * (s_x * s_w) + bias`` in float32 with one rounding per
  operation and round once to bf16), with a static or a dynamic ``s_x``.
  In float16 the output is the plain version's to the bit too, and within
  one float16 ulp of the plain version's float32 rescale (the one
  rounding).
"""

from __future__ import annotations

import torch

from multiagentperception_tpu_torch.ops.comm import fuse_values
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import fused_block as k3
from multiagentperception_tpu_torch.ops.kernels import int8_conv as k4
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from multiagentperception_tpu_torch.ops.resize import bilinear_resize

K1_MIN_AGREEMENT = 0.9999
K1_NEAR_TIE = 1e-4
K2_ATOL = 1e-5
K2_GRAPH_ATOL = 1e-6  # coef and soft, against the graph in float64
K3_F32_TOL = 1e-4
K3_BF16_NEAR = (1, 1e-3)  # (ulps, atol) all but a share K3_BF16_RARE_C64 * C/64 meet
K3_BF16_FAR = (4, 1e-2)   # (ulps, atol) that every element meets
K3_BF16_RARE_C64 = 1e-4
K3_BF16_WIDE = 256  # from this C on, the far bound is read against float64


def check_upsample_argmax(x: torch.Tensor, out_h: int, out_w: int,
                          fn=k1.upsample_argmax) -> dict:
    """K1 on NCHW logits ``x`` (on the card) against its plain version.
    Returns the pixel agreement and the largest upsampled logit lost at a
    flipped pixel (``max_abs_err``). ``fn`` is the function held: the
    wrapper, or the op ``torch.ops.when2com.upsample_argmax`` itself."""
    got = fn(x, out_h, out_w)
    ref = k1.upsample_argmax_plain(x, out_h, out_w)
    if got.dtype != torch.int32 or got.shape != ref.shape:
        raise AssertionError(f"K1 gives {got.dtype} {tuple(got.shape)}, "
                             f"plain {ref.dtype} {tuple(ref.shape)}")
    up = bilinear_resize(x.float(), out_h, out_w)
    top2 = up.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    miss = got != ref
    agree = 1.0 - miss.float().mean().item()
    if agree < K1_MIN_AGREEMENT or bool((gap[miss] >= K1_NEAR_TIE).any()):
        raise AssertionError(f"K1 disagrees: agree={agree}, largest gap at a mismatch "
                             f"{gap[miss].max().item() if miss.any() else 0}")
    lost = up.gather(1, ref.long()[:, None]) - up.gather(1, got.long()[:, None])
    tied = fn(torch.ones_like(x[:2]), out_h, out_w)
    if bool(tied.any()):
        raise AssertionError("K1: an all-equal input must give class 0")
    return {"max_abs_err": lost.abs().max().item(), "pixel_agreement": agree}


def check_comm_fusion(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str,
                      diag_bias: float, thres: float = 0.2, fn=k2.comm_fusion) -> float:
    """K2 in one mode against its plain version, float32 or bfloat16 inputs
    (the graph against the plain version in float64); returns the largest
    absolute error over fused and coef. ``fn`` is the function held: the
    wrapper, or the op ``torch.ops.when2com.comm_fusion`` itself."""
    fused, coef, soft = fn(q, k, v, mode, diag_bias, thres)
    r_fused, r_coef, r_soft = k2.comm_fusion_plain(q, k, v, mode=mode,
                                                  diag_bias=diag_bias, thres=thres)
    # the graph in float64 (it does not read V: one column of it will do)
    _, x_coef, x_soft = k2.comm_fusion_plain(q.double(), k.double(),
                                             v.flatten(2)[..., :1].double(), mode=mode,
                                             diag_bias=diag_bias, thres=thres)
    if not torch.equal(coef != 0, r_coef != 0):
        raise AssertionError(f"K2 {mode}: masks differ")
    torch.testing.assert_close(coef.double(), x_coef, rtol=0, atol=K2_GRAPH_ATOL)
    torch.testing.assert_close(soft.double(), x_soft, rtol=0, atol=K2_GRAPH_ATOL)
    if fused.dtype != v.dtype or r_fused.dtype != v.dtype:
        raise AssertionError(f"K2 fused in {fused.dtype}, plain {r_fused.dtype}, V {v.dtype}")
    if v.dtype in (torch.bfloat16, torch.float16):
        assert_within_ulp(fused, r_fused, K2_ATOL, v.dtype)
        if v.dtype == torch.float16:
            assert_within_ulp(fused, fuse_values(x_coef, v.double()), K2_ATOL, v.dtype)
    else:
        torch.testing.assert_close(fused, r_fused, rtol=K2_ATOL, atol=K2_ATOL)
    if mode == "activated":
        eye = torch.eye(coef.shape[1], dtype=torch.bool, device=coef.device)
        if not bool(((coef != 0) & ~eye).any(2).any(1).all()):
            raise AssertionError("K2 check input prunes every link of a sample")
    return max((fused.float() - r_fused.float()).abs().max().item(),
               (coef.double() - x_coef).abs().max().item())


def check_comm_fusion_against_float64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      mode: str, diag_bias: float, thres: float = 0.2,
                                      fn=k2.comm_fusion) -> float:
    """K2 in one mode held to the function in float64 on the same values,
    for inputs whose logits are large (a trained or seeded model's, ~250):
    there the plain version's float32 sums put its graph beyond 1e-6 of
    float64's, and its fused maps follow it, so it is no reference. Masks equal to
    float64's; ``coef`` and ``soft`` within K2_GRAPH_ATOL; fused within
    rtol/atol K2_ATOL of ``coef64``^T V in float64 (16-bit: one ulp of the
    type + K2_ATOL). Returns the largest error over fused and the graph."""
    fused, coef, soft = fn(q, k, v, mode, diag_bias, thres)
    x_fused, x_coef, x_soft = k2.comm_fusion_plain(q.double(), k.double(), v.double(),
                                                   mode=mode, diag_bias=diag_bias, thres=thres)
    if not torch.equal(coef != 0, x_coef != 0):
        raise AssertionError(f"K2 {mode}: masks differ from float64's")
    torch.testing.assert_close(coef.double(), x_coef, rtol=0, atol=K2_GRAPH_ATOL)
    torch.testing.assert_close(soft.double(), x_soft, rtol=0, atol=K2_GRAPH_ATOL)
    if v.dtype in (torch.bfloat16, torch.float16):
        assert_within_ulp(fused, x_fused, K2_ATOL, v.dtype)
    else:
        torch.testing.assert_close(fused.double(), x_fused, rtol=K2_ATOL, atol=K2_ATOL)
    return max((fused.double() - x_fused).abs().max().item(),
               (coef.double() - x_coef).abs().max().item())


# K2 at the value maps of model.feat_squeezer 2 and 4 at 512x512: (B, N, D, C, h, w)
SQUEEZED_COMM_SHAPES = ((2, 6, 1024, 512, 8, 8), (2, 6, 1024, 512, 4, 4))


def check_comm_fusion_squeezed(gen: torch.Generator, device, dtype=torch.float32) -> dict:
    """``check_comm_fusion`` in every mode at ``SQUEEZED_COMM_SHAPES`` (the
    flagship with ``feat_squeezer`` 2 and 4), on inputs drawn from ``gen``
    whose logits spread about 2, so ``activated`` keeps off-diagonal links.
    Returns the largest error at each shape, by ``h x w``; launches K2 three
    times a shape."""
    errs = {}
    for b, n, d, c, h, w in SQUEEZED_COMM_SHAPES:
        q = torch.randn(b, n, d, generator=gen).to(device, dtype)
        k = (torch.randn(b, n, d, generator=gen) * 2 / d ** 0.5).to(device, dtype)
        v = torch.randn(b, n, c, h, w, generator=gen).to(device, dtype)
        errs[f"{h}x{w}"] = max(check_comm_fusion(q, k, v, mode, 0.001) for mode in k2.MODES)
    return errs


# K2 beyond 16 agents: the agent counts, and the value maps (C, h, w) of the
# agent-count sweep at 256x256 and a ragged M (no multiple of a CTA's columns)
WIDE_AGENTS = (17, 24, 32, 33, 48, 64, 200)
WIDE_MAPS = ((512, 8, 8), (1000,))
WIDE_FRAMES = 96  # the sweep's B*N: batch max(96 // N, 1)
WIDE_KEY = 1024  # the flagship's key_size
WIDE_LINKS = (9.0, 6.0)  # weights of the two keys each query lies along


def wide_comm_inputs(gen: torch.Generator, b: int, n: int, d: int, rest: tuple,
                     dtype: torch.dtype, device) -> tuple:
    """Q' (B, N, D), K (B, N, D) and V (B, N, *rest) for K2 beyond 16 agents,
    drawn from ``gen``, with a peaked graph at any N: K's rows have norm ~1,
    and query q lies along keys q + 1 and q + 2 (mod N) with weights
    WIDE_LINKS, so its soft graph holds ~0.86 and ~0.12 there and the rest
    is noise (``activated`` keeps a link a query, none near the threshold).
    Keys N//2 .. N//2 + 3 repeat keys 0 .. 3 exactly, so a query that points
    at one of them ties two keys at its largest soft (~0.46 each): the
    argmax must keep the lower."""
    keys = torch.randn(b, n, d, generator=gen) / d ** 0.5
    dup = min(4, n // 2)
    keys[:, n // 2:n // 2 + dup] = keys[:, :dup]
    idx = torch.arange(n)
    q = (WIDE_LINKS[0] * keys[:, (idx + 1) % n] + WIDE_LINKS[1] * keys[:, (idx + 2) % n]
         + torch.randn(b, n, d, generator=gen) / d ** 0.5)
    v = torch.randn(b, n, *rest, generator=gen)
    return q.to(device, dtype), keys.to(device, dtype), v.to(device, dtype)


def check_comm_fusion_wide(gen: torch.Generator, device, dtype=torch.float32,
                           agents=WIDE_AGENTS, maps=WIDE_MAPS, d: int = WIDE_KEY,
                           fn=k2.comm_fusion) -> dict:
    """``check_comm_fusion`` in every mode at each of ``agents`` (each above
    16, the wide design's) and each value map of ``maps``, at the sweep's
    batch ``max(96 // N, 1)``, on ``wide_comm_inputs``: links survive
    ``activated`` and the argmax has exact ties (checked on the plain
    graph). Returns the largest error by ``N x M``; launches K2 three times
    at each."""
    errs = {}
    for n in agents:
        for rest in maps:
            b = max(WIDE_FRAMES // n, 1)
            m = int(torch.Size(rest).numel())
            if k2.plan(b, n, d, m, dtype) != "wide":
                raise AssertionError(f"K2 at N={n}: plan {k2.plan(b, n, d, m, dtype)}, not wide")
            q, k, v = wide_comm_inputs(gen, b, n, d, rest, dtype, device)
            soft = k2.comm_fusion_plain(q, k, v.flatten(2)[..., :1])[2]
            if not bool(((soft == soft.amax(1, keepdim=True)).sum(1) > 1).any()):
                raise AssertionError(f"K2 wide check input at N={n}: no tied argmax")
            errs[f"{n}x{m}"] = max(check_comm_fusion(q, k, v, mode, 0.001, fn=fn)
                                   for mode in k2.MODES)
    return errs


def check_comm_fusion_every_n(gen: torch.Generator, device, dtype=torch.float32,
                              agents=range(1, 201), d: int = WIDE_KEY, m: int = 64) -> dict:
    """``check_comm_fusion`` at every N of ``agents`` (batch 1, value rows of
    ``m``) on ``wide_comm_inputs``, one mode each in turn (a lone agent has
    no link: softmax or argmax). On the card each call must launch one
    design, the one ``plan`` names: the cluster design up to CLUSTER_AGENTS,
    the wide one above. Returns the largest error and the launches by
    design."""
    err, designs = 0.0, dict.fromkeys(k2.DESIGNS, 0)
    for n in agents:
        q, k, v = wide_comm_inputs(gen, 1, n, d, (m,), dtype, device)
        modes = ("softmax", "argmax") if n == 1 else k2.MODES
        before = dict(k2.comm_fusion.design_launches)
        err = max(err, check_comm_fusion(q, k, v, modes[n % len(modes)], 0.001))
        got = {key: k2.comm_fusion.design_launches[key] - before[key] for key in before}
        want = dict.fromkeys(k2.DESIGNS, 0)
        if v.is_cuda:
            want[k2.plan(1, n, d, m, dtype)] = 1
        if got != want:
            raise AssertionError(f"K2 at N={n} {dtype}: launches by design {got}, want {want}")
        designs = {key: designs[key] + got[key] for key in designs}
    return {"max_abs_err": err, "designs": designs}


# K2's wide design at each edge of its tiles: a graph cluster's 8 queries,
# the 16 keys of an mma step, a fusion tile's 32 (float32) and 64 (16-bit)
# queries and 64 keys, and beyond one tile of each; WIDE_BEYOND: more keys
# than a graph CTA keeps in shared memory (1024: its logits pass through soft
# and coef) and than a fusion CTA keeps V rows for (its rows streamed again
# for each query tile)
WIDE_EDGE_AGENTS = (17, 31, 32, 33, 63, 64, 65, 128, 129, 200)
WIDE_BEYOND = 1030


def _bits_of(outputs) -> list:
    return [_bits(t) for t in outputs]


def check_comm_fusion_repeatable(gen: torch.Generator, device, dtype=torch.float32,
                                 agents=(24, 48, 200), rest=(512, 8, 8), fn=k2.comm_fusion) -> dict:
    """K2 called twice on the same inputs (``wide_comm_inputs`` at each N of
    ``agents``, batch 2, every mode) returns the same bits in fused, coef and
    soft: its sums have a fixed order. Returns the calls made by N."""
    out = {}
    for n in agents:
        q, k, v = wide_comm_inputs(gen, 2, n, WIDE_KEY, rest, dtype, device)
        for mode in k2.MODES:
            first = _bits_of(fn(q, k, v, mode, 0.001))
            if not all(torch.equal(a, b) for a, b in zip(first, _bits_of(fn(q, k, v, mode, 0.001)))):
                raise AssertionError(f"K2 at N={n} {dtype} {mode}: two calls differ")
        out[n] = 2 * len(k2.MODES)
    return out


def check_comm_fusion_graph_replay(gen: torch.Generator, dtype=torch.float32, n: int = 48,
                                   rest=(512, 8, 8)) -> dict:
    """K2 captured in a CUDA graph (``torch.cuda.graph``, after a warm-up on
    the capture's stream, as ``graphs.GraphCache`` captures the eval), its
    inputs then overwritten with new ones and the graph replayed: equal bit
    for bit to an eager call on the new inputs, in every mode. Returns the
    wrapper's launches (a warm-up, the capture and the eager call a mode;
    a replay launches without the wrapper)."""
    base = wide_comm_inputs(gen, 2, n, WIDE_KEY, rest, dtype, "cuda")
    new = wide_comm_inputs(gen, 2, n, WIDE_KEY, rest, dtype, "cuda")
    before = k2.comm_fusion.launches
    for mode in k2.MODES:
        static = [t.clone() for t in base]
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            k2.comm_fusion(*static, mode, 0.001)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = k2.comm_fusion(*static, mode, 0.001)
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = k2.comm_fusion(*new, mode, 0.001)
        if not all(torch.equal(a, b) for a, b in zip(_bits_of(captured), _bits_of(want))):
            raise AssertionError(f"K2 at N={n} {dtype} {mode}: graph replay differs from eager")
    return {"n": n, "launches": k2.comm_fusion.launches - before}


# K1 at logits too wide for 16 staged rows in the default 48 KB: (n, C, h, w,
# out_h, out_w). 11 classes 70 and 96 columns wide (16 rows of 49 and 67 KB,
# opted in), 32 classes 32 wide (64 KB); logits wide enough for a block to
# stage 8, 4, 2 and 1 rows (each resized down to 64 columns, which keeps the
# plain version's weight matrix small); 64 classes 1024 wide (one row alone
# is 256 KB: the direct kernel)
K1_WIDE_SHAPES = ((2, 11, 8, 70, 256, 2240), (2, 11, 8, 96, 256, 3072),
                  (2, 32, 8, 32, 256, 1024), (1, 2, 4, 1815, 8, 64),
                  (1, 11, 4, 1320, 8, 64), (1, 11, 4, 2640, 8, 64),
                  (1, 11, 4, 5282, 8, 64), (1, 64, 2, 1024, 4, 2048))


def check_upsample_argmax_wide(gen: torch.Generator, device, dtype=torch.float32,
                               shapes=K1_WIDE_SHAPES, fn=k1.upsample_argmax) -> dict:
    """``check_upsample_argmax`` at each of ``shapes``; returns each shape's
    rows a block stages (``upsample_argmax.plan``) and its result. Launches
    K1 twice a shape."""
    out = {}
    for n, c, h, w, out_h, out_w in shapes:
        x = torch.randn(n, c, h, w, generator=gen).to(device, dtype)
        out[f"C{c}_w{w}"] = {"rows": k1.plan(c, w), **check_upsample_argmax(x, out_h, out_w, fn)}
    return out


# a 16-bit type's (stored significand bits, least normal exponent)
_SIGNIFICANDS = {torch.bfloat16: (7, -126), torch.float16: (10, -14)}


def ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype`` numbers at ``|v|`` (bfloat16 8 significant
    bits, float16 11; below the least normal number, its subnormals')."""
    bits, least = _SIGNIFICANDS[dtype]
    mag = v.float().abs().clamp(min=2.0 ** least)
    return torch.exp2(torch.floor(torch.log2(mag)) - bits)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers (8 significant bits) at ``|v|``."""
    return ulp(v, torch.bfloat16)


def assert_within_ulp(got: torch.Tensor, ref: torch.Tensor, atol: float,
                      dtype: torch.dtype) -> None:
    """Every element of ``got`` within one ``dtype`` ulp (of the larger of
    the two values) plus ``atol`` of ``ref``: two float32 sums of one set of
    terms in another order, each rounded once to ``dtype`` (bfloat16 or
    float16), or one such rounding of a float64 ``ref``. A non-finite
    element passes only where both sides hold the same infinity."""
    g, r = got.double(), ref.double()
    err = (g - r).abs()
    bound = ulp(torch.maximum(g.abs(), r.abs()), dtype).double() + atol
    ok = ((err <= bound) & torch.isfinite(g) & torch.isfinite(r)) | (g == r)
    if not bool(ok.all()):
        worst = int((~ok).double().argmax())
        raise AssertionError(f"{int((~ok).sum())} elements beyond one {dtype} ulp + "
                             f"{atol}: e.g. {g.flatten()[worst].item()} vs "
                             f"{r.flatten()[worst].item()}")


def _bf16_near(got: torch.Tensor, ref: torch.Tensor) -> tuple[torch.Tensor, float, float]:
    """(|got - ref|, the share beyond the near bound, the share allowed)."""
    if got.dtype != torch.bfloat16 or got.shape != ref.shape:
        raise AssertionError(f"K3 gives {got.dtype} {tuple(got.shape)}, "
                             f"plain {ref.dtype} {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs()
    beyond = (err > K3_BF16_NEAR[0] * bf16_ulp(ref) + K3_BF16_NEAR[1]).float().mean().item()
    return err, beyond, K3_BF16_RARE_C64 * got.shape[-1] / 64


def assert_bf16_close(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """K3's bfloat16 comparator (see the module docstring). Returns the
    largest absolute error, the share of elements that differ at all and
    the share beyond the near bound."""
    err, beyond, allowed = _bf16_near(got, ref)
    far = int((err > K3_BF16_FAR[0] * bf16_ulp(ref) + K3_BF16_FAR[1]).sum())
    if far or beyond > allowed:
        raise AssertionError(f"K3 bf16 disagrees: {far} elements beyond {K3_BF16_FAR}, "
                             f"{beyond:.3e} of them beyond {K3_BF16_NEAR} "
                             f"(allowed {allowed:.1e}), largest error {err.max().item()}")
    return {"max_abs_err": err.max().item(),
            "mismatch_share": (err > 0).float().mean().item(), "beyond_near_share": beyond}


def beyond_far(v: torch.Tensor, f64: torch.Tensor) -> int:
    """Elements of ``v`` beyond the far bound (4 ulp + 1e-2) from ``f64``."""
    far = K3_BF16_FAR[0] * bf16_ulp(f64) + K3_BF16_FAR[1]
    return int(((v.double() - f64).abs() > far).sum())


def assert_bf16_wide(got: torch.Tensor, ref: torch.Tensor, f64: torch.Tensor) -> dict:
    """K3's bfloat16 comparator at C >= 256 on one input: the share beyond
    the near bound from the plain version ``ref``, as ``assert_bf16_close``
    holds it, and each side's elements beyond the far bound from ``f64``
    (``beyond_far_from_float64``), which ``assert_far_no_worse`` holds
    summed over seeds."""
    err, beyond, allowed = _bf16_near(got, ref)
    if beyond > allowed:
        raise AssertionError(f"K3 bf16 disagrees: {beyond:.3e} of the elements beyond "
                             f"{K3_BF16_NEAR} (allowed {allowed:.1e}), largest error "
                             f"{err.max().item()}")
    return {"max_abs_err": err.max().item(),
            "mismatch_share": (err > 0).float().mean().item(), "beyond_near_share": beyond,
            "beyond_far_from_float64": {"kernel": beyond_far(got, f64),
                                        "plain": beyond_far(ref, f64)}}


def assert_far_no_worse(results: list[dict]) -> dict:
    """The far-bound rule at C >= 256 over the seeds of one geometry (each an
    ``assert_bf16_wide`` result): the kernel has no more elements beyond the
    far bound from float64 than the plain version. Returns both sums."""
    sums = {side: sum(r["beyond_far_from_float64"][side] for r in results)
            for side in ("kernel", "plain")}
    if sums["kernel"] > sums["plain"]:
        raise AssertionError(f"K3 bf16 lies beyond {K3_BF16_FAR} of float64 at "
                             f"{sums['kernel']} elements, its plain version at {sums['plain']}")
    return sums


def block_float64(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """K3's block in float64 on ``x.dtype`` values, y1 rounded to
    ``x.dtype`` as both K3 and its plain version round it."""
    xc = x.permute(0, 3, 1, 2).double()

    def conv(v, w, s, b):
        w = w.to(x.dtype).double().permute(3, 2, 0, 1)
        return (torch.nn.functional.conv2d(v, w, padding=1) * s.double()[:, None, None]
                + b.double()[:, None, None])

    y = torch.relu(conv(xc, w1, s1, b1)).to(x.dtype).double()
    return torch.relu(conv(y, w2, s2, b2) + xc).permute(0, 2, 3, 1)


def check_fused_block(x, w1, s1, b1, w2, s2, b2) -> dict:
    """K3 on ``x`` (B, H, W, C) on the card against its plain version, in
    ``x.dtype``, with the plain version's convolutions in full float32.
    bfloat16 at C >= 256 returns the far-bound counts that the caller holds
    with ``assert_far_no_worse`` over its seeds."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = k3.fused_basic_block(x, w1, s1, b1, w2, s2, b2)
        ref = k3.fused_basic_block_plain(x, w1, s1, b1, w2, s2, b2)
        if x.dtype == torch.bfloat16 and x.shape[-1] >= K3_BF16_WIDE:
            return assert_bf16_wide(got, ref, block_float64(x, w1, s1, b1, w2, s2, b2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if x.dtype == torch.bfloat16:
        return assert_bf16_close(got, ref)
    torch.testing.assert_close(got, ref, rtol=K3_F32_TOL, atol=K3_F32_TOL)
    return {"max_abs_err": (got - ref).abs().max().item(),
            "mismatch_share": (got != ref).float().mean().item()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.float16: torch.int16}.get(t.dtype, t.dtype))


def check_int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                    stride: int, padding: int, s_x: torch.Tensor | None,
                    out_dtype: torch.dtype, ops: bool = False) -> dict:
    """K4 against ``int8_conv_plain`` on the same tensors: int8 operands,
    int32 sums and the ``out_dtype`` output all equal (the output to the
    bit; a float16 one also within one float16 ulp of the plain float32
    rescale), with the calibrated ``s_x`` or, if None, the dynamic scale.
    Launches the kernel twice (the sums, then the output). ``ops`` holds
    the two ops ``torch.ops.when2com.int8_quantize`` / ``int8_gemm``
    called directly instead of the wrappers."""
    w = k4.prepare_weight(weight)
    s = k4.dynamic_scale(x) if s_x is None else s_x
    geometry = k4.plan(*x.shape, *weight.shape[:1], *weight.shape[2:], stride, padding)
    if ops:
        quantize = torch.ops.when2com.int8_quantize

        def conv(bias_, dtype):
            xq = quantize(x, s, geometry.route, geometry.gemm[2])
            return torch.ops.when2com.int8_gemm(xq, w.operand(geometry), w.s_w, s, bias_,
                                                *weight.shape[1:], *x.shape[2:], stride,
                                                padding, dtype)
    else:
        def quantize(x_, s_, route, cp):
            return k4.quantize_scratch(x_, s_, geometry)

        def conv(bias_, dtype):
            return k4.int8_conv(x, w, s_x, bias_, stride, padding, out_dtype=dtype)
    if not torch.equal(quantize(x, s, geometry.route, geometry.gemm[2]),
                       k4.scratch_plain(x, s, geometry)):
        raise AssertionError(f"int8_conv: the quantize pass's operands ({geometry.route}) "
                             "differ from plain")
    acc = conv(None, torch.int32)
    want_acc = k4.int8_conv_plain(x, w, s, None, stride, padding, torch.int32)
    if not torch.equal(acc, want_acc):
        bad = int((acc != want_acc).sum())
        raise AssertionError(f"int8_conv: {bad} of {acc.numel()} int32 sums differ from plain")
    y = conv(bias, out_dtype)
    want = k4.int8_conv_plain(x, w, s, bias, stride, padding, out_dtype)
    if not torch.equal(_bits(y), _bits(want)):
        bad = int((_bits(y) != _bits(want)).sum())
        raise AssertionError(f"int8_conv: {bad} of {y.numel()} {out_dtype} outputs differ "
                             "from plain")
    if out_dtype == torch.float16:
        assert_within_ulp(y, k4.int8_conv_plain(x, w, s, bias, stride, padding), 0.0,
                          torch.float16)
    return {"max_abs_err": float((y.float() - want.float()).abs().max()),
            "acc_abs_max": int(acc.abs().max()), "s_x": float(s)}
