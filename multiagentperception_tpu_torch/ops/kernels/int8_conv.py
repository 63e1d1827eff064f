"""int8 convolution with per-output-channel weight scales and a per-tensor
activation scale: the int8 towers' kernel (K4).

The JAX package runs this through XLA (``multiagentperception_tpu/quantize.py``
``_int8_conv``, :106-117: ``lax.conv_general_dilated`` on int8 operands with
``preferred_element_type=jnp.int32``); it has no Pallas kernel. PyTorch on
CUDA has no int8 convolution, so on the card ``int8_conv`` launches the
hand-written ``csrc/int8_conv.cu``: a quantize pass (NCHW
float32/bf16/float16 to NHWC int8 scratch, at its byte bound's pace:
16-byte loads along the image row, 16-byte stores along the channels) and
an implicit GEMM on Hopper's ``wgmma`` s8 (persistent, warp-specialized: a
producer warpgroup feeds two consumer warpgroups through an mbarrier ring;
128-pixel x NB-channel tiles with NB = 64/128/256, so a tile's activations
are fetched once for all of Cout up to 256), whose epilogue rescales in
registers, stages the tile in shared memory as [channel][pixel] and
writes NCHW rows as 16-byte stores. For one ``models.blocks.Conv2d``:

    x_i8 = round(clip(x / s_x, -127, 127))        (half to even, jnp.round)
    acc  = conv_int32(x_i8, w_i8)                   (int8 zero padding)
    y    = float(acc) * (s_x * s_w[c]) + bias[c]    (float32, rounded once)

cast once to ``out_dtype`` (float32, bfloat16 or float16: the network's
dtype, as JAX quantize.py:126-132 writes it); ``out_dtype=torch.int32``
returns ``acc`` itself (the checks hold the kernel's sums to the plain
version's). Its bound on the H100 at the flagship's shapes is bytes (the
activations, the int8 scratch and the outputs at 3.35 TB/s), except at 512
channels, where the int8 tensor cores' 1,979 TOPS bound it.

``plan`` picks the GEMM's route from the geometry, in plain Python (the
CPU tests reach it): ``halo`` (3x3, stride 1: one TMA load of a tile's
halo a 64-channel chunk, its 9 taps read through shifted descriptors),
``s2d`` (stride 2 with Cin <= 4, the stem: the quantize pass writes 2 x 2
blocks of pixels as 16-channel pixels, over which the convolution is a
stride-1 one that the halo feeds) and ``gather16`` (any other geometry:
cp.async gather in 16-byte pieces), and NB. The plan is also the one
source of the kernel's shared-memory layout: it picks the compiled
instantiation (``RINGS``) and passes every offset and the size to the
launch, which only refuses a layout that cannot hold it. Each route
launches its kernel or raises; nothing falls back. Its bound at the
flagship's eval step is 7.5 ms (float32 network) / 4.5 ms (bf16 or
float16) of bytes a step at batch 20 x 6; PERF.md gives the times.

The pair runs as two custom ops (``torch.library``), so that
``torch.export`` keeps each as one node: ``when2com::int8_quantize`` (the
scratch of a route) and ``when2com::int8_gemm`` (the GEMM on it), whose
arguments are tensors, ints, strings and a dtype; the GEMM recomputes its
``plan`` from the geometry and takes the weight only as the plan's B
operand (with its scales). On CPU tensors their implementations are the
plain versions: the scratch, then an exact float64 ``F.conv2d`` of its int8
values with the weight unpacked from the operand (``unpack_weight``;
|acc| <= 127^2 * 4608 < 2^31, far inside float64's 2^53), rounded and
cast to int32, the same sums as ``int8_conv_plain``. On CUDA tensors
they launch the kernel or raise: there is no fallback. Their fake
implementations only allocate. On a ``meta`` tensor ``int8_conv`` runs
``int8_conv_plain`` directly. ``int8_conv.launches`` counts launches of
the pair (one per GEMM, in the GEMM op's CUDA implementation),
``int8_conv.route_launches`` per output type and
``int8_conv.geometry_launches`` per GEMM route.

Weights are quantized once (``prepare_weight``): ``quantize.quantize_weight``
of the float32 parameter, and, for the kernel, arranged by ``pack_weight``
as (Cout/NB slices, K stages, 4 planes, NB, 16 bytes): each stage is 64
bytes of K, which a bulk copy brings and the wgmma reads as its B operand.
K runs in (64-channel chunk, tap, channel) order (dense (tap, channel)
over ``s2d_weight``'s 16 channels for the s2d route); channels past Cin
and the output channels past Cout are zeros. An operand of another NB or
the s2d route's is packed at its first use and kept
(``Int8Weight.operand``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from multiagentperception_tpu_torch.ops.kernels import _build

K_STEP = 64  # kKS in csrc/int8_conv.cu: bytes of K a stage, the packed weight's unit
SMEM_LIMIT = 232448  # shared memory a block may hold on the H100 (227 KB)
TILE_M = 128  # output pixels a tile
SMS = 132  # the H100's SMs: a plan gives half of them a tile at least, where it can
HALO_CHUNKS = 4  # kHaloChunks: halo chunks in flight
EPI_CHANNELS = 64  # kEpiChannels: channels an epilogue stages at a time
ROUTE_IDS = {"halo": 0, "gather16": 1, "s2d": 2}
# (route, NB) -> (TPS, NS): 64-byte K stages a ring slot and slots, the
# instantiations csrc/int8_conv.cu compiles (its INT8_CONV_KERNELS). The
# halo route below 256 channels takes a kernel row (3 taps) a slot.
RINGS = {("halo", 64): (3, 8), ("halo", 128): (3, 4), ("halo", 256): (1, 8),
         ("s2d", 64): (1, 8), ("s2d", 128): (1, 8), ("s2d", 256): (1, 8),
         ("gather16", 64): (1, 8), ("gather16", 128): (1, 8), ("gather16", 256): (1, 6)}
EPS = 1e-8
LIBRARY = "int8_conv"  # the build the launches bind; a test may name a debug one (_build.VARIANTS)
# output dtype: (route, C entry point of the GEMM)
ROUTES = {torch.float32: ("f32", "int8_conv_f32"),
          torch.bfloat16: ("bf16", "int8_conv_bf16"),
          torch.float16: ("f16", "int8_conv_f16"),
          torch.int32: ("s32", "int8_conv_s32")}
# input dtype: C entry point of the quantize pass
QUANTIZE = {torch.float32: "int8_quantize_f32", torch.bfloat16: "int8_quantize_bf16",
            torch.float16: "int8_quantize_f16"}
QUANTIZE_S2D = {torch.float32: "int8_quantize_s2d_f32", torch.bfloat16: "int8_quantize_s2d_bf16",
                torch.float16: "int8_quantize_s2d_f16"}
_TAKES = "float32, bfloat16 or float16"


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once: a divisor that is a Python number is a product
    with its reciprocal in PyTorch's CUDA kernels, one ulp away from the
    CPU's (and from JAX's eager) division, so it travels as a tensor, made
    by a fill on ``a``'s device (no host copy: a CUDA graph may capture it)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_weight(kernel: torch.Tensor, eps: float = EPS):
    """Symmetric per-output-channel int8 of an OIHW kernel: (int8 kernel,
    float32 scale (Cout,)), the scale max|w| / 127 over (Cin, kh, kw) per
    output channel (quantize.py:66-73's HWIO axes)."""
    k32 = kernel.float()
    s_w = torch.clamp_min(_div(k32.abs().amax(dim=(1, 2, 3)), 127.0), eps)
    return torch.round(k32 / s_w.view(-1, 1, 1, 1)).to(torch.int8), s_w


def dynamic_scale(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """The per-tensor scale max(max|x| / 127, eps), a float32 scalar on x's device."""
    return torch.clamp_min(_div(x.float().abs().amax(), 127.0), eps)


def quantize_input(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """round(clip(x / s_x, -127, 127)) as int8, in x's layout (plain version)."""
    return torch.round(torch.clamp(x.float() / s_x, -127.0, 127.0)).to(torch.int8)


def padded_channels(c_in: int) -> int:
    """Cp: the input channels of one tap in the kernel's K, Cin rounded up to
    16 (16-byte pieces; the zero channels add exactly 0 to the sums)."""
    return -(-c_in // 16) * 16


def tile_n(cout: int) -> int:
    """NB: the output channels of a GEMM tile, the least of 64, 128, 256
    that holds Cout, else 256 (Cout / 256 slices)."""
    return next(nb for nb in (64, 128, 256) if cout <= nb or nb == 256)


def k_stages(c_in: int, kh: int, kw: int) -> int:
    """K stages of 64 bytes a slice: (64-channel chunk, tap) pairs."""
    return -(-c_in // 64) * kh * kw


def _stages(mat: torch.Tensor, cout: int, nb: int) -> torch.Tensor:
    """A (Cout, stages * 64) K-ordered int8 matrix -> the B operand's
    (Cout/NB, stages, 4, NB, 16), output channels past Cout zero."""
    slices, stages = -(-cout // nb), mat.shape[1] // K_STEP
    mat = F.pad(mat, (0, 0, 0, slices * nb - cout))
    return mat.reshape(slices, nb, stages, 4, 16).permute(0, 2, 3, 1, 4).contiguous()


def pack_weight(w_i8: torch.Tensor, nb: int | None = None) -> torch.Tensor:
    """OIHW int8 -> the kernel's B operand, (Cout/NB, stages, 4, NB, 16) int8:
    stage s of slice n holds K bytes 64s .. 64s+63 of output channels
    n*NB .. n*NB+NB-1 as 4 planes of [channel][16 bytes of K]. NB defaults
    to ``tile_n(Cout)``."""
    cout, c_in, kh, kw = w_i8.shape
    taps, stages = kh * kw, k_stages(c_in, kh, kw)
    hwio = w_i8.permute(0, 2, 3, 1)  # (Cout, kh, kw, Cin)
    mat = (F.pad(hwio, (0, stages // taps * 64 - c_in)).reshape(cout, taps, stages // taps, 64)
           .permute(0, 2, 1, 3).reshape(cout, stages * K_STEP))
    return _stages(mat, cout, nb or tile_n(cout))


def unpack_weight(operand: torch.Tensor, route: str, pad: int, cout: int, c_in: int,
                  kh: int, kw: int) -> torch.Tensor:
    """The inverse of ``pack_weight`` (``pack_s2d`` for ``route`` "s2d", whose
    weight is padded by ``pad``): a B operand -> the (Cout, Cin, kh, kw)
    int8 weight it holds."""
    slices, stages, _, nb, _ = operand.shape
    mat = operand.permute(0, 3, 1, 2, 4).reshape(slices * nb, stages * K_STEP)[:cout]
    if route != "s2d":
        taps = kh * kw
        return (mat.reshape(cout, stages // taps, taps, 64).permute(0, 2, 1, 3)
                .reshape(cout, kh, kw, -1)[..., :c_in].permute(0, 3, 1, 2).contiguous())
    (kh2, pad_y), (_, pad_x) = s2d_taps(kh, pad), s2d_taps(kw, pad)
    w2 = mat.reshape(cout, kh2, -1, 2, 2, 4)
    w_i8 = operand.new_empty((cout, c_in, kh, kw))
    for ky in range(kh):
        dy, sy = divmod(ky - pad, 2)
        for kx in range(kw):
            dx, sx = divmod(kx - pad, 2)
            w_i8[:, :, ky, kx] = w2[:, dy + pad_y, dx + pad_x, sy, sx, :c_in]
    return w_i8


def s2d_taps(k: int, pad: int) -> tuple[int, int]:
    """A stride-2 convolution's taps along one axis over the space-to-depth
    scratch (2 x 2 blocks): (taps, padding) of the stride-1 convolution that
    output o reads, blocks o - padding .. o - padding + taps - 1. Tap k of
    the original kernel lies in block floor((k - pad) / 2), row (k - pad) % 2."""
    lo, hi = (-pad) // 2, (k - 1 - pad) // 2
    return hi - lo + 1, -lo


def s2d_weight(w_i8: torch.Tensor, pad: int) -> torch.Tensor:
    """A stride-2 OIHW int8 weight with Cin <= 4 -> its stride-1 twin over
    the space-to-depth scratch, (Cout, KH', KW', 16) with channel (row * 2 +
    column) * 4 + c of a block; KW' rounded up to 4 taps (a stage), the
    taps and channels that no original tap fills zero."""
    cout, c_in, kh, kw = w_i8.shape
    (kh2, pad_y), (kw2, pad_x) = s2d_taps(kh, pad), s2d_taps(kw, pad)
    out = w_i8.new_zeros((cout, kh2, -(-kw2 // 4) * 4, 2, 2, 4))
    for ky in range(kh):
        dy, sy = divmod(ky - pad, 2)
        for kx in range(kw):
            dx, sx = divmod(kx - pad, 2)
            out[:, dy + pad_y, dx + pad_x, sy, sx, :c_in] = w_i8[:, :, ky, kx]
    return out.reshape(cout, kh2, out.shape[2], 16)


def pack_s2d(w_i8: torch.Tensor, pad: int, nb: int) -> torch.Tensor:
    """The B operand of the s2d route: ``s2d_weight`` in dense (tap, channel)
    K order, 4 taps a stage."""
    w2 = s2d_weight(w_i8, pad)
    return _stages(w2.reshape(w2.shape[0], -1), w2.shape[0], nb)


def space_to_depth(xq: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4) int8 -> the s2d scratch (N, ceil(H/2), ceil(W/2), 16),
    zero past the image (the plain version of the s2d quantize pass)."""
    n, h, w, c = xq.shape
    xq = F.pad(xq, (0, 0, 0, w % 2, 0, h % 2))
    h2, w2 = xq.shape[1] // 2, xq.shape[2] // 2
    return xq.reshape(n, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h2, w2, 4 * c)


@dataclass(frozen=True)
class Plan:
    """How the GEMM runs one geometry: its route (``ROUTE_IDS``), NB and the
    output-channel slices, K stages a slice, the halo tile TH x TW and its
    TMA box (channels, width, height, images; 0 x 0 and None off the halo
    routes), tiles; ``gemm``, the geometry the GEMM launches with, (H, W,
    Cp, KH, KW, stride, padding) of its scratch (the s2d route's: blocks,
    16 channels, stride 1), ``out``, (OH, OW), and ``pad``, the
    convolution's own padding. Then the kernel's shared memory, as the
    launch lays it out: the instantiation's (TPS, NS) (``RINGS``), the
    bytes of a halo plane (16 channels of the box), the offsets of the ring,
    the epilogues and the mbarriers from the 128-byte aligned base, and
    ``smem``, the dynamic shared memory a block holds. ``size`` is the
    input's (H, W), from which the GEMM op recomputes the plan."""
    route: str
    nb: int
    slices: int
    stages: int
    tw: int
    th: int
    box: tuple[int, int, int, int] | None
    tiles: int
    gemm: tuple[int, int, int, int, int, int, int]
    out: tuple[int, int]
    pad: int
    tps: int
    ns: int
    plane: int
    off_ring: int
    off_epi: int
    off_bar: int
    smem: int
    size: tuple[int, int] | None = None


@functools.lru_cache(maxsize=1024)  # a model has tens of geometries
def plan(n: int, c_in: int, h: int, w: int, cout: int, kh: int, kw: int, stride: int,
         pad: int) -> Plan:
    """The GEMM's route, sizes and shared memory for an (n, c_in, h, w)
    input and a (cout, c_in, kh, kw) weight at ``stride`` and ``pad``: s2d
    at stride 2 with Cin <= 4 where its halo fits the card's shared memory,
    halo at 3x3 stride 1, else gather16."""
    oh, ow = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    if c_in <= 4 and stride == 2:
        (kh2, pad2), kw2 = s2d_taps(kh, pad), -(-s2d_taps(kw, pad)[0] // 4) * 4
        g = _plan("s2d", n, cout, (-(-h // 2), -(-w // 2), 16, kh2, kw2, 1, pad2), kh2 * kw2 // 4,
                  (oh, ow), pad, (h, w))
        if g.smem <= SMEM_LIMIT:
            return g
    route = "halo" if (kh, kw, stride) == (3, 3, 1) else "gather16"
    return _plan(route, n, cout, (h, w, padded_channels(c_in), kh, kw, stride, pad),
                 k_stages(c_in, kh, kw), (oh, ow), pad, (h, w))


def _plan(route: str, n: int, cout: int, gemm: tuple, stages: int, out: tuple[int, int],
          pad: int, size: tuple[int, int] | None = None) -> Plan:
    """``plan`` once the route is chosen. NB is ``tile_n(cout)``, halved
    (down to 64) while the tiles do not fill half the card's SMs."""
    oh, ow = out
    nb, halo = tile_n(cout), route != "gather16"
    if halo:
        tw = 8 if ow <= 8 else 16
        th = TILE_M // tw
        pixel_tiles = -(-ow // tw) * -(-oh // th) * n
    else:
        tw, th, pixel_tiles = 0, 0, -(-(n * oh * ow) // TILE_M)
    while nb > 64 and pixel_tiles * -(-cout // nb) < SMS // 2:
        nb //= 2
    tps, ns = RINGS[route, nb]
    # a slot: TPS stages' weights, and the stage's A when gathering
    stage = K_STEP * nb * tps + (0 if halo else TILE_M * K_STEP)
    box, plane = None, 0
    if halo:  # the halo of a tile, 16 channels a plane, 4 planes a chunk
        box = (16, tw + gemm[4] - 1, th + gemm[3] - 1, 1)
        plane = -(-(box[1] * box[2] * 16) // 128) * 128
    off_ring = HALO_CHUNKS * 4 * plane
    off_epi = off_ring + ns * stage
    # each epilogue (one per warpgroup below 256 channels): its staging of
    # 64 channels x TILE_M pixels (pitch TILE_M + 4 words), scales, shifts
    off_bar = off_epi + (2 if nb < 256 else 1) * (EPI_CHANNELS * (TILE_M + 4) * 4 + 2 * nb * 4)
    # the mbarriers (full, empty, halo full, halo empty, turn), then 128
    # bytes to align the base
    smem = off_bar + (2 * ns + 2 * HALO_CHUNKS + 2) * 8 + 128
    return Plan(route, nb, -(-cout // nb), stages, tw, th, box, pixel_tiles * -(-cout // nb),
                gemm, out, pad, tps, ns, plane, off_ring, off_epi, off_bar, smem, size)


@dataclass
class Int8Weight:
    """A convolution's weight quantized once: ``w_i8`` (OIHW int8),
    ``s_w`` (Cout,) float32, ``packed``, the kernel's B operand at the
    default NB (``pack_weight``), and the other B operands a plan asks for
    (another NB, the s2d route's), packed at first use (``operand``)."""
    w_i8: torch.Tensor
    s_w: torch.Tensor
    packed: torch.Tensor
    others: dict = field(default_factory=dict)

    def operand(self, geometry: Plan) -> torch.Tensor:
        """The B operand that ``geometry``'s route and NB read."""
        s2d = geometry.route == "s2d"
        if not s2d and geometry.nb == self.packed.shape[3]:
            return self.packed
        key = (s2d, geometry.nb, geometry.pad if s2d else 0)
        if key not in self.others:
            self.others[key] = (pack_s2d(self.w_i8, geometry.pad, geometry.nb) if s2d
                                else pack_weight(self.w_i8, geometry.nb))
        return self.others[key]


def prepare_weight(weight: torch.Tensor) -> Int8Weight:
    """Quantize a float32 OIHW parameter (on its device) for ``int8_conv``.
    It reads the parameter detached, so it needs no ``no_grad`` (whose grad
    toggles a trace of a weight-hotswap export would have to inline)."""
    w_i8, s_w = quantize_weight(weight.detach())
    return Int8Weight(w_i8, s_w.contiguous(), pack_weight(w_i8))


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _check(x, w_shape: tuple, stride, padding, dilation, groups, out_dtype):
    """The geometry the kernel (and so the port) takes for NCHW ``x`` and an
    OIHW weight of ``w_shape``, or a ValueError/TypeError."""
    if groups != 1:
        raise ValueError(f"int8_conv takes groups=1, got {groups}")
    if _pair(dilation) != (1, 1):
        raise ValueError(f"int8_conv takes dilation 1, got {dilation}")
    if isinstance(padding, str):
        raise ValueError(f"int8_conv takes explicit padding, got {padding!r}")
    if x.dim() != 4 or len(w_shape) != 4 or x.shape[1] != w_shape[1]:
        raise ValueError(f"int8_conv: input {tuple(x.shape)} against weight "
                         f"{tuple(w_shape)}")
    if x.dtype not in QUANTIZE:
        raise TypeError(f"int8_conv takes {_TAKES} input, got {x.dtype}")
    if out_dtype not in ROUTES:
        raise TypeError(f"int8_conv writes {_TAKES} or int32, got {out_dtype}")
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if sh != sw or ph != pw:
        raise ValueError(f"int8_conv takes square stride and padding, got {stride}, {padding}")
    kh, kw = w_shape[2:]
    oh = (x.shape[2] + 2 * ph - kh) // sh + 1
    ow = (x.shape[3] + 2 * pw - kw) // sw + 1
    if oh <= 0 or ow <= 0 or x.shape[0] == 0:
        raise ValueError(f"int8_conv: empty output for input {tuple(x.shape)}")
    return sh, ph, oh, ow


def int8_conv_plain(x: torch.Tensor, w: Int8Weight, s_x: torch.Tensor,
                    bias: torch.Tensor | None, stride=1, padding=0,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The same function in plain PyTorch: the int32 sum from an exact
    float64 convolution of the int8 values, then the kernel's epilogue."""
    return _sums_plain(quantize_input(x, s_x), w.w_i8, w.s_w, s_x, bias, stride, padding,
                       out_dtype)


def _sums_plain(x_i8: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor, s_x: torch.Tensor,
                bias: torch.Tensor | None, stride, padding, out_dtype: torch.dtype):
    """The exact int32 sums of NCHW int8 ``x_i8`` with ``w_i8``, then the
    kernel's epilogue (none for ``out_dtype=torch.int32``)."""
    acc = torch.round(F.conv2d(x_i8.double(), w_i8.double(), stride=stride,
                               padding=padding)).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * (s_x * s_w).view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    return y.to(out_dtype)


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _on(device: torch.device):
    """The CUDA runtime launches on its current device: make it ``device``'s
    (a context entered only where it is another, to keep the launch cheap)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def quantize_nhwc(x: torch.Tensor, s_x: torch.Tensor, cp: int) -> torch.Tensor:
    """The quantize pass alone: NCHW x -> (N, H, W, Cp) int8 on the card."""
    n, c, h, w = x.shape
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    lib = _build.load(LIBRARY)
    with _on(x.device):
        rc = getattr(lib, QUANTIZE[x.dtype])(x.data_ptr(), s_x.data_ptr(), n, c, h * w, cp,
                                             xq.data_ptr(), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"int8_conv quantize launch failed: CUDA error {rc}")
    return xq


def quantize_s2d(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """The s2d route's quantize pass alone: NCHW x (Cin <= 4) -> the
    space-to-depth scratch (N, ceil(H/2), ceil(W/2), 16) int8 on the card."""
    n, c, h, w = x.shape
    xq = torch.empty((n, -(-h // 2), -(-w // 2), 16), dtype=torch.int8, device=x.device)
    lib = _build.load(LIBRARY)
    with _on(x.device):
        rc = getattr(lib, QUANTIZE_S2D[x.dtype])(x.data_ptr(), s_x.data_ptr(), n, c, h, w,
                                                 xq.data_ptr(), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"int8_conv quantize launch failed: CUDA error {rc}")
    return xq


def quantize_scratch(x: torch.Tensor, s_x: torch.Tensor, geometry: Plan) -> torch.Tensor:
    """The quantize pass of ``geometry``'s route: the scratch its GEMM reads."""
    return QUANTIZE_OP(x, s_x, geometry.route, geometry.gemm[2])


def scratch_plain(x: torch.Tensor, s_x: torch.Tensor, geometry: Plan) -> torch.Tensor:
    """``quantize_scratch`` in plain PyTorch."""
    return _scratch_plain(x, s_x, geometry.route, geometry.gemm[2])


def _scratch_plain(x: torch.Tensor, s_x: torch.Tensor, route: str, cp: int) -> torch.Tensor:
    q = quantize_input(x, s_x).permute(0, 2, 3, 1)
    if route == "s2d":  # 4 channels a pixel, 2 x 2 pixels a block
        return space_to_depth(F.pad(q, (0, 4 - x.shape[1])).contiguous())
    return F.pad(q, (0, cp - x.shape[1])).contiguous()


def int8_conv(x: torch.Tensor, w: Int8Weight, s_x: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, stride=1, padding=0, dilation=1,
              groups: int = 1, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """NCHW float32/bf16/float16 ``x`` -> NCHW ``out_dtype`` (default x's dtype)
    int8 convolution with ``w`` (``prepare_weight``). ``s_x`` is the
    activation scale, a float32 scalar tensor on x's device (a calibrated
    one), or None for the dynamic scale ``dynamic_scale(x)``. ``bias`` is
    the float32 parameter."""
    out_dtype = out_dtype or x.dtype
    stride_, pad, _, _ = _check(x, w.w_i8.shape, stride, padding, dilation, groups, out_dtype)
    if s_x is None:
        s_x = dynamic_scale(x)
    if x.device.type == "meta":
        return int8_conv_plain(x, w, s_x, bias, stride, padding, out_dtype)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n, c_in, h, wd = x.shape
    kernel = tuple(w.w_i8.shape[2:])
    geometry = plan(n, c_in, h, wd, w.w_i8.shape[0], *kernel, stride_, pad)
    return int8_conv_ops(x, w.operand(geometry), w.s_w, s_x, bias, kernel, stride_, pad,
                         out_dtype)


def int8_conv_ops(x: torch.Tensor, operand: torch.Tensor, s_w: torch.Tensor,
                  s_x: torch.Tensor, bias: torch.Tensor | None, kernel: tuple[int, int],
                  stride: int, pad: int, out_dtype: torch.dtype) -> torch.Tensor:
    """``int8_conv`` on checked arguments, as the two ops: ``operand`` is
    the B operand that the geometry's plan reads (``Int8Weight.operand``) of
    a ``kernel`` (kh, kw) weight, ``s_w`` its scales. A serving graph with
    baked int8 weights calls this on its buffers."""
    n, c_in, h, w = x.shape
    geometry = plan(n, c_in, h, w, s_w.shape[0], *kernel, stride, pad)
    xq = QUANTIZE_OP(x, s_x, geometry.route, geometry.gemm[2])
    return GEMM_OP(xq, operand, s_w, s_x, bias, c_in, *kernel, h, w, stride, pad, out_dtype)


def _check_operand(operand: torch.Tensor, geometry: Plan) -> None:
    want = (geometry.slices, geometry.stages, 4, geometry.nb, 16)
    if tuple(operand.shape) != want or operand.dtype != torch.int8 or \
            not operand.is_contiguous():
        raise ValueError(f"int8_conv: the packed weight {tuple(operand.shape)} is not the "
                         f"kernel's layout {want} (pack_weight)")
    if geometry.smem > SMEM_LIMIT:
        raise ValueError(f"int8_conv: {geometry} needs {geometry.smem} bytes of shared memory")


def _check_scratch(xq: torch.Tensor, geometry: Plan) -> None:
    h, wd, cp = geometry.gemm[:3]
    if xq.dtype != torch.int8 or not xq.is_contiguous() or tuple(xq.shape[1:]) != (h, wd, cp):
        raise ValueError(f"int8_conv: the scratch {tuple(xq.shape)} {xq.dtype} is not "
                         f"{geometry.route}'s ({h}, {wd}, {cp})")


def conv_nhwc(xq: torch.Tensor, w: Int8Weight, s_x: torch.Tensor, bias: torch.Tensor | None,
              geometry: Plan, out_dtype: torch.dtype,
              operand: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's second launch alone, the GEMM: ``geometry``'s scratch
    ``xq`` (``quantize_scratch``) -> NCHW ``out_dtype``, through the GEMM op
    (its plain version on CPU tensors)."""
    if operand is None:
        operand = w.operand(geometry)
    _check_operand(operand, geometry)
    _check_scratch(xq, geometry)
    stride = 2 if geometry.route == "s2d" else geometry.gemm[5]  # the s2d GEMM's is 1
    _, c_in, kh, kw = w.w_i8.shape
    return GEMM_OP(xq, operand, w.s_w, s_x, bias, c_in, kh, kw, *geometry.size, stride,
                   geometry.pad, out_dtype)


# ------------------------------------------------------------------ the ops

@torch.library.custom_op("when2com::int8_quantize", mutates_args=(), device_types="cpu")
def int8_quantize_op(x: torch.Tensor, s_x: torch.Tensor, route: str, cp: int) -> torch.Tensor:
    """The scratch that ``route``'s GEMM reads from NCHW ``x``: (N, H, W, cp)
    int8, or the s2d route's (N, ceil(H/2), ceil(W/2), 16). The CPU
    implementation: the plain version."""
    return _scratch_plain(x, s_x, route, cp)


@int8_quantize_op.register_fake
def _quantize_fake(x, s_x, route, cp):
    n, _, h, w = x.shape
    shape = (n, (h + 1) // 2, (w + 1) // 2, 16) if route == "s2d" else (n, h, w, cp)
    return x.new_empty(shape, dtype=torch.int8)


def _quantize_launch(x, s_x, route, cp):
    """The CUDA implementation: the quantize pass, or an error."""
    if x.dtype not in QUANTIZE:
        raise TypeError(f"int8_conv takes {_TAKES} input, got {x.dtype}")
    if s_x.device != x.device:
        raise ValueError("int8_conv: the input, weight, scales and bias must share a device")
    if s_x.dtype != torch.float32 or s_x.numel() != 1:
        raise TypeError("int8_conv: s_x must be one float32 value")
    if not x.is_contiguous():
        raise ValueError("int8_conv kernel takes a contiguous NCHW input")
    n, c_in, h, w = x.shape
    if n * (h + 1) * (w + 1) * cp >= 2**31:
        raise ValueError(f"int8_conv: input {tuple(x.shape)} too large for 32-bit indices")
    if route == "s2d":
        if c_in > 4:
            raise ValueError(f"int8_conv: the s2d scratch takes Cin <= 4, got {c_in}")
        return quantize_s2d(x, s_x)
    if cp < c_in or cp % 16:
        raise ValueError(f"int8_conv: {cp} scratch channels for Cin {c_in}")
    return quantize_nhwc(x, s_x, cp)


def _gemm_plan(xq, s_w, c_in, kh, kw, h, w, stride, pad) -> Plan:
    return plan(xq.shape[0], c_in, h, w, s_w.shape[0], kh, kw, stride, pad)


@torch.library.custom_op("when2com::int8_gemm", mutates_args=(), device_types="cpu")
def int8_gemm_op(xq: torch.Tensor, operand: torch.Tensor, s_w: torch.Tensor,
                 s_x: torch.Tensor, bias: torch.Tensor | None, c_in: int, kh: int, kw: int,
                 h: int, w: int, stride: int, pad: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The GEMM of an ``h`` x ``w`` input's convolution with a (len(s_w),
    c_in, kh, kw) int8 weight on its scratch ``xq`` (``int8_quantize``):
    NCHW ``out_dtype``. ``operand`` is the weight as the plan's B operand
    (``Int8Weight.operand``), ``s_w`` its per-channel scales. The CPU
    implementation: the exact sums of the scratch's int8 values with the
    weight unpacked from the operand (``unpack_weight``)."""
    geometry = _gemm_plan(xq, s_w, c_in, kh, kw, h, w, stride, pad)
    _check_operand(operand, geometry)
    _check_scratch(xq, geometry)
    w_i8 = unpack_weight(operand, geometry.route, pad, s_w.shape[0], c_in, kh, kw)
    n = xq.shape[0]
    if geometry.route == "s2d":  # the blocks back to pixels
        h2, w2 = geometry.gemm[:2]
        xq = xq.reshape(n, h2, w2, 2, 2, 4).permute(0, 1, 3, 2, 4, 5).reshape(
            n, 2 * h2, 2 * w2, 4)[:, :h, :w]
    x_i8 = xq[..., :c_in].permute(0, 3, 1, 2)
    # contiguous NCHW, as the kernel writes (the conv of the NHWC view is not)
    return _sums_plain(x_i8, w_i8, s_w, s_x, bias, stride, pad, out_dtype).contiguous()


@int8_gemm_op.register_fake
def _gemm_fake(xq, operand, s_w, s_x, bias, c_in, kh, kw, h, w, stride, pad, out_dtype):
    out = ((h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1)
    return xq.new_empty((xq.shape[0], s_w.shape[0], *out), dtype=out_dtype)


def _gemm_launch(xq, operand, s_w, s_x, bias, c_in, kh, kw, h, w, stride, pad, out_dtype):
    """The CUDA implementation: the GEMM kernel, or an error."""
    tensors = [operand, s_w, s_x] + ([] if bias is None else [bias])
    if any(t.device != xq.device for t in tensors):
        raise ValueError("int8_conv: the input, weight, scales and bias must share a device")
    if out_dtype not in ROUTES:
        raise TypeError(f"int8_conv writes {_TAKES} or int32, got {out_dtype}")
    if s_x.dtype != torch.float32 or s_x.numel() != 1:
        raise TypeError("int8_conv: s_x must be one float32 value")
    if s_w.dtype != torch.float32 or s_w.dim() != 1 or not s_w.is_contiguous():
        raise TypeError("int8_conv: s_w must be the contiguous float32 (Cout,) scales")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()):
        raise TypeError("int8_conv: the bias must be the contiguous float32 parameter")
    geometry = _gemm_plan(xq, s_w, c_in, kh, kw, h, w, stride, pad)
    n, cout = xq.shape[0], s_w.shape[0]
    oh, ow = geometry.out
    if n * oh * ow >= 2**31:
        raise ValueError(f"int8_conv: output ({n}, {cout}, {oh}, {ow}) too large for 32-bit "
                         "indices")
    _check_operand(operand, geometry)
    _check_scratch(xq, geometry)
    gh, gw, cp, gkh, gkw, gstride, gpad = geometry.gemm
    out = torch.empty((n, cout, oh, ow), dtype=out_dtype, device=xq.device)
    lib = _build.load(LIBRARY)
    with _on(xq.device):
        rc = getattr(lib, ROUTES[out_dtype][1])(
            xq.data_ptr(), operand.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            n, gh, gw, cp, cout, gkh, gkw, gstride, gpad, oh, ow, ROUTE_IDS[geometry.route],
            geometry.nb, geometry.tps, geometry.ns, geometry.tw, geometry.th, geometry.plane,
            geometry.off_ring, geometry.off_epi, geometry.off_bar, geometry.smem,
            _stream(xq.device))
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed ({geometry.route}): CUDA error {rc}")
    int8_conv.route_launches[ROUTES[out_dtype][0]] += 1
    int8_conv.geometry_launches[geometry.route] += 1
    int8_conv.launches += 1
    return out


# registered straight with the dispatcher, as K1's (upsample_argmax.py)
torch.library.impl("when2com::int8_quantize", "cuda", _quantize_launch)
torch.library.impl("when2com::int8_gemm", "cuda", _gemm_launch)
QUANTIZE_OP = torch.ops.when2com.int8_quantize.default  # what the wrappers call
GEMM_OP = torch.ops.when2com.int8_gemm.default

int8_conv.launches = 0
int8_conv.route_launches = {route: 0 for route, _ in ROUTES.values()}
int8_conv.geometry_launches = dict.fromkeys(ROUTE_IDS, 0)
