"""int8 convolution with per-output-channel weight scales and a per-tensor
activation scale: the int8 towers' kernel (K4).

The JAX package runs this through XLA (``multiagentperception_tpu/quantize.py``
``_int8_conv``, :106-117: ``lax.conv_general_dilated`` on int8 operands with
``preferred_element_type=jnp.int32``); it has no Pallas kernel. PyTorch on
CUDA has no int8 convolution, so on the card ``int8_conv`` launches the
hand-written ``csrc/int8_conv.cu``: a quantize pass (NCHW float32/bf16 to
NHWC int8 scratch) and an implicit-GEMM ``mma.sync`` s8 kernel whose
epilogue rescales and writes NCHW. For one ``models.blocks.Conv2d``:

    x_i8 = round(clip(x / s_x, -127, 127))        (half to even, jnp.round)
    acc  = conv_int32(x_i8, w_i8)                   (int8 zero padding)
    y    = float(acc) * (s_x * s_w[c]) + bias[c]    (float32, rounded once)

cast once to ``out_dtype``; ``out_dtype=torch.int32`` returns ``acc``
itself (the checks hold the kernel's sums to the plain version's). Its
bound on the H100 is the int8 tensor cores' 1,979 TOPS, or the bytes
(``csrc/int8_conv.cu`` says which at the flagship).

On a CPU (or ``meta``) tensor it runs ``int8_conv_plain``: the int32 sum
is an exact float64 ``F.conv2d`` of the int8 values (|acc| <= 127^2 * 4608
< 2^31, far inside float64's 2^53), rounded and cast to int32. On a CUDA
tensor it launches the kernel or raises: there is no fallback.
``int8_conv.launches`` counts launches of the pair (one per call),
``int8_conv.route_launches`` per output type.

Weights are quantized once (``prepare_weight``): ``quantize.quantize_weight``
of the float32 parameter, and, for the kernel, arranged as a (Cout, Kp)
int8 matrix in (kh, kw, c) order with Cin padded to ``Cp`` and K to a
multiple of 64 (``pack_weight``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from multiagentperception_tpu_torch.ops.kernels import _build

K_STEP = 64  # kBK in csrc/int8_conv.cu: Kp is a multiple of it
EPS = 1e-8
# output dtype: (route, C entry point of the GEMM)
ROUTES = {torch.float32: ("f32", "int8_conv_f32"),
          torch.bfloat16: ("bf16", "int8_conv_bf16"),
          torch.int32: ("s32", "int8_conv_s32")}
# input dtype: C entry point of the quantize pass
QUANTIZE = {torch.float32: "int8_quantize_f32", torch.bfloat16: "int8_quantize_bf16"}


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once: a divisor that is a Python number is a product
    with its reciprocal in PyTorch's CUDA kernels, one ulp away from the
    CPU's (and from JAX's eager) division, so it travels as a tensor."""
    return a / a.new_tensor(b)


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
    """Cp: the input channels of one tap in the kernel's K, Cin where it is a
    multiple of 16 (16-byte pieces), else Cin rounded up to 4."""
    return c_in if c_in % 16 == 0 else -(-c_in // 4) * 4


def pack_weight(w_i8: torch.Tensor) -> torch.Tensor:
    """OIHW int8 -> the kernel's (Cout, Kp) int8 B matrix, k = (kh * KW + kw) * Cp + c."""
    cout, c_in, kh, kw = w_i8.shape
    cp = padded_channels(c_in)
    hwio = F.pad(w_i8.permute(0, 2, 3, 1), (0, cp - c_in))  # (Cout, kh, kw, Cp)
    k_real = kh * kw * cp
    k_pad = -(-k_real // K_STEP) * K_STEP
    return F.pad(hwio.reshape(cout, k_real), (0, k_pad - k_real)).contiguous()


@dataclass
class Int8Weight:
    """A convolution's weight quantized once: ``w_i8`` (OIHW int8),
    ``s_w`` (Cout,) float32 and ``packed``, the kernel's (Cout, Kp) matrix."""
    w_i8: torch.Tensor
    s_w: torch.Tensor
    packed: torch.Tensor


@torch.no_grad()
def prepare_weight(weight: torch.Tensor) -> Int8Weight:
    """Quantize a float32 OIHW parameter (on its device) for ``int8_conv``."""
    w_i8, s_w = quantize_weight(weight.detach())
    return Int8Weight(w_i8, s_w.contiguous(), pack_weight(w_i8))


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _check(x, w: Int8Weight, stride, padding, dilation, groups, out_dtype):
    """The geometry the kernel (and so the port) takes, or a ValueError/TypeError."""
    if groups != 1:
        raise ValueError(f"int8_conv takes groups=1, got {groups}")
    if _pair(dilation) != (1, 1):
        raise ValueError(f"int8_conv takes dilation 1, got {dilation}")
    if isinstance(padding, str):
        raise ValueError(f"int8_conv takes explicit padding, got {padding!r}")
    if x.dim() != 4 or w.w_i8.dim() != 4 or x.shape[1] != w.w_i8.shape[1]:
        raise ValueError(f"int8_conv: input {tuple(x.shape)} against weight "
                         f"{tuple(w.w_i8.shape)}")
    if x.dtype not in QUANTIZE:
        raise TypeError(f"int8_conv takes float32 or bfloat16 input, got {x.dtype}")
    if out_dtype not in ROUTES:
        raise TypeError(f"int8_conv writes float32, bfloat16 or int32, got {out_dtype}")
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if sh != sw or ph != pw:
        raise ValueError(f"int8_conv takes square stride and padding, got {stride}, {padding}")
    kh, kw = w.w_i8.shape[2:]
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
    x_i8 = quantize_input(x, s_x)
    acc = torch.round(F.conv2d(x_i8.double(), w.w_i8.double(), stride=stride,
                               padding=padding)).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * (s_x * w.s_w).view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    return y.to(out_dtype)


def quantize_nhwc(x: torch.Tensor, s_x: torch.Tensor, cp: int) -> torch.Tensor:
    """The kernel's first launch alone: NCHW x -> (N, H, W, Cp) int8 on the card."""
    n, c, h, w = x.shape
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    lib = _build.load("int8_conv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, QUANTIZE[x.dtype])(x.data_ptr(), s_x.data_ptr(), n, c, h * w, cp,
                                             xq.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"int8_conv quantize launch failed: CUDA error {rc}")
    return xq


def int8_conv(x: torch.Tensor, w: Int8Weight, s_x: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, stride=1, padding=0, dilation=1,
              groups: int = 1, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """NCHW float32/bf16 ``x`` -> NCHW ``out_dtype`` (default x's dtype)
    int8 convolution with ``w`` (``prepare_weight``). ``s_x`` is the
    activation scale, a float32 scalar tensor on x's device (a calibrated
    one), or None for the dynamic scale ``dynamic_scale(x)``. ``bias`` is
    the float32 parameter."""
    out_dtype = out_dtype or x.dtype
    stride_, pad, oh, ow = _check(x, w, stride, padding, dilation, groups, out_dtype)
    if s_x is None:
        s_x = dynamic_scale(x)
    if x.device.type in ("cpu", "meta"):
        return int8_conv_plain(x, w, s_x, bias, stride, padding, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tensors = [w.w_i8, w.s_w, w.packed, s_x] + ([] if bias is None else [bias])
    if any(t.device != x.device for t in tensors):
        raise ValueError("int8_conv: the input, weight, scales and bias must share a device")
    if s_x.dtype != torch.float32 or s_x.numel() != 1:
        raise TypeError("int8_conv: s_x must be one float32 value")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()):
        raise TypeError("int8_conv: the bias must be the contiguous float32 parameter")
    if not x.is_contiguous():
        raise ValueError("int8_conv kernel takes a contiguous NCHW input")
    n, c_in, h, wd = x.shape
    cout, _, kh, kw = w.w_i8.shape
    cp = padded_channels(c_in)
    if w.packed.shape[1] % K_STEP or w.packed.shape != (cout, w.packed.shape[1]):
        raise ValueError("int8_conv: the packed weight is not the kernel's layout")
    if n * oh * ow >= 2**31 or n * h * wd * cp >= 2**31:
        raise ValueError(f"int8_conv: input {tuple(x.shape)} too large for 32-bit indices")
    xq = quantize_nhwc(x, s_x, cp)
    out = torch.empty((n, cout, oh, ow), dtype=out_dtype, device=x.device)
    route, entry = ROUTES[out_dtype]
    lib = _build.load("int8_conv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            xq.data_ptr(), w.packed.data_ptr(), w.s_w.data_ptr(), s_x.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            n, h, wd, cp, cout, kh, kw, stride_, pad, oh, ow, w.packed.shape[1],
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {rc}")
    int8_conv.route_launches[route] += 1
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
int8_conv.route_launches = {route: 0 for route, _ in ROUTES.values()}
