"""NN primitive blocks, NCHW (port of multiagentperception_tpu/models/blocks.py).

Submodule names follow the reference's ptsemseg modules (``cbr_unit.{0,1}``,
``dcbr_unit.{0,1}``, ``conv1/bn1/conv2/bn2/downsample``, ``fc.{0,2,4}``), so a reference
state_dict loads with ``strict=True``. ``nn.BatchNorm2d`` is the JAX
``TorchBatchNorm`` (blocks.py:30-77) in both modes: in eval mode it
normalizes with ``running_mean``/``running_var`` and eps 1e-5; in training
mode with the batch's mean and biased variance, and it moves the running
statistics by momentum 0.1 towards the batch mean and the unbiased
variance ``n/(n-1)``, as torch does.

Mixed precision follows the JAX blocks' ``dtype=`` (blocks.py:17-19): with
``dtype=torch.bfloat16`` (or ``torch.float16``) the convolutions and linear
layers cast their input, weight and bias to that type at the call and
return it (``Conv2d``, ``ConvTranspose2d``, ``Linear``), while every
parameter and BatchNorm statistic stays float32. ``nn.BatchNorm2d`` with
float32 parameters takes the 16-bit input, works in float32 and returns
the input's type, in both modes and on both devices, which is the JAX
``TorchBatchNorm`` with ``dtype`` set (blocks.py:61-77). ``dtype=None`` is
the float32 program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` when one is set: the
    input, weight and bias are cast at the call, the parameters stay float32
    (flax ``nn.Conv(dtype=...)``). ``None`` runs ``nn.Conv2d`` unchanged.

    On CPU tensors a bf16 or float16 convolution runs as the float32
    convolution of the rounded operands, rounded once to the compute dtype:
    the same exact products (a product of two 16-bit values is exact in
    float32) and float32 sums, as XLA's CPU convolution forms them, without
    oneDNN's bf16 kernels, whose weight gradient is wrong (NaN, inf or
    garbage) for a 1x1 input at stride 2 in torch 2.13's CPU build (the
    policy tower's ``conv5`` below 128x128)."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.compute(x, self.weight, self.bias)

    def compute(self, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
        """The convolution with ``weight`` and ``bias`` (the module's, or a
        shard of them: ``parallel.tensor``)."""
        dt = self.compute_dtype
        if dt is None:
            return self._conv_forward(x, weight, bias)
        x, weight = x.to(dt), weight.to(dt)
        bias = None if bias is None else bias.to(dt)
        if x.device.type == "cpu":
            bias = None if bias is None else bias.float()
            return self._conv_forward(x.float(), weight.float(), bias).to(dt)
        return self._conv_forward(x, weight, bias)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` when one is set, as
    ``Conv2d`` does (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.compute(x, self.weight, self.bias)

    def compute(self, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x, weight, bias)
        bias = None if bias is None else bias.to(dt)
        return F.linear(x.to(dt), weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype`` when one is
    set, as ``Conv2d`` does (flax ``nn.ConvTranspose(dtype=...)``). torch
    2.13's CPU bf16 and float16 transposed convolutions have no fault of
    the kind ``Conv2d`` works around (their gradients lie within the type's
    rounding of float64's at the decoders' geometries), so they run as they
    are."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.compute(x, self.weight, self.bias)

    def compute(self, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is not None:
            x, weight = x.to(dt), weight.to(dt)
            bias = None if bias is None else bias.to(dt)
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class ConvBNRelu(nn.Module):
    """Conv -> BatchNorm -> ReLU (reference: models/utils.py:87-120); with
    ``relu=False`` Conv -> BatchNorm (``ConvBN``, utils.py:9-40).

    Symmetric padding (k-1)//2 at every stride and dilation, as the
    reference's torch convs pad (the JAX package pads the same explicitly;
    flax SAME would pad (0, 1) at stride 2).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, relu: bool = True, dtype: torch.dtype | None = None,
                 dilation: int = 1, bias: bool = True):
        super().__init__()
        p = (kernel_size - 1) // 2
        layers = [Conv2d(in_ch, out_ch, kernel_size, stride, p, dilation=dilation, bias=bias,
                         compute_dtype=dtype),
                  nn.BatchNorm2d(out_ch)]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        self.cbr_unit = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbr_unit(x)


class ConvBN(ConvBNRelu):
    """Conv -> BatchNorm, no ReLU (reference: models/utils.py:9-40)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype | None = None, dilation: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, stride, False, dtype, dilation, bias)


class DeconvBNRelu(nn.Module):
    """ConvTranspose(k=3, stride 2, padding 1, output_padding 1, bias) ->
    BatchNorm -> ReLU, an exact x2 upsample (reference: models/utils.py:148-168).

    This is the reference's geometry: on the stride-dilated input it pads
    (1, 2). The JAX ``DeconvBNRelu`` pads (1, 2) explicitly for that reason
    (flax ``SAME`` splits the padding otherwise and moves every output one
    pixel, blocks.py:121-129) and keeps its kernel unflipped in
    (kh, kw, in, out); ``convert.state_dict_from_flax`` flips it into torch's
    (in, out, kh, kw).
    """

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dcbr_unit = nn.Sequential(
            ConvTranspose2d(in_ch, out_ch, 3, 2, 1, output_padding=1, bias=True,
                            compute_dtype=dtype),
            nn.BatchNorm2d(out_ch), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dcbr_unit(x)


class MLP(nn.Module):
    """Flatten -> Linear stack with interior ReLUs (reference: agent.py:145-178).

    Flattens NCHW in CHW order; the JAX MLP flattens NHWC in HWC order, and
    ``convert.state_dict_from_flax`` permutes the first layer's inputs.
    """

    def __init__(self, in_features: int, features: tuple[int, ...],
                 dtype: torch.dtype | None = None):
        super().__init__()
        layers: list[nn.Module] = []
        for i, f in enumerate(features):
            layers.append(Linear(in_features, f, compute_dtype=dtype))
            if i < len(features) - 1:
                layers.append(nn.ReLU(inplace=True))
            in_features = f
        self.fc = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.flatten(1))


class BasicBlock(nn.Module):
    """ResNet-v1 basic block: two 3x3 convs + identity/projection shortcut.

    The first conv pads (1, 1) at its stride, the second is SAME at stride 1
    (also (1, 1)); the projection is a 1x1 conv at the stride, unpadded.
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = Conv2d(out_ch, out_ch, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, out_ch, 1, stride, 0, bias=False, compute_dtype=dtype),
                nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)
