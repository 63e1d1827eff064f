"""Encoder/decoder backbones, NCHW (port of multiagentperception_tpu/models/backbone.py).

Encoders: ``resnet_encoder`` (random-init ResNet-18 trunk, reference
backbone.py:58-96; every shipped config's) and ``n_segnet_encoder`` (13
conv-BN-ReLU layers, backbone.py:12-55). Decoders: ``simple_decoder``
(backbone.py:143-164; every shipped config's), ``FCN_decoder`` (broken in
the reference, undefined ``base_4`` at backbone.py:179; the JAX package's
working conv head + x32 upsample) and ``n_segnet_decoder`` (12
deconv/conv-BN-ReLU layers, backbone.py:99-140). ``dtype`` is the compute
dtype of the convolutions (``models.blocks``); the decoders' x32 resize
runs in its input's dtype, as the JAX ``bilinear_resize`` does
(ops/resize.py:53-57).

A decoder whose JAX twin sows ``pre_logits`` (simple, FCN) has
``logits()``, the logits before the upsample, which the eval hands to the
upsample+argmax kernel; ``n_segnet_decoder`` has none: its forward already
gives full-resolution logits (``has_pre_logits``).
"""

from __future__ import annotations

import torch
from torch import nn

from multiagentperception_tpu_torch.models.blocks import (
    BasicBlock,
    Conv2d,
    ConvBNRelu,
    DeconvBNRelu,
)
from multiagentperception_tpu_torch.ops.resize import bilinear_resize


class _ResNet18Trunk(nn.Module):
    """conv1 7x7/2 pad 3 -> bn1 -> relu -> maxpool 3x3/2 pad 1 -> layer1..4,
    with torchvision's state_dict names."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, compute_dtype=dtype)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        chans = [64, 64, 128, 256, 512]
        for i in range(1, 5):
            stride = 1 if i == 1 else 2
            setattr(self, f"layer{i}", nn.Sequential(
                BasicBlock(chans[i - 1], chans[i], stride, dtype),
                BasicBlock(chans[i], chans[i], 1, dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


class NSegnetEncoder(nn.Module):
    """13 conv-BN-ReLU layers ``conv1..conv13``, five of them stride 2 ->
    512ch @ 1/32 (reference: backbone.py:12-55)."""

    PLAN = ((64, 1), (64, 2), (128, 1), (128, 2), (256, 1), (256, 1), (256, 2),
            (512, 1), (512, 1), (512, 2), (512, 1), (512, 1), (512, 2))  # (features, stride)

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        cin = 3
        for i, (feats, stride) in enumerate(self.PLAN):
            setattr(self, f"conv{i + 1}", ConvBNRelu(cin, feats, 3, stride, dtype=dtype))
            cin = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.PLAN)):
            x = getattr(self, f"conv{i + 1}")(x)
        return x


class ResnetEncoder(nn.Module):
    """ResNet-18 trunk conv1..layer4 -> 512ch @ 1/32 (reference: backbone.py:58-96)."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.feature_backbone = _ResNet18Trunk(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feature_backbone(x)


class SimpleDecoder(nn.Module):
    """conv(->256) relu conv(->n_classes), then x32 bilinear upsample with
    ``align_corners=False`` geometry (reference: backbone.py:143-164).

    ``logits`` stops before the upsample: the eval epilogue hands those
    pre-upsample logits to the fused upsample+argmax kernel, so the
    full-resolution logits are never built on the eval path.
    """

    has_pre_logits = True

    def __init__(self, in_ch: int, n_classes: int = 11, upsample: int = 32,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.upsample = upsample
        self.pred = nn.Sequential(
            Conv2d(in_ch, 256, 3, 1, 1, compute_dtype=dtype), nn.ReLU(inplace=True),
            Conv2d(256, n_classes, 3, 1, 1, compute_dtype=dtype))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.pred(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.logits(x)
        h, w = x.shape[-2:]
        return bilinear_resize(x, h * self.upsample, w * self.upsample)


class FCNDecoder(SimpleDecoder):
    """``FCN_decoder``: the reference registers it and cannot build it
    (undefined ``base_4``, backbone.py:179); the JAX package implements it
    working as SimpleDecoder's layers under its own class (backbone.py:120-140).
    The reference has no names for it: the port keeps SimpleDecoder's
    (``pred.0``, ``pred.2``), and ``convert`` maps JAX's ``FCNDecoder_0``."""


class NSegnetDecoder(nn.Module):
    """12 layers ``deconv1..deconv12``, five x2 DeconvBNRelu upsamples among
    conv-BN-ReLUs, the last to ``n_classes`` (with BatchNorm and ReLU, as
    the reference's) -> full-resolution logits (reference: backbone.py:99-140).
    No pre-upsample logits: the eval takes the argmax of the forward's."""

    has_pre_logits = False
    # (transposed?, features); the last layer's features are n_classes
    PLAN = ((True, 512), (False, 512), (False, 512), (True, 512), (False, 512), (False, 256),
            (True, 256), (False, 128), (True, 128), (False, 64), (True, 64), (False, None))

    def __init__(self, in_ch: int, n_classes: int = 11, dtype: torch.dtype | None = None):
        super().__init__()
        for i, (transposed, feats) in enumerate(self.PLAN):
            feats = feats or n_classes
            block = (DeconvBNRelu(in_ch, feats, dtype) if transposed
                     else ConvBNRelu(in_ch, feats, 3, 1, dtype=dtype))
            setattr(self, f"deconv{i + 1}", block)
            in_ch = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.PLAN)):
            x = getattr(self, f"deconv{i + 1}")(x)
        return x


ENCODERS = {"n_segnet_encoder": NSegnetEncoder, "resnet_encoder": ResnetEncoder}
DECODERS = {"n_segnet_decoder": NSegnetDecoder, "simple_decoder": SimpleDecoder,
            "FCN_decoder": FCNDecoder}


def get_encoder(name: str):
    """Encoder registry (reference: agent.py:16-23)."""
    try:
        return ENCODERS[name]
    except KeyError:
        raise KeyError(f"Encoder {name} not available") from None


def get_decoder(name: str):
    """Decoder registry (reference: agent.py:26-35)."""
    try:
        return DECODERS[name]
    except KeyError:
        raise KeyError(f"Decoder {name} not available") from None
