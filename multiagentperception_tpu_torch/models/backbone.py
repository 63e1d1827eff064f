"""Encoder/decoder backbones, NCHW (port of multiagentperception_tpu/models/backbone.py).

Only the pair every shipped config uses is ported: ``resnet_encoder``
(random-init ResNet-18 trunk, reference backbone.py:58-96) and
``simple_decoder`` (backbone.py:143-164). ``dtype`` is the compute dtype of
the convolutions (``models.blocks``); the decoder's x32 resize runs in its
input's dtype, as the JAX ``bilinear_resize`` does (ops/resize.py:53-57).
"""

from __future__ import annotations

import torch
from torch import nn

from multiagentperception_tpu_torch.models.blocks import BasicBlock, Conv2d
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
