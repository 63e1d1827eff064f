"""NN primitive blocks, NCHW (port of multiagentperception_tpu/models/blocks.py).

Submodule names follow the reference's ptsemseg modules (``cbr_unit.{0,1}``,
``conv1/bn1/conv2/bn2/downsample``, ``fc.{0,2,4}``), so a reference
state_dict loads with ``strict=True``. ``nn.BatchNorm2d`` is the JAX
``TorchBatchNorm`` (blocks.py:30-77) in both modes: in eval mode it
normalizes with ``running_mean``/``running_var`` and eps 1e-5; in training
mode with the batch's mean and biased variance, and it moves the running
statistics by momentum 0.1 towards the batch mean and the unbiased
variance ``n/(n-1)``, as torch does.
"""

from __future__ import annotations

import torch
from torch import nn


class ConvBNRelu(nn.Module):
    """Conv (with bias) -> BatchNorm -> ReLU (reference: models/utils.py:87-120).

    Symmetric padding (k-1)//2 at every stride, as the reference's torch
    convs pad (the JAX package pads the same explicitly; flax SAME would pad
    (0, 1) at stride 2).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        p = (kernel_size - 1) // 2
        layers = [nn.Conv2d(in_ch, out_ch, kernel_size, stride, p, bias=True),
                  nn.BatchNorm2d(out_ch)]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        self.cbr_unit = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbr_unit(x)


class MLP(nn.Module):
    """Flatten -> Linear stack with interior ReLUs (reference: agent.py:145-178).

    Flattens NCHW in CHW order; the JAX MLP flattens NHWC in HWC order, and
    ``convert.state_dict_from_flax`` permutes the first layer's inputs.
    """

    def __init__(self, in_features: int, features: tuple[int, ...]):
        super().__init__()
        layers: list[nn.Module] = []
        for i, f in enumerate(features):
            layers.append(nn.Linear(in_features, f))
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

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, 0, bias=False),
                nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)
