"""Shared model sub-modules, NCHW (port of multiagentperception_tpu/models/modules.py;
reference: ptsemseg/models/agent.py:39-189). ``dtype`` is the compute dtype
of every convolution and linear layer below (``models.blocks``)."""

from __future__ import annotations

import functools

import torch
from torch import nn

from multiagentperception_tpu_torch.models.backbone import ResnetEncoder, SimpleDecoder
from multiagentperception_tpu_torch.models.blocks import MLP, ConvBNRelu


class ImgEncoder(nn.Module):
    """ResNet-18 backbone + squeezer conv -> feat_channel map @ 1/32
    (reference: agent.py:39-60; ``feat_squeezer`` -1 only)."""

    def __init__(self, feat_channel: int = 512, dtype: torch.dtype | None = None):
        super().__init__()
        self.feature_backbone = ResnetEncoder(dtype)
        self.squeezer = ConvBNRelu(512, feat_channel, 3, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.squeezer(self.feature_backbone(x))


class ImgDecoder(nn.Module):
    """Decoder backbone -> per-class logits (reference: agent.py:63-89;
    ``simple_decoder``, no de-squeeze)."""

    def __init__(self, in_ch: int, n_classes: int = 11, dtype: torch.dtype | None = None):
        super().__init__()
        self.output_decoder = SimpleDecoder(in_ch, n_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, full_res: bool = True) -> torch.Tensor:
        """Full-resolution logits, or the pre-upsample ones with ``full_res=False``."""
        return self.output_decoder(x) if full_res else self.output_decoder.logits(x)


class PolicyNet4(nn.Module):
    """Separate image encoder + 5 convs (two stride-2) -> 256ch @ 1/128
    (reference: agent.py:114-142)."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.img_encoder = ImgEncoder(512, dtype)
        plan = [(512, 512, 1), (512, 256, 1), (256, 256, 2), (256, 256, 1),
                (256, 256, 2)]
        for i, (cin, cout, stride) in enumerate(plan):
            setattr(self, f"conv{i + 1}", ConvBNRelu(cin, cout, 3, stride, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.img_encoder(x)
        for i in range(1, 6):
            x = getattr(self, f"conv{i}")(x)
        return x


@functools.lru_cache(maxsize=None)
def policy_map_shape(img_size: tuple[int, int]) -> tuple[int, int, int]:
    """(C, h, w) of PolicyNet4's map for an ``img_size`` input: one forward
    on the ``meta`` device, so the tower's own shape arithmetic decides
    (seven stride-2 stages rounding up: 256 x 2 x 3 at 192 x 320). The JAX
    KMGenerator infers its input width the same way (modules.py:83-92)."""
    with torch.device("meta"):
        out = PolicyNet4().eval()(torch.empty(1, 3, *img_size))
    return tuple(out.shape[1:])


class KMGenerator(MLP):
    """MLP head producing key/query vectors from the flattened policy map
    (reference: agent.py:145-159)."""

    def __init__(self, in_features: int, out_size: int = 128,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, (256, 128, out_size), dtype)
