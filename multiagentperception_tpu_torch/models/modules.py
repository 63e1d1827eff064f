"""Shared model sub-modules, NCHW (port of multiagentperception_tpu/models/modules.py;
reference: ptsemseg/models/agent.py:39-189). ``dtype`` is the compute dtype
of every convolution and linear layer below (``models.blocks``);
``enc_backbone`` / ``dec_backbone`` name the backbones (``models.backbone``)."""

from __future__ import annotations

import functools

import torch
from torch import nn

from multiagentperception_tpu_torch.models.backbone import get_decoder, get_encoder
from multiagentperception_tpu_torch.models.blocks import MLP, ConvBNRelu, DeconvBNRelu


class ImgEncoder(nn.Module):
    """Backbone + squeezer conv -> feat_channel map @ 1/32, or 1/64 and
    1/128 with ``feat_squeezer`` 2 and 4, the squeezer's stride (reference:
    agent.py:39-60; any other value keeps stride 1, as in JAX)."""

    def __init__(self, feat_channel: int = 512, dtype: torch.dtype | None = None,
                 enc_backbone: str = "resnet_encoder", feat_squeezer: int = -1):
        super().__init__()
        self.feature_backbone = get_encoder(enc_backbone)(dtype)
        stride = feat_squeezer if feat_squeezer in (2, 4) else 1
        self.squeezer = ConvBNRelu(512, feat_channel, 3, stride, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.squeezer(self.feature_backbone(x))


class ImgDecoder(nn.Module):
    """Optional de-squeeze deconvs + decoder backbone -> per-class logits
    (reference: agent.py:63-89): ``desqueezer`` (one x2 DeconvBNRelu keeping
    ``in_ch``) at ``feat_squeezer`` 2, ``desqueezer1`` / ``desqueezer2``
    (two to 512 channels) at 4. ``has_pre_logits``: whether the decoder
    backbone stops before an upsample with ``full_res=False``."""

    def __init__(self, in_ch: int, n_classes: int = 11, dtype: torch.dtype | None = None,
                 dec_backbone: str = "simple_decoder", feat_squeezer: int = -1):
        super().__init__()
        self.feat_squeezer = feat_squeezer
        if feat_squeezer == 2:
            self.desqueezer = DeconvBNRelu(in_ch, in_ch, dtype)
        elif feat_squeezer == 4:
            self.desqueezer1 = DeconvBNRelu(in_ch, 512, dtype)
            self.desqueezer2 = DeconvBNRelu(512, 512, dtype)
            in_ch = 512
        self.output_decoder = get_decoder(dec_backbone)(in_ch, n_classes, dtype=dtype)
        self.has_pre_logits = self.output_decoder.has_pre_logits

    def forward(self, x: torch.Tensor, full_res: bool = True) -> torch.Tensor:
        """Full-resolution logits, or with ``full_res=False`` the pre-upsample
        ones where the decoder has them (else full-resolution all the same)."""
        if self.feat_squeezer == 2:
            x = self.desqueezer(x)
        elif self.feat_squeezer == 4:
            x = self.desqueezer2(self.desqueezer1(x))
        if full_res or not self.has_pre_logits:
            return self.output_decoder(x)
        return self.output_decoder.logits(x)


class PolicyNet4(nn.Module):
    """Separate image encoder (``enc_backbone``, no squeezer stride) + 5
    convs (two stride-2) -> 256ch @ 1/128 (reference: agent.py:114-142)."""

    def __init__(self, dtype: torch.dtype | None = None, enc_backbone: str = "resnet_encoder"):
        super().__init__()
        self.img_encoder = ImgEncoder(512, dtype, enc_backbone)
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
def policy_map_shape(img_size: tuple[int, int],
                     enc_backbone: str = "resnet_encoder") -> tuple[int, int, int]:
    """(C, h, w) of PolicyNet4's map over ``enc_backbone`` for an
    ``img_size`` input: one forward on the ``meta`` device, so the tower's
    own shape arithmetic decides (seven stride-2 stages rounding up: 256 x
    2 x 3 at 192 x 320). The JAX KMGenerator infers its input width the
    same way (modules.py:83-92)."""
    with torch.device("meta"):
        out = PolicyNet4(enc_backbone=enc_backbone).eval()(torch.empty(1, 3, *img_size))
    return tuple(out.shape[1:])


class KMGenerator(MLP):
    """MLP head producing key/query vectors from the flattened policy map
    (reference: agent.py:145-159)."""

    def __init__(self, in_features: int, out_size: int = 128,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, (256, 128, out_size), dtype)
