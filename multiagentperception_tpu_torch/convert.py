"""flax variables -> the port's state_dict (MIMOcom, resnet_encoder,
simple_decoder).

The port's own copy of that branch of
``multiagentperception_tpu/compat/torch_export.py:163-235``. The port's
modules carry the reference's ptsemseg names, so the result is also a
reference state_dict, and a reference ``.pkl`` (``{'model_state': ...}``,
as ``compat.save_reference_checkpoint`` writes it) loads into the port
directly.

Transforms: conv kernel ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``;
dense ``(in, out)`` -> ``(out, in)``; the first Dense after the flatten also
permutes its inputs HWC -> CHW; BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var (+ ``num_batches_tracked``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch


class _Out:
    def __init__(self):
        self.sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(self, key: str, value) -> None:
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(value)).copy())


def _conv(out: _Out, tp: str, p) -> None:
    out.put(f"{tp}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out.put(f"{tp}.bias", p["bias"])


def _bn(out: _Out, tp: str, p, s) -> None:
    out.put(f"{tp}.weight", p["scale"])
    out.put(f"{tp}.bias", p["bias"])
    out.put(f"{tp}.running_mean", s["mean"])
    out.put(f"{tp}.running_var", s["var"])
    out.put(f"{tp}.num_batches_tracked", np.zeros((), np.int64))


def _dense(out: _Out, tp: str, p) -> None:
    out.put(f"{tp}.weight", np.asarray(p["kernel"]).T)
    out.put(f"{tp}.bias", p["bias"])


def _dense_chw(out: _Out, tp: str, p, c: int, h: int, w: int) -> None:
    k = np.asarray(p["kernel"])  # (h*w*c, out), inputs in HWC order
    o = k.shape[1]
    out.put(f"{tp}.weight",
            k.reshape(h, w, c, o).transpose(3, 2, 0, 1).reshape(o, c * h * w))
    out.put(f"{tp}.bias", p["bias"])


def _cbr(out: _Out, tp: str, p, s) -> None:
    _conv(out, f"{tp}.cbr_unit.0", p["Conv_0"])
    _bn(out, f"{tp}.cbr_unit.1", p["BatchNorm_0"], s["BatchNorm_0"])


def _basic_block(out: _Out, tp: str, p, s) -> None:
    _conv(out, f"{tp}.conv1", p["Conv_0"])
    _bn(out, f"{tp}.bn1", p["BatchNorm_0"], s["BatchNorm_0"])
    _conv(out, f"{tp}.conv2", p["Conv_1"])
    _bn(out, f"{tp}.bn2", p["BatchNorm_1"], s["BatchNorm_1"])
    if "Conv_2" in p:
        _conv(out, f"{tp}.downsample.0", p["Conv_2"])
        _bn(out, f"{tp}.downsample.1", p["BatchNorm_2"], s["BatchNorm_2"])


def _img_encoder(out: _Out, tp: str, p, s) -> None:
    rp, rs = p["ResnetEncoder_0"], s["ResnetEncoder_0"]
    trunk = f"{tp}.feature_backbone.feature_backbone"
    _conv(out, f"{trunk}.conv1", rp["Conv_0"])
    _bn(out, f"{trunk}.bn1", rp["BatchNorm_0"], rs["BatchNorm_0"])
    for layer in range(1, 5):
        for blk in range(2):
            name = f"BasicBlock_{(layer - 1) * 2 + blk}"
            _basic_block(out, f"{trunk}.layer{layer}.{blk}", rp[name], rs[name])
    _cbr(out, f"{tp}.squeezer", p["ConvBNRelu_0"], s["ConvBNRelu_0"])


def _km(out: _Out, tp: str, p, hw: tuple[int, int]) -> None:
    mlp = p["MLP_0"]
    _dense_chw(out, f"{tp}.fc.0", mlp["Dense_0"], 256, *hw)
    _dense(out, f"{tp}.fc.2", mlp["Dense_1"])
    _dense(out, f"{tp}.fc.4", mlp["Dense_2"])


def state_dict_from_flax(cfg: Mapping[str, Any],
                         variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``{'params', 'batch_stats'}`` (nested dicts of arrays) of a JAX
    MIMOcom -> the port's MIMOcom state_dict (loads with ``strict=True``)."""
    m = cfg["model"]
    if (m["arch"], m["enc_backbone"], m["dec_backbone"]) != (
            "MIMOcom", "resnet_encoder", "simple_decoder") or not m["query"] \
            or (m.get("feat_squeezer") or -1) != -1:
        raise NotImplementedError("the weight bridge covers the flagship MIMOcom "
                                  "(resnet_encoder, simple_decoder, query, no squeezer)")
    hw = (cfg["data"]["img_rows"] // 128, cfg["data"]["img_cols"] // 128)
    P, S = variables["params"], variables["batch_stats"]
    out = _Out()
    _img_encoder(out, "u_encoder", P["u_encoder"], S["u_encoder"])
    qk_p, qk_s = P["query_key_net"], S["query_key_net"]
    _img_encoder(out, "query_key_net.img_encoder", qk_p["ImgEncoder_0"], qk_s["ImgEncoder_0"])
    for i in range(5):
        _cbr(out, f"query_key_net.conv{i + 1}", qk_p[f"ConvBNRelu_{i}"], qk_s[f"ConvBNRelu_{i}"])
    _km(out, "key_net", P["key_net"], hw)
    _km(out, "query_net", P["query_net"], hw)
    _dense(out, "attention_net.linear", P["MIMOGeneralDotAttention_0"]["proj"])
    dec = P["ImgDecoder_0"]["SimpleDecoder_0"]
    _conv(out, "decoder.output_decoder.pred.0", dec["Conv_0"])
    _conv(out, "decoder.output_decoder.pred.2", dec["Conv_1"])
    return out.sd
