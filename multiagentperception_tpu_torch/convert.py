"""flax variables -> the port's state_dict, for every architecture with the
resnet_encoder / simple_decoder backbones.

The port's own copy of ``multiagentperception_tpu/compat/torch_export.py:163-237``. The port's
modules carry the reference's ptsemseg names, so the result is also a
reference state_dict, and a reference ``.pkl`` (``{'model_state': ...}``,
as ``compat.save_reference_checkpoint`` writes it) loads into the port
directly.

Transforms: conv kernel ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``;
dense ``(in, out)`` -> ``(out, in)``; the first Dense after the flatten also
permutes its inputs HWC -> CHW, over the policy map's own size
(``models.modules.policy_map_shape``, so image sides need not be multiples
of 128); BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var (+ ``num_batches_tracked``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

from multiagentperception_tpu_torch.models.modules import policy_map_shape


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


def _km(out: _Out, tp: str, p, chw: tuple[int, int, int]) -> None:
    mlp = p["MLP_0"]
    _dense_chw(out, f"{tp}.fc.0", mlp["Dense_0"], *chw)
    _dense(out, f"{tp}.fc.2", mlp["Dense_1"])
    _dense(out, f"{tp}.fc.4", mlp["Dense_2"])


def _policy_net(out: _Out, tp: str, p, s) -> None:
    _img_encoder(out, f"{tp}.img_encoder", p["ImgEncoder_0"], s["ImgEncoder_0"])
    for i in range(5):
        _cbr(out, f"{tp}.conv{i + 1}", p[f"ConvBNRelu_{i}"], s[f"ConvBNRelu_{i}"])


def _decoder(out: _Out, P) -> None:
    dec = P["ImgDecoder_0"]["SimpleDecoder_0"]
    _conv(out, "decoder.output_decoder.pred.0", dec["Conv_0"])
    _conv(out, "decoder.output_decoder.pred.2", dec["Conv_1"])


def state_dict_from_flax(cfg: Mapping[str, Any],
                         variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``{'params', 'batch_stats'}`` (nested dicts of arrays) of any of
    the seven JAX models (``resnet_encoder``, ``simple_decoder``, no
    squeezer) -> the port's state_dict of that model (loads with
    ``strict=True``). Flax names -> torch names: ``ImgEncoder_0`` ->
    ``encoder``, ``degraded_encoder`` -> ``degarded_encoder`` (the
    reference's spelling), ``PolicyNet4_0`` -> ``query_key_net``,
    ``GeneralDotAttention_0.Dense_0`` / ``MIMOGeneralDotAttention_0.proj`` /
    ``MIMOWhoGeneralDotAttention_0.Dense_0`` -> ``attention_net.linear``,
    ``AdditiveAttention_0.Dense_0..2`` -> ``attention_net.linear_feat`` /
    ``linear_context`` / ``linear_out``; the scaled attention has no weights."""
    m = cfg["model"]
    arch = m["arch"]
    if (m["enc_backbone"], m["dec_backbone"]) != ("resnet_encoder", "simple_decoder") \
            or (m.get("feat_squeezer") or -1) != -1:
        raise NotImplementedError("the weight bridge covers resnet_encoder, simple_decoder "
                                  "and no squeezer")
    chw = policy_map_shape((cfg["data"]["img_rows"], cfg["data"]["img_cols"]))
    P, S = variables["params"], variables["batch_stats"]
    out = _Out()

    def enc(flax_name: str, torch_name: str | None = None) -> None:
        _img_encoder(out, torch_name or flax_name, P[flax_name], S[flax_name])

    if arch in ("Single_agent", "MIMO_All_agents"):
        enc("ImgEncoder_0", "encoder")
    elif arch == "All_agents":
        for i in range(m["agent_num"]):
            enc(f"encoder{i + 1}")
    elif arch in ("LearnWho2Com", "LearnWhen2Com"):
        shared = m["shared_img_encoder"]
        if shared == "unified":
            enc("u_encoder")
        elif shared == "only_normal_agents":
            enc("degraded_encoder", "degarded_encoder")
            enc("normal_encoder")
        else:
            for i in range(m["agent_num"]):
                enc(f"encoder{i + 1}")
        _policy_net(out, "query_key_net", P["PolicyNet4_0"], S["PolicyNet4_0"])
    elif arch in ("MIMOcom", "MIMOcomWho"):
        enc("u_encoder")
        _policy_net(out, "query_key_net", P["query_key_net"], S["query_key_net"])
    else:
        raise KeyError(f"Model {arch} not available")

    if "key_net" in P:
        _km(out, "key_net", P["key_net"], chw)
        if m["query"]:
            _km(out, "query_net", P["query_net"], chw)
    if arch == "MIMOcom":
        _dense(out, "attention_net.linear", P["MIMOGeneralDotAttention_0"]["proj"])
    elif arch == "MIMOcomWho":
        _dense(out, "attention_net.linear", P["MIMOWhoGeneralDotAttention_0"]["Dense_0"])
    elif arch in ("LearnWho2Com", "LearnWhen2Com"):
        if m["attention"] == "general":
            _dense(out, "attention_net.linear", P["GeneralDotAttention_0"]["Dense_0"])
        elif m["attention"] == "additive":
            a = P["AdditiveAttention_0"]
            for i, name in enumerate(("linear_feat", "linear_context", "linear_out")):
                _dense(out, f"attention_net.{name}", a[f"Dense_{i}"])
    _decoder(out, P)
    return out.sd
