"""flax variables -> the port's state_dict, for every model the JAX
package's ``get_model`` builds: the seven architectures over every
backbone (``resnet_encoder``, ``n_segnet_encoder``; ``simple_decoder``,
``FCN_decoder``, ``n_segnet_decoder``) and ``feat_squeezer``.

The port's own copy of ``multiagentperception_tpu/compat/torch_export.py:45-50,
105-160, 163-237``. The port's
modules carry the reference's ptsemseg names, so the result is also a
reference state_dict, and a reference ``.pkl`` (``{'model_state': ...}``,
as ``compat.save_reference_checkpoint`` writes it) loads into the port
directly.

Transforms: conv kernel ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``;
transposed-conv kernel ``(kh, kw, in, out)``, which flax applies unflipped,
-> flipped ``[::-1, ::-1]`` and ``(in, out, kh, kw)``, torch's layout of
the reference's ``ConvTranspose2d``; dense ``(in, out)`` -> ``(out, in)``;
the first Dense after the flatten also permutes its inputs HWC -> CHW, over
the policy map's own size (``models.modules.policy_map_shape``, so image
sides need not be multiples of 128); BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var (+ ``num_batches_tracked``).

``scales_from_flax`` carries the JAX package's int8 activation scales
across the same way: one walk over the model's layers (``_walk``) meets
each conv with its flax path and its port name.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

from multiagentperception_tpu_torch.models.backbone import NSegnetDecoder, NSegnetEncoder
from multiagentperception_tpu_torch.models.modules import policy_map_shape


class _Out:
    """Collects the state_dict as the walk over the flax tree meets each layer."""

    def __init__(self):
        self.sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(self, key: str, value) -> None:
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(value)).copy())

    def conv(self, tp: str, p) -> None:
        self.put(f"{tp}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self.put(f"{tp}.bias", p["bias"])

    def deconv(self, tp: str, p) -> None:
        self.put(f"{tp}.weight", np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        self.put(f"{tp}.bias", p["bias"])

    def bn(self, tp: str, p, s) -> None:
        self.put(f"{tp}.weight", p["scale"])
        self.put(f"{tp}.bias", p["bias"])
        self.put(f"{tp}.running_mean", s["mean"])
        self.put(f"{tp}.running_var", s["var"])
        self.put(f"{tp}.num_batches_tracked", np.zeros((), np.int64))

    def dense(self, tp: str, p) -> None:
        self.put(f"{tp}.weight", np.asarray(p["kernel"]).T)
        self.put(f"{tp}.bias", p["bias"])

    def dense_chw(self, tp: str, p, c: int, h: int, w: int) -> None:
        k = np.asarray(p["kernel"])  # (h*w*c, out), inputs in HWC order
        o = k.shape[1]
        self.put(f"{tp}.weight",
                 k.reshape(h, w, c, o).transpose(3, 2, 0, 1).reshape(o, c * h * w))
        self.put(f"{tp}.bias", p["bias"])


class _ConvNames(_Out):
    """The same walk, recording each conv's flax path -> port module name;
    the tree is a ``_Paths`` (no arrays), so nothing else is read."""

    def __init__(self):
        super().__init__()
        self.names: dict[tuple, str] = {}

    def conv(self, tp: str, p) -> None:
        self.names[p.path] = tp

    def deconv(self, tp: str, p) -> None:
        pass  # JAX's int8 swaps nn.Conv alone: no transposed conv has a scale

    def bn(self, tp: str, p, s) -> None:
        pass

    def dense(self, tp: str, p) -> None:
        pass

    def dense_chw(self, tp: str, p, c: int, h: int, w: int) -> None:
        pass


class _Paths:
    """A stand-in for a flax tree that knows only the module paths in
    ``keys``: indexing extends the path; ``name in node`` says whether any
    key lies below ``path + (name,)``."""

    def __init__(self, keys, path: tuple = ()):
        self.keys, self.path = keys, path

    def __getitem__(self, name: str) -> "_Paths":
        return _Paths(self.keys, self.path + (name,))

    def __contains__(self, name: str) -> bool:
        sub = self.path + (name,)
        return any(k[:len(sub)] == sub for k in self.keys)


def _cbr(out: _Out, tp: str, p, s) -> None:
    out.conv(f"{tp}.cbr_unit.0", p["Conv_0"])
    out.bn(f"{tp}.cbr_unit.1", p["BatchNorm_0"], s["BatchNorm_0"])


def _dcbr(out: _Out, tp: str, p, s) -> None:
    out.deconv(f"{tp}.dcbr_unit.0", p["ConvTranspose_0"])
    out.bn(f"{tp}.dcbr_unit.1", p["BatchNorm_0"], s["BatchNorm_0"])


def _basic_block(out: _Out, tp: str, p, s) -> None:
    out.conv(f"{tp}.conv1", p["Conv_0"])
    out.bn(f"{tp}.bn1", p["BatchNorm_0"], s["BatchNorm_0"])
    out.conv(f"{tp}.conv2", p["Conv_1"])
    out.bn(f"{tp}.bn2", p["BatchNorm_1"], s["BatchNorm_1"])
    if "Conv_2" in p:
        out.conv(f"{tp}.downsample.0", p["Conv_2"])
        out.bn(f"{tp}.downsample.1", p["BatchNorm_2"], s["BatchNorm_2"])


def _img_encoder(out: _Out, tp: str, p, s, enc: str) -> None:
    if enc == "resnet_encoder":
        rp, rs = p["ResnetEncoder_0"], s["ResnetEncoder_0"]
        trunk = f"{tp}.feature_backbone.feature_backbone"
        out.conv(f"{trunk}.conv1", rp["Conv_0"])
        out.bn(f"{trunk}.bn1", rp["BatchNorm_0"], rs["BatchNorm_0"])
        for layer in range(1, 5):
            for blk in range(2):
                name = f"BasicBlock_{(layer - 1) * 2 + blk}"
                _basic_block(out, f"{trunk}.layer{layer}.{blk}", rp[name], rs[name])
    elif enc == "n_segnet_encoder":
        sp, ss = p["NSegnetEncoder_0"], s["NSegnetEncoder_0"]
        for i in range(len(NSegnetEncoder.PLAN)):
            _cbr(out, f"{tp}.feature_backbone.conv{i + 1}", sp[f"ConvBNRelu_{i}"],
                 ss[f"ConvBNRelu_{i}"])
    else:
        raise KeyError(f"Encoder {enc} not available")
    _cbr(out, f"{tp}.squeezer", p["ConvBNRelu_0"], s["ConvBNRelu_0"])


def _km(out: _Out, tp: str, p, chw: tuple[int, int, int]) -> None:
    mlp = p["MLP_0"]
    out.dense_chw(f"{tp}.fc.0", mlp["Dense_0"], *chw)
    out.dense(f"{tp}.fc.2", mlp["Dense_1"])
    out.dense(f"{tp}.fc.4", mlp["Dense_2"])


def _policy_net(out: _Out, tp: str, p, s, enc: str) -> None:
    _img_encoder(out, f"{tp}.img_encoder", p["ImgEncoder_0"], s["ImgEncoder_0"], enc)
    for i in range(5):
        _cbr(out, f"{tp}.conv{i + 1}", p[f"ConvBNRelu_{i}"], s[f"ConvBNRelu_{i}"])


def _decoder(out: _Out, P, S, dec: str, squeezer: int) -> None:
    # a decoder of plain convs has no batch_stats
    p, s = P["ImgDecoder_0"], S["ImgDecoder_0"] if "ImgDecoder_0" in S else {}
    if squeezer == 2:
        _dcbr(out, "decoder.desqueezer", p["DeconvBNRelu_0"], s["DeconvBNRelu_0"])
    elif squeezer == 4:
        _dcbr(out, "decoder.desqueezer1", p["DeconvBNRelu_0"], s["DeconvBNRelu_0"])
        _dcbr(out, "decoder.desqueezer2", p["DeconvBNRelu_1"], s["DeconvBNRelu_1"])
    od = "decoder.output_decoder"
    if dec in ("simple_decoder", "FCN_decoder"):
        head = p["SimpleDecoder_0" if dec == "simple_decoder" else "FCNDecoder_0"]
        out.conv(f"{od}.pred.0", head["Conv_0"])
        out.conv(f"{od}.pred.2", head["Conv_1"])
    elif dec == "n_segnet_decoder":
        dp, ds = p["NSegnetDecoder_0"], s["NSegnetDecoder_0"]
        counts = {True: 0, False: 0}  # flax numbers each block type apart
        for i, (transposed, _) in enumerate(NSegnetDecoder.PLAN):
            name = f"{'DeconvBNRelu' if transposed else 'ConvBNRelu'}_{counts[transposed]}"
            counts[transposed] += 1
            (_dcbr if transposed else _cbr)(out, f"{od}.deconv{i + 1}", dp[name], ds[name])
    else:
        raise KeyError(f"Decoder {dec} not available")


def state_dict_from_flax(cfg: Mapping[str, Any],
                         variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``{'params', 'batch_stats'}`` (nested dicts of arrays) of any
    model the JAX ``get_model`` builds -> the port's state_dict of that
    model (loads with ``strict=True``). Flax names -> torch names:
    ``ResnetEncoder_0`` / ``NSegnetEncoder_0.ConvBNRelu_i`` ->
    ``feature_backbone.feature_backbone.*`` / ``feature_backbone.conv{i+1}``,
    the ImgEncoder's ``ConvBNRelu_0`` -> ``squeezer``, the ImgDecoder's
    ``DeconvBNRelu_0`` (/ ``_1``) -> ``desqueezer`` (/ ``desqueezer1``,
    ``desqueezer2``), ``SimpleDecoder_0`` / ``FCNDecoder_0`` ->
    ``output_decoder.pred``, ``NSegnetDecoder_0``'s interleaved
    ``DeconvBNRelu_j`` / ``ConvBNRelu_i`` -> ``output_decoder.deconv1..12``,
    ``ImgEncoder_0`` ->
    ``encoder``, ``degraded_encoder`` -> ``degarded_encoder`` (the
    reference's spelling), ``PolicyNet4_0`` -> ``query_key_net``,
    ``GeneralDotAttention_0.Dense_0`` / ``MIMOGeneralDotAttention_0.proj`` /
    ``MIMOWhoGeneralDotAttention_0.Dense_0`` -> ``attention_net.linear``,
    ``AdditiveAttention_0.Dense_0..2`` -> ``attention_net.linear_feat`` /
    ``linear_context`` / ``linear_out``; the scaled attention has no weights."""
    return _walk(cfg, variables["params"], variables["batch_stats"], _Out()).sd


def scales_from_flax(cfg: Mapping[str, Any], scales: Mapping[tuple, float]) -> dict[str, float]:
    """JAX's int8 activation scales ``{flax module path tuple: scale}``
    (``quantize.calibrate_activations``) -> the port's ``{conv module
    name: scale}`` (``quantize.Int8Convs``), by the weight bridge's own
    names: the path of a conv's params is its module path. Raises
    ``KeyError`` for a path that names no conv of the model."""
    keys = [tuple(k) for k in scales]
    names = _walk(cfg, _Paths(keys), _Paths(keys), _ConvNames()).names
    missing = [k for k in keys if k not in names]
    if missing:
        raise KeyError(f"scales_from_flax: no conv of {cfg['model']['arch']} at {missing}")
    return {names[tuple(k)]: float(v) for k, v in scales.items()}


def _walk(cfg: Mapping[str, Any], P, S, out: _Out) -> _Out:
    """Meet every layer of the model of ``cfg`` in the flax trees ``P``
    (params) and ``S`` (batch_stats), handing each to ``out``."""
    m = cfg["model"]
    arch = m["arch"]
    encoder = m.get("enc_backbone") or "resnet_encoder"
    chw = policy_map_shape((cfg["data"]["img_rows"], cfg["data"]["img_cols"]), encoder)

    def enc(flax_name: str, torch_name: str | None = None) -> None:
        _img_encoder(out, torch_name or flax_name, P[flax_name], S[flax_name], encoder)

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
        _policy_net(out, "query_key_net", P["PolicyNet4_0"], S["PolicyNet4_0"], encoder)
    elif arch in ("MIMOcom", "MIMOcomWho"):
        enc("u_encoder")
        _policy_net(out, "query_key_net", P["query_key_net"], S["query_key_net"], encoder)
    else:
        raise KeyError(f"Model {arch} not available")

    if "key_net" in P:
        _km(out, "key_net", P["key_net"], chw)
        if m["query"]:
            _km(out, "query_net", P["query_net"], chw)
    if arch == "MIMOcom":
        out.dense("attention_net.linear", P["MIMOGeneralDotAttention_0"]["proj"])
    elif arch == "MIMOcomWho":
        out.dense("attention_net.linear", P["MIMOWhoGeneralDotAttention_0"]["Dense_0"])
    elif arch in ("LearnWho2Com", "LearnWhen2Com"):
        if m["attention"] == "general":
            out.dense("attention_net.linear", P["GeneralDotAttention_0"]["Dense_0"])
        elif m["attention"] == "additive":
            a = P["AdditiveAttention_0"]
            for i, name in enumerate(("linear_feat", "linear_context", "linear_out")):
                out.dense(f"attention_net.{name}", a[f"Dense_{i}"])
    _decoder(out, P, S, m.get("dec_backbone") or "simple_decoder",
             int(m.get("feat_squeezer") or -1))
    return out
