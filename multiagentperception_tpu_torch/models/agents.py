"""The model zoo (port of multiagentperception_tpu/models/agents.py;
reference agent.py): SingleAgent, AllAgents, MIMOAllAgents, LearnWho2Com,
LearnWhen2Com, MIMOcom and MIMOcomWho.

Inputs keep the JAX package's layout ``(B, N, H, W, 3)`` (SingleAgent:
``(B', H, W, 3)``, the evaluator folds or picks the views); inside, the
towers run NCHW. Per-agent outputs stack batch-major: ``out[b*N + n]`` is
agent ``n`` of sample ``b``. Every forward takes ``full_res``: with
``full_res=False`` the prediction is the decoder's pre-upsample logits
``(., n_classes, H/32, W/32)``, which the evaluator hands to the
upsample+argmax kernel.

In training mode (``model.train()``) the comm models run their training
forward, the soft fusion (``inference='softmax'``; they refuse the pruned
modes there, where the JAX models would quietly run the soft fusion);
BatchNorm normalizes with the batch's statistics and updates its running
ones, unless the trainer put the BatchNorm modules in eval mode
(``training.freeze_bn_stats``). Every encoder sees exactly the frames it
sees in JAX, so the batch statistics agree: ``x[:, i]`` alone for
per-agent encoders, agent 0 alone and agents 1..N-1 together for
``only_normal_agents``, PolicyNet4 over all N agents.

The pruned eval modes decode once. The JAX models decode the soft fusion
first and XLA drops that unused decode; eager PyTorch would run it, so the
port does not (BatchNorm runs on running stats there, nothing else changes).
MIMOcom's ``argmax_test`` and ``activated`` on the full N x N graph run the
communication step through ``comm_fusion`` (the kernel on the card, its
plain version on the CPU), as the JAX model does under
``model.pallas_comm``; its plain pruned path computes the same outputs, so
the port takes the option and ignores it. Its ``topk`` mode and its
single-query graph (``multiple_output: false``) take the plain selections
(``topk_select``, ``argmax_select``, ``activated_select``), as the JAX
model's Pallas branch leaves them to XLA. MIMOcomWho's graph is
drop-diagonal with no bias, a different graph: its pruned modes use
``argmax_select`` / ``activated_select``.

Every architecture takes ``backbones`` (``Backbones``: ``model.enc_backbone``,
``model.dec_backbone``, ``model.feat_squeezer``), the SRMS ones ``sparse``
(sparsemax over keys), as the JAX models take those fields.

The ``selection`` baselines (``shuffle_features: selection``) take their
random partners as ``rand_ids``, drawn by the caller on the host (the
evaluator and trainer draw them from a seeded CPU generator), so a card
run and a CPU run with one seed pick the same partners.

Every architecture takes ``dtype``, the compute dtype (``None`` for
float32, ``torch.bfloat16`` for ``model.dtype: bfloat16`` /
``training.mixed_precision``), and hands it to every tower, head and
attention, as the JAX models do (agents.py:79, 105, 150, 205, 287, 382).
The parameters stay float32; the frames enter in float32 and the first
convolution casts them. In bf16 the predictions are bf16, the MIMO graphs
float32, and MIMOcom's pruned modes hand the comm step bf16 Q', K and V.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multiagentperception_tpu_torch.models.attention import (
    MIMOGeneralDotAttention,
    MIMOWhoGeneralDotAttention,
    get_srms_attention,
)
from multiagentperception_tpu_torch.models.modules import (
    ImgDecoder,
    ImgEncoder,
    KMGenerator,
    PolicyNet4,
    policy_map_shape,
)
from multiagentperception_tpu_torch.ops.comm import (
    activated_select,
    argmax_select,
    fuse_values,
    num_connect_offdiag,
    one_hot_argmax,
    topk_select,
)
from multiagentperception_tpu_torch.ops.kernels.comm_fusion import comm_fusion
from multiagentperception_tpu_torch.parallel.collectives import all_gather_cat
from multiagentperception_tpu_torch.parallel.ring import sharded_comm_step

INFERENCE_MODES = ("softmax", "argmax_test", "activated")
MIMOCOM_MODES = INFERENCE_MODES + ("topk",)  # topk: MIMOcom alone, as in JAX
DIAG_BIAS = 0.001  # prefer-own-frame bias (reference agent.py:1164-1167)
THRES = 0.2  # activated keeps links with weight > THRES (reference agent.py:800)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) frames -> (prod(...), 3, H, W)."""
    return x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2).contiguous()


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B*N, ...) -> (B, N, ...)."""
    return t.reshape((-1, n) + tuple(t.shape[1:]))


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) -> (B*N, ...)."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


def _check_mode(module: nn.Module, inference: str, modes=INFERENCE_MODES) -> None:
    if module.training and inference != "softmax":
        raise ValueError(f"inference mode {inference!r} in training: the training "
                         "forward is the soft fusion (inference='softmax')")
    if inference not in modes:
        raise ValueError(f"Incorrect inference mode {inference!r}: "
                         f"{type(module).__name__} takes {modes}")


@dataclass(frozen=True)
class Backbones:
    """The towers' backbones (``model.enc_backbone``, ``model.dec_backbone``)
    and ``model.feat_squeezer``, which every architecture hands to its
    encoders, policy tower and decoder, as the JAX models do."""

    enc_backbone: str = "resnet_encoder"
    dec_backbone: str = "simple_decoder"
    feat_squeezer: int = -1

    def encoder(self, feat_channel: int, dtype) -> ImgEncoder:
        return ImgEncoder(feat_channel, dtype, self.enc_backbone, self.feat_squeezer)

    def decoder(self, in_ch: int, n_classes: int, dtype) -> ImgDecoder:
        return ImgDecoder(in_ch, n_classes, dtype, self.dec_backbone, self.feat_squeezer)

    def policy(self, dtype) -> PolicyNet4:
        return PolicyNet4(dtype, self.enc_backbone)

    def policy_features(self, img_size) -> int:
        return math.prod(policy_map_shape(tuple(img_size), self.enc_backbone))


def _need_ids(rand_ids):
    if rand_ids is None:
        raise ValueError("shuffle_features 'selection' draws its partners on the host: "
                         "pass rand_ids (the evaluator and trainer do)")
    return rand_ids


class SingleAgent(nn.Module):
    """Encoder -> decoder, no communication (reference: agent.py:375-395)."""

    def __init__(self, n_classes: int = 11, feat_channel: int = 512,
                 dtype: torch.dtype | None = None, backbones: Backbones = Backbones()):
        super().__init__()
        self.encoder = backbones.encoder(feat_channel, dtype)
        self.decoder = backbones.decoder(feat_channel, n_classes, dtype)

    def forward(self, x: torch.Tensor, full_res: bool = True) -> torch.Tensor:
        return self.decoder(self.encoder(_nchw(x)), full_res)


class AllAgents(nn.Module):
    """SRMS fusion baselines: one encoder per agent; the decoder sees all N
    maps (``catall``), the first two (``fixed2``) or agent 0's and one
    supporter's drawn for the whole batch (``selection``, the randcom
    baseline; returns ``(pred, rand_action)``) (reference: agent.py:399-469)."""

    def __init__(self, n_classes: int = 11, feat_channel: int = 512,
                 shuffle_flag=None, agent_num: int = 5, dtype: torch.dtype | None = None,
                 backbones: Backbones = Backbones()):
        super().__init__()
        self.shuffle_flag = shuffle_flag
        self.agent_num = agent_num
        for i in range(agent_num):
            setattr(self, f"encoder{i + 1}", backbones.encoder(feat_channel, dtype))
        width = 2 if shuffle_flag in ("selection", "fixed2") else agent_num
        self.decoder = backbones.decoder(width * feat_channel, n_classes, dtype)

    def forward(self, x: torch.Tensor, full_res: bool = True,
                rand_ids: torch.Tensor | None = None):
        """``rand_ids``: the supporter, a 0-d integer tensor in [0, N)."""
        feats = [getattr(self, f"encoder{i + 1}")(_nchw(x[:, i]))
                 for i in range(x.shape[1])]
        if self.shuffle_flag == "selection":
            aux_id = _need_ids(rand_ids).reshape(1).to(x.device)
            aux = torch.index_select(torch.stack(feats), 0, aux_id)[0]
            pred = self.decoder(torch.cat([feats[0], aux], dim=1), full_res)
            return pred, aux_id.expand(x.shape[0])
        fused = torch.cat(feats[:2] if self.shuffle_flag == "fixed2" else feats, dim=1)
        return self.decoder(fused, full_res)


class MIMOAllAgents(nn.Module):
    """MRMS fusion baselines with one shared encoder: the rotation-ordered
    concat of all N (``catall``: agent i sees feat_i, feat_{i+1}, ...), one
    partner per agent drawn for the whole batch (``selection``; returns
    ``(pred, rand_action (B, N))``), or the mean of the others (``ComNet``)
    (reference: agent.py:892-980)."""

    def __init__(self, n_classes: int = 11, feat_channel: int = 512,
                 shuffle_flag=None, agent_num: int = 6, dtype: torch.dtype | None = None,
                 backbones: Backbones = Backbones()):
        super().__init__()
        self.shuffle_flag = shuffle_flag
        self.agent_num = agent_num
        self.encoder = backbones.encoder(feat_channel, dtype)
        width = 2 if shuffle_flag in ("selection", "ComNet") else agent_num
        self.decoder = backbones.decoder(width * feat_channel, n_classes, dtype)

    def forward(self, x: torch.Tensor, full_res: bool = True,
                rand_ids: torch.Tensor | None = None):
        """``rand_ids``: each agent's partner, an (N,) integer tensor in [0, N)."""
        b, n = x.shape[:2]
        feats = _unfold(self.encoder(_nchw(x)), n)  # (B, N, C, h, w)
        if self.shuffle_flag == "selection":
            ids = _need_ids(rand_ids).to(x.device)
            partner = torch.index_select(feats, 1, ids)
            pred = self.decoder(_fold(torch.cat([feats, partner], dim=2)), full_res)
            return pred, ids[None, :].expand(b, n)
        if self.shuffle_flag == "ComNet":
            others = (feats.sum(dim=1, keepdim=True) - feats) / (n - 1)
            return self.decoder(_fold(torch.cat([feats, others], dim=2)), full_res)
        ar = torch.arange(n, device=x.device)
        rot = (ar[:, None] + ar[None, :]) % n  # (N, N)
        gathered = feats[:, rot]  # (B, N, N, C, h, w): channel j*C + c
        return self.decoder(gathered.reshape((b * n, -1) + tuple(feats.shape[3:])), full_res)


class _SRMSComm(nn.Module):
    """What LearnWho2Com and LearnWhen2Com share: the value encoders of
    ``shared_img_encoder`` (``_encode``, port of agents.py:207-220), the
    policy tower and its key/query heads, the SRMS attention (sparsemax with
    ``sparse``), the decoder."""

    def __init__(self, n_classes, feat_channel, attention, has_query, agent_num,
                 shared_img_encoder, key_size, query_size, img_size, dec_width, dtype,
                 sparse, backbones):
        super().__init__()
        self.agent_num = agent_num
        self.has_query = has_query
        self.query_size = query_size
        self.shared_img_encoder = shared_img_encoder
        if shared_img_encoder == "unified":
            self.u_encoder = backbones.encoder(feat_channel, dtype)
        elif shared_img_encoder == "only_normal_agents":
            # the reference's spelling
            self.degarded_encoder = backbones.encoder(feat_channel, dtype)
            self.normal_encoder = backbones.encoder(feat_channel, dtype)
        else:
            for i in range(agent_num):
                setattr(self, f"encoder{i + 1}", backbones.encoder(feat_channel, dtype))
        policy_features = backbones.policy_features(img_size)
        self.query_key_net = backbones.policy(dtype)
        self.key_net = KMGenerator(policy_features, key_size, dtype)
        if has_query:
            self.query_net = KMGenerator(policy_features, query_size, dtype)
        self.attention_net = get_srms_attention(attention, query_size, key_size, dtype, sparse)
        self.decoder = backbones.decoder(dec_width * feat_channel, n_classes, dtype)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) -> value maps (B, N, C, h, w)."""
        n = x.shape[1]
        if self.shared_img_encoder == "unified":
            return _unfold(self.u_encoder(_nchw(x)), n)
        if self.shared_img_encoder == "only_normal_agents":
            own = self.degarded_encoder(_nchw(x[:, 0]))
            rest = _unfold(self.normal_encoder(_nchw(x[:, 1:])), n - 1)
            return torch.cat([own[:, None], rest], dim=1)
        return torch.stack([getattr(self, f"encoder{i + 1}")(_nchw(x[:, i]))
                            for i in range(n)], dim=1)

    def _policy(self, x: torch.Tensor):
        """(feats, policy maps (B, N, 256, h', w'), query (B, 1, query_size))."""
        b, n = x.shape[:2]
        feats = self._encode(x)
        qk = _unfold(self.query_key_net(_nchw(x)), n)
        if self.has_query:
            query = self.query_net(qk[:, 0])[:, None]
        else:
            query = torch.ones(b, 1, self.query_size, dtype=feats.dtype, device=x.device)
        return feats, qk, query


class LearnWho2Com(_SRMSComm):
    """SRMS who2com: agent 0 requests; keys come from the N-1 supporters
    only, the query from agent 0; the decoder sees concat(own, fused)
    (reference: agent.py:472-673). Returns ``(pred, prob (B, 1, N-1),
    action (B, 1))``; the action indexes the supporters (the evaluator adds
    1). Eval modes ``softmax`` and ``argmax_test`` (the default)."""

    MODES = ("softmax", "argmax_test")

    def __init__(self, n_classes: int = 11, feat_channel: int = 512,
                 attention: str = "general", has_query: bool = True, agent_num: int = 5,
                 shared_img_encoder: str = "unified", key_size: int = 1024,
                 query_size: int = 8, img_size: tuple[int, int] = (512, 512),
                 dtype: torch.dtype | None = None, sparse: bool = False,
                 backbones: Backbones = Backbones()):
        super().__init__(n_classes, feat_channel, attention, has_query, agent_num,
                         shared_img_encoder, key_size, query_size, img_size, dec_width=2,
                         dtype=dtype, sparse=sparse, backbones=backbones)

    def forward(self, x: torch.Tensor, inference: str = "softmax", full_res: bool = True):
        _check_mode(self, inference, self.MODES)
        n = x.shape[1]
        feats, qk, query = self._policy(x)
        keys = _unfold(self.key_net(_fold(qk[:, 1:])), n - 1)
        vals = feats[:, 1:]
        if inference == "softmax":
            fused, prob = self.attention_net(query, keys, vals)
        else:  # argmax_test: the hard top-1 supporter
            coef = self.attention_net.graph(query, keys)  # (B, N-1, 1)
            fused = fuse_values(one_hot_argmax(coef, dim=1), vals)[:, 0]
            prob = coef.transpose(1, 2)
        pred = self.decoder(torch.cat([feats[:, 0], fused], dim=1), full_res)
        return pred, prob, torch.argmax(prob, dim=2)


class LearnWhen2Com(_SRMSComm):
    """SRMS when2com: keys from all N agents including the requester
    (attending to itself means "do not communicate"), the query from agent
    0; the decoder sees only the fused map (reference: agent.py:676-889).
    Training returns ``(pred, prob (B, 1, N), action (B, 1))``; eval adds
    ``num_connect``: ``n - 1`` (softmax), the share of samples that chose a
    supporter (argmax_test), or the links to supporters per sample
    (activated, whose third output is the thresholded row, not an argmax)."""

    def __init__(self, n_classes: int = 11, feat_channel: int = 512,
                 attention: str = "general", has_query: bool = True, agent_num: int = 5,
                 shared_img_encoder: str = "unified", key_size: int = 1024,
                 query_size: int = 8, img_size: tuple[int, int] = (512, 512),
                 dtype: torch.dtype | None = None, sparse: bool = False,
                 backbones: Backbones = Backbones()):
        super().__init__(n_classes, feat_channel, attention, has_query, agent_num,
                         shared_img_encoder, key_size, query_size, img_size, dec_width=1,
                         dtype=dtype, sparse=sparse, backbones=backbones)

    def forward(self, x: torch.Tensor, inference: str = "softmax", full_res: bool = True):
        _check_mode(self, inference)
        b, n = x.shape[:2]
        feats, qk, query = self._policy(x)
        keys = _unfold(self.key_net(_fold(qk)), n)
        if inference == "softmax":
            fused, prob = self.attention_net(query, keys, feats)
            action = torch.argmax(prob, dim=2)
            pred = self.decoder(fused, full_res)
            if self.training:
                return pred, prob, action
            return pred, prob, action, torch.full((), float(n - 1), device=x.device)
        prob = self.attention_net.graph(query, keys).transpose(1, 2)  # (B, 1, N)
        if inference == "argmax_test":
            action = torch.argmax(prob, dim=2)
            coef = one_hot_argmax(prob.transpose(1, 2), dim=1)  # (B, N, 1)
            links = (action[:, 0] != 0).sum()
        else:  # activated
            action = torch.where(prob > THRES, prob, torch.zeros_like(prob))
            coef = action.transpose(1, 2)
            links = (action[:, :, 1:] != 0).sum()
        # the quotient in float64, rounded once: card and CPU agree (ops/comm.py)
        num_connect = (links.to(torch.float64) / b).to(torch.float32)
        pred = self.decoder(fuse_values(coef, feats)[:, 0], full_res)
        return pred, prob, action, num_connect


@contextlib.contextmanager
def _running_stats_kept(tower: nn.Module):
    """The recompute of a checkpointed tower: it runs the first forward's
    operations again (training-mode BatchNorm on the batch's statistics,
    updating its running ones), and on leaving, every BatchNorm buffer is
    put back as the first forward left it, so the momentum is applied once,
    as JAX's ``nn.remat`` applies the mutable update once."""
    saved = [(buf, buf.clone()) for m in tower.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)
             for buf in (m.running_mean, m.running_var, m.num_batches_tracked)
             if buf is not None]
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, value in saved:
                buf.copy_(value)


class _MIMOComm(nn.Module):
    """What MIMOcom and MIMOcomWho share: the value tower ``u_encoder`` and
    the policy tower over all N agents, keys and queries per agent (a query
    of ones without ``query_net``), the MIMO attention, the decoder.
    ``remat`` (MIMOcom's ``model.remat``) recomputes the two towers in the
    backward instead of keeping their activations."""

    remat = False

    def __init__(self, n_classes, feat_channel, agent_num, key_size, query_size, img_size,
                 has_query, mo_flag, attention, dec_width, dtype, backbones):
        super().__init__()
        self.agent_num = agent_num
        self.has_query = has_query
        self.mo_flag = mo_flag
        self.query_size = query_size
        policy_features = backbones.policy_features(img_size)
        self.u_encoder = backbones.encoder(feat_channel, dtype)
        self.query_key_net = backbones.policy(dtype)
        self.key_net = KMGenerator(policy_features, key_size, dtype)
        if has_query:
            self.query_net = KMGenerator(policy_features, query_size, dtype)
        self.attention_net = attention(query_size, key_size, dtype)
        self.decoder = backbones.decoder(dec_width * feat_channel, n_classes, dtype)

    def _tower(self, tower: nn.Module, flat: torch.Tensor) -> torch.Tensor:
        """``tower(flat)``; under ``remat`` in a training forward that
        records gradients, checkpointed (JAX ``nn.remat``, agents.py:406-411)."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return tower(flat)
        # the towers draw nothing at random: no RNG state to keep, and its
        # save would read the generator on the host, which a CUDA graph refuses
        return checkpoint(tower, flat, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _running_stats_kept(tower)))

    def _towers(self, x: torch.Tensor):
        """(values (B, N, C, h, w), keys (B, N, key_size), queries (B, Q,
        query_size)): Q = N, or 1 (agent 0's) without ``mo_flag``."""
        b, n = x.shape[:2]
        flat = _nchw(x)
        val_mat = _unfold(self._tower(self.u_encoder, flat), n)  # the value tower
        qk_map = self._tower(self.query_key_net, flat)  # the policy tower, separate weights
        keys = _unfold(self.key_net(qk_map), n)
        if self.has_query:
            query = _unfold(self.query_net(qk_map), n)
        else:
            query = torch.ones(b, n, self.query_size, dtype=val_mat.dtype, device=x.device)
        if not self.mo_flag:
            query = query[:, :1]
        return val_mat, keys, query


class MIMOcom(_MIMOComm):
    """The when2com MRMS model (reference: agent.py:983-1204): the N x N
    graph (+0.001 I) over the shared towers, the decoder per agent.
    Returns ``(pred, prob (B, K, Q), action (B, Q), num_connect)``.
    ``remat`` checkpoints the two towers in the training forward.
    ``has_query=False`` (``query: false``) uses a query of ones and no
    ``query_net``; ``mo_flag=False`` (``multiple_output: false``) keeps agent
    0's query alone: the graph is (B, K, 1), with no diagonal bias, and one
    prediction a sample. ``topk`` (``eval_inference: topk``, not in the
    reference) keeps each query's ``topk_k`` strongest links, renormalized.

    ``argmax_test`` and ``activated`` on the full graph run the fused comm
    step (``comm_fusion``: K2 on the card); ``topk`` and the single-query
    graph take the plain selections, as the JAX model's Pallas branch
    leaves them to XLA (agents.py:471-485).

    ``ring`` (the agent group of a ``parallel.Layout``, ``model.agent_parallel``)
    runs the full-graph eval modes ``softmax``, ``argmax_test`` and
    ``activated``, and with ``ring_train`` the training forward, as a ring
    (JAX agents.py:442-467): each rank runs both towers on its own N/A
    agents (``local_agents``), projects its queries, gathers the keys,
    fuses its queries' maps as the value shards rotate
    (``parallel.ring.sharded_comm_step``) and decodes them. The prediction
    is the rank's agents' alone, ``(B * N/A, ...)``; the graph, the action
    and ``num_connect`` come back whole on every rank of the ring."""

    def __init__(self, n_classes: int = 11, feat_channel: int = 512,
                 agent_num: int = 6, key_size: int = 1024, query_size: int = 32,
                 img_size: tuple[int, int] = (512, 512), dtype: torch.dtype | None = None,
                 remat: bool = False, has_query: bool = True, mo_flag: bool = True,
                 topk_k: int = 2, backbones: Backbones = Backbones(), ring=None,
                 ring_train: bool = False):
        super().__init__(n_classes, feat_channel, agent_num, key_size, query_size, img_size,
                         has_query=has_query, mo_flag=mo_flag,
                         attention=MIMOGeneralDotAttention, dec_width=1, dtype=dtype,
                         backbones=backbones)
        self.remat = remat
        self.topk_k = topk_k
        self.ring = ring
        self.ring_train = ring_train

    def rings(self, inference: str) -> bool:
        """Whether a forward in ``inference`` (and the module's mode) runs
        the ring."""
        if self.ring is None or not self.mo_flag:
            return False
        if self.training:
            return self.ring_train and inference == "softmax"
        return inference in INFERENCE_MODES

    def local_agents(self, n: int) -> slice:
        """The agents of ``n`` this rank's ring share covers."""
        share = n // self.ring.size
        return slice(self.ring.rank * share, (self.ring.rank + 1) * share)

    def forward(self, x: torch.Tensor, inference: str = "softmax",
                full_res: bool = True):
        _check_mode(self, inference, MIMOCOM_MODES)
        if self.rings(inference):
            return self._ring_forward(x, inference, full_res)
        n = x.shape[1]
        val_mat, keys, query = self._towers(x)
        mo = query.shape[1] == n
        if inference == "softmax":
            # the soft fusion uses the graph (B, K, Q) before the diagonal bias
            feat, prob = self.attention_net(query, keys, val_mat)
            pred = self.decoder(_fold(feat), full_res)
            if mo:
                prob = prob + DIAG_BIAS * torch.eye(n, dtype=prob.dtype, device=prob.device)
            num_connect = torch.full((), float(n - 1), device=x.device)
            return pred, prob, torch.argmax(prob, dim=1), num_connect

        if mo and inference != "topk":
            mode = "argmax" if inference == "argmax_test" else "activated"
            feat, coef, prob = comm_fusion(
                self.attention_net.project(query), keys, val_mat,
                mode=mode, diag_bias=DIAG_BIAS)
            num_connect = num_connect_offdiag(coef, n)
        else:
            prob = self.attention_net.graph(query, keys)
            if mo:
                prob = prob + DIAG_BIAS * torch.eye(n, dtype=prob.dtype, device=prob.device)
            select = {"argmax_test": argmax_select, "activated": activated_select,
                      "topk": functools.partial(topk_select, k=self.topk_k)}[inference]
            feat, coef, num_connect = select(val_mat, prob, n)
        pred = self.decoder(_fold(feat), full_res)
        return pred, prob, torch.argmax(coef, dim=1), num_connect

    def _ring_forward(self, x: torch.Tensor, inference: str, full_res: bool):
        n = x.shape[1]
        if n % self.ring.size:
            raise ValueError(f"{n} agents do not divide over a ring of {self.ring.size}")
        val_mat, keys, query = self._towers(x[:, self.local_agents(n)])
        mode = {"softmax": "softmax", "argmax_test": "argmax",
                "activated": "activated"}[inference]
        feat, coef, soft = sharded_comm_step(self.attention_net.project(query), keys,
                                             val_mat, self.ring, mode=mode,
                                             diag_bias=DIAG_BIAS, thres=THRES)
        pred = self.decoder(_fold(feat), full_res)
        coef, soft = all_gather_cat(coef, self.ring, 2), all_gather_cat(soft, self.ring, 2)
        if inference == "softmax":
            num_connect = torch.full((), float(n - 1), device=x.device)
        else:
            num_connect = num_connect_offdiag(coef, n)
        return pred, soft, torch.argmax(coef, dim=1), num_connect


class MIMOcomWho(_MIMOComm):
    """MRMS who2com, the always-communicate baseline (reference:
    agent.py:1207-1423): the graph with self-links deleted (no bias) over
    MIMOcom's towers, and the decoder on concat(fused, own), 2C channels.
    ``has_query=False`` (``query: false``) uses a query of ones and no
    ``query_net``; ``mo_flag=False`` keeps only the first agent's query.
    Returns ``(pred, prob (B, K, Q), action (B, Q), num_connect)``; the
    action is the graph's argmax in every mode, as in JAX."""

    def __init__(self, n_classes: int = 11, feat_channel: int = 512,
                 has_query: bool = True, agent_num: int = 6, key_size: int = 1024,
                 query_size: int = 32, img_size: tuple[int, int] = (512, 512),
                 mo_flag: bool = True, dtype: torch.dtype | None = None,
                 backbones: Backbones = Backbones()):
        super().__init__(n_classes, feat_channel, agent_num, key_size, query_size, img_size,
                         has_query=has_query, mo_flag=mo_flag,
                         attention=MIMOWhoGeneralDotAttention, dec_width=2, dtype=dtype,
                         backbones=backbones)

    def forward(self, x: torch.Tensor, inference: str = "softmax",
                full_res: bool = True):
        _check_mode(self, inference)
        n = x.shape[1]
        val_mat, keys, query = self._towers(x)
        if inference == "softmax":
            feat, prob = self.attention_net(query, keys, val_mat)
            num_connect = torch.full((), float(n - 1), device=x.device)
        else:
            prob = self.attention_net.graph(query, keys)
            select = argmax_select if inference == "argmax_test" else activated_select
            feat, _, num_connect = select(val_mat, prob, n)
        pred = self.decoder(_fold(torch.cat([feat, val_mat], dim=2)), full_res)
        return pred, prob, torch.argmax(prob, dim=1), num_connect
