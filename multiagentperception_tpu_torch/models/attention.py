"""Communication-graph attentions (port of
multiagentperception_tpu/models/attention.py; reference agent.py:194-368).

Queries ``(B, Q, query_size)``, keys ``(B, K, key_size)``, values
``(B, K, C, h, w)`` (NCHW per agent). The SRMS attentions take Q = 1 and
return the fused map ``(B, C, h, w)`` and the probability row ``(B, 1, K)``;
the MIMO attentions return ``(B, Q, C, h, w)`` and the graph ``(B, K, Q)``,
normalized over keys. Submodule names are the reference's
(``attention_net.linear``, ``linear_feat``/``linear_context``/``linear_out``).
``sparse`` selects sparsemax (``ops.sparsemax``) instead of the softmax
over keys in the SRMS attentions (JAX attention.py:28-29); the MIMO
attentions accept it and ignore it, as the JAX ones and the reference do
(agent.py:274 always softmaxes).

``dtype`` is the compute dtype of the linear layers (``models.blocks``).
In a 16-bit compute dtype (bf16 or float16) the SRMS attentions stay in it
end to end, the logits' softmax included, as the JAX ones do; the MIMO
attentions take the einsum ``K Q'^T`` rounded to the compute dtype, upcast
it to float32 and return a float32 graph (attention.py:102-106, 121-126),
and the fusion casts the graph to the values' dtype
(``ops.comm.fuse_values``). (The fused comm step, K2, upcasts Q' and K
first and never rounds the logits, as the Pallas kernel does.) A float16
logit beyond 65504 is inf here as in JAX; nothing clamps.
"""

from __future__ import annotations

import torch
from torch import nn

from multiagentperception_tpu_torch.models.blocks import Linear
from multiagentperception_tpu_torch.ops.comm import drop_diagonal_softmax, fuse_values
from multiagentperception_tpu_torch.ops.sparsemax import sparsemax


class _SRMSAttention(nn.Module):
    """``graph(q, k)`` -> the (B, K, 1) coefficients, normalized over keys
    by softmax, or by sparsemax with ``sparse``; the forward fuses the
    values along them."""

    sparse = False

    def _normalize(self, logits: torch.Tensor) -> torch.Tensor:
        return sparsemax(logits, dim=1) if self.sparse else torch.softmax(logits, dim=1)

    def forward(self, q, k, v):
        coef = self.graph(q, k)
        return fuse_values(coef, v)[:, 0], coef.transpose(1, 2)


class ScaledDotAttention(_SRMSAttention):
    """Normalized over keys, K Q^T / sqrt(128); no weights (reference: agent.py:194-213)."""

    temperature = 128.0 ** 0.5

    def __init__(self, sparse: bool = False):
        super().__init__()
        self.sparse = sparse

    def graph(self, q, k):
        return self._normalize(torch.einsum("bkd,bqd->bkq", k, q) / self.temperature)


class AdditiveAttention(_SRMSAttention):
    """Bahdanau scoring out(feat(k) + context(q)) (reference: agent.py:215-239)."""

    def __init__(self, query_size: int, key_size: int, hidden: int = 128,
                 dtype: torch.dtype | None = None, sparse: bool = False):
        super().__init__()
        self.sparse = sparse
        self.linear_feat = Linear(key_size, hidden, compute_dtype=dtype)
        self.linear_context = Linear(query_size, hidden, compute_dtype=dtype)
        self.linear_out = Linear(hidden, 1, compute_dtype=dtype)

    def graph(self, q, k):
        logits = self.linear_out(self.linear_feat(k) + self.linear_context(q))  # (B, K, 1)
        return self._normalize(logits)


class GeneralDotAttention(_SRMSAttention):
    """Single-query general dot product, Q' = W q (reference: agent.py:345-368)."""

    def __init__(self, query_size: int, key_size: int, dtype: torch.dtype | None = None,
                 sparse: bool = False):
        super().__init__()
        self.sparse = sparse
        self.linear = Linear(query_size, key_size, compute_dtype=dtype)

    def graph(self, q, k):
        return self._normalize(torch.einsum("bkd,bqd->bkq", k, self.linear(q)))


def get_srms_attention(name: str, query_size: int, key_size: int,
                       dtype: torch.dtype | None = None, sparse: bool = False) -> nn.Module:
    """The SRMS attention of ``model.attention`` (reference: agent.py:530-536):
    ``additive``, ``general``, anything else ``scaled``; ``sparse`` normalizes
    with sparsemax."""
    if name == "additive":
        return AdditiveAttention(query_size, key_size, dtype=dtype, sparse=sparse)
    if name == "general":
        return GeneralDotAttention(query_size, key_size, dtype, sparse)
    return ScaledDotAttention(sparse)


class MIMOGeneralDotAttention(nn.Module):
    """The full N x N graph, softmax over keys (reference: agent.py:242-286)."""

    def __init__(self, query_size: int, key_size: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.linear = Linear(query_size, key_size, compute_dtype=dtype)

    def project(self, q: torch.Tensor) -> torch.Tensor:
        """Q' = W q, the projected queries the fused comm kernel consumes."""
        return self.linear(q)

    def _logits(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        logits = torch.einsum("bkd,bqd->bkq", k, self.project(q))
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def graph(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """(B, K, Q) softmax over keys of K Q'^T, in float32 (or float64):
        the product in the inputs' dtype, then upcast."""
        return torch.softmax(self._logits(q, k), dim=1)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        coef = self.graph(q, k)
        return fuse_values(coef, v), coef


class MIMOWhoGeneralDotAttention(MIMOGeneralDotAttention):
    """The graph with self-links deleted before the softmax, the who2com
    always-communicate baseline (reference: agent.py:289-343)."""

    def graph(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return drop_diagonal_softmax(self._logits(q, k), dim=1)
