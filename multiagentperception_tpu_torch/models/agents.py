"""MIMOcom, the when2com MRMS model (port of
multiagentperception_tpu/models/agents.py:345-512; reference agent.py:983-1204).

Inputs keep the JAX package's layout ``(B, N, H, W, 3)``; inside, the agent
axis folds into the batch and the towers run NCHW. Per-agent outputs stack
batch-major: ``out[b*N + n]`` is agent ``n`` of sample ``b``.

In training mode (``model.train()``) the forward is the soft fusion, as the
JAX model's ``train=True`` branch; BatchNorm normalizes with the batch's
statistics and updates its running ones, unless the trainer put the
BatchNorm modules in eval mode (``training.freeze_bn_stats``).

Eval modes ``softmax``, ``argmax_test`` and ``activated``; the forward
returns ``(pred, prob_action, action, num_connect)`` as the JAX model does,
with ``pred`` NCHW ``(B*N, n_classes, H, W)`` — or the decoder's
pre-upsample logits ``(B*N, n_classes, H/32, W/32)`` with ``full_res=False``,
which is what the evaluator feeds the upsample+argmax kernel.

The pruned modes always run the communication step through
``comm_fusion`` (the kernel on the card, its plain version on the CPU), as
the JAX model does under ``model.pallas_comm``; its plain pruned path
computes the same outputs, so the port takes the option and ignores it.
That plain path decodes twice and XLA drops the unused first decode; eager
PyTorch would run it, so the port does not (BatchNorm runs on running
stats, nothing else changes).
"""

from __future__ import annotations

import torch
from torch import nn

from multiagentperception_tpu_torch.models.attention import MIMOGeneralDotAttention
from multiagentperception_tpu_torch.models.modules import (
    ImgDecoder,
    ImgEncoder,
    KMGenerator,
    PolicyNet4,
)
from multiagentperception_tpu_torch.ops.comm import num_connect_offdiag
from multiagentperception_tpu_torch.ops.kernels.comm_fusion import comm_fusion

INFERENCE_MODES = ("softmax", "argmax_test", "activated")
DIAG_BIAS = 0.001  # prefer-own-frame bias (reference agent.py:1164-1167)


class MIMOcom(nn.Module):
    def __init__(self, n_classes: int = 11, feat_channel: int = 512,
                 agent_num: int = 6, key_size: int = 1024, query_size: int = 32,
                 img_size: tuple[int, int] = (512, 512)):
        super().__init__()
        self.agent_num = agent_num
        # the policy map is 256 channels at 1/128 of the input
        policy_features = 256 * (img_size[0] // 128) * (img_size[1] // 128)
        self.u_encoder = ImgEncoder(feat_channel)
        self.query_key_net = PolicyNet4()
        self.key_net = KMGenerator(policy_features, key_size)
        self.query_net = KMGenerator(policy_features, query_size)
        self.attention_net = MIMOGeneralDotAttention(query_size, key_size)
        self.decoder = ImgDecoder(feat_channel, n_classes)

    def forward(self, x: torch.Tensor, inference: str = "softmax",
                full_res: bool = True):
        if self.training and inference != "softmax":
            raise ValueError(f"inference mode {inference!r} in training: the training "
                             "forward is the soft fusion (inference='softmax')")
        if inference not in INFERENCE_MODES:
            raise ValueError(f"inference mode {inference!r} not in {INFERENCE_MODES} "
                             "(topk waits for a later slice, ROADMAP.md)")
        b, n = x.shape[:2]
        flat = x.reshape((b * n,) + tuple(x.shape[2:])).permute(0, 3, 1, 2).contiguous()
        val = self.u_encoder(flat)  # (B*N, C, h, w): the value tower
        qk_map = self.query_key_net(flat)  # the policy tower, separate weights
        keys = self.key_net(qk_map).reshape(b, n, -1)
        query = self.query_net(qk_map).reshape(b, n, -1)
        val_mat = val.reshape((b, n) + tuple(val.shape[1:]))

        if inference == "softmax":
            # the soft fusion uses the graph (B, K, Q) before the diagonal bias
            feat, prob = self.attention_net(query, keys, val_mat)
            pred = self.decoder(feat.reshape(val.shape), full_res)
            prob = prob + DIAG_BIAS * torch.eye(n, dtype=prob.dtype, device=prob.device)
            num_connect = torch.tensor(float(n - 1), device=x.device)
            return pred, prob, torch.argmax(prob, dim=1), num_connect

        mode = "argmax" if inference == "argmax_test" else "activated"
        feat, coef, prob = comm_fusion(
            self.attention_net.project(query), keys, val_mat,
            mode=mode, diag_bias=DIAG_BIAS)
        pred = self.decoder(feat.reshape(val.shape), full_res)
        return pred, prob, torch.argmax(coef, dim=1), num_connect_offdiag(coef, n)
