"""Each CUDA kernel held against its plain PyTorch version on the same
inputs on the card. ``chip_smoke.py`` runs these checks at the flagship
shapes, and ``tests/test_torch_cuda.py`` runs them too. Each check raises
``AssertionError`` when the kernel and its plain version disagree, and
returns what it measured.

Tolerances:
- K1 (``upsample_argmax``): at least 99.99% of pixels agree. At every
  pixel that differs, the plain version's top two upsampled logits lie
  within 1e-4 (a near-tie), because the kernel sums its taps in another
  order than the dense matmuls. An all-equal input gives class 0.
- K2 (``comm_fusion``): masks equal, ``coef`` and ``soft`` within atol
  1e-6, fused within rtol/atol 1e-5.
"""

from __future__ import annotations

import torch

from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1
from multiagentperception_tpu_torch.ops.resize import bilinear_resize

K1_MIN_AGREEMENT = 0.9999
K1_NEAR_TIE = 1e-4


def check_upsample_argmax(x: torch.Tensor, out_h: int, out_w: int) -> dict:
    """K1 on NCHW logits ``x`` (on the card) against its plain version.
    Returns the pixel agreement and the largest upsampled logit lost at a
    flipped pixel (``max_abs_err``)."""
    got = k1.upsample_argmax(x, out_h, out_w)
    ref = k1.upsample_argmax_plain(x, out_h, out_w)
    if got.dtype != torch.int32 or got.shape != ref.shape:
        raise AssertionError(f"K1 gives {got.dtype} {tuple(got.shape)}, "
                             f"plain {ref.dtype} {tuple(ref.shape)}")
    up = bilinear_resize(x, out_h, out_w)
    top2 = up.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    miss = got != ref
    agree = 1.0 - miss.float().mean().item()
    if agree < K1_MIN_AGREEMENT or bool((gap[miss] >= K1_NEAR_TIE).any()):
        raise AssertionError(f"K1 disagrees: agree={agree}, largest gap at a mismatch "
                             f"{gap[miss].max().item() if miss.any() else 0}")
    lost = up.gather(1, ref.long()[:, None]) - up.gather(1, got.long()[:, None])
    tied = k1.upsample_argmax(torch.ones_like(x[:2]), out_h, out_w)
    if bool(tied.any()):
        raise AssertionError("K1: an all-equal input must give class 0")
    return {"max_abs_err": lost.abs().max().item(), "pixel_agreement": agree}


def check_comm_fusion(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str,
                      diag_bias: float, thres: float = 0.2) -> float:
    """K2 in one mode against its plain version; returns the largest
    absolute error over fused and coef."""
    fused, coef, soft = k2.comm_fusion(q, k, v, mode=mode, diag_bias=diag_bias, thres=thres)
    r_fused, r_coef, r_soft = k2.comm_fusion_plain(q, k, v, mode=mode,
                                                  diag_bias=diag_bias, thres=thres)
    if not torch.equal(coef != 0, r_coef != 0):
        raise AssertionError(f"K2 {mode}: masks differ")
    torch.testing.assert_close(coef, r_coef, rtol=0, atol=1e-6)
    torch.testing.assert_close(soft, r_soft, rtol=0, atol=1e-6)
    torch.testing.assert_close(fused, r_fused, rtol=1e-5, atol=1e-5)
    if mode == "activated":
        eye = torch.eye(coef.shape[1], dtype=torch.bool, device=coef.device)
        if not bool(((coef != 0) & ~eye).any(2).any(1).all()):
            raise AssertionError("K2 check input prunes every link of a sample")
    return max((fused - r_fused).abs().max().item(), (coef - r_coef).abs().max().item())
