"""The port's CUDA kernels on the card: each against its plain PyTorch
version at the flagship shapes, through the checks ``chip_smoke.py`` also
runs (``ops/kernels/checks.py``, which states the tolerances), and what
the wrappers refuse. Every test here needs an NVIDIA card and skips
without one. It imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from multiagentperception_tpu_torch.ops.kernels import checks
from multiagentperception_tpu_torch.ops.kernels import comm_fusion as k2
from multiagentperception_tpu_torch.ops.kernels import upsample_argmax as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: a CUDA kernel has no CPU mode to run here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_upsample_argmax_kernel_matches_plain(cuda):
    x = torch.randn(12, 11, 16, 16, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = k1.upsample_argmax.launches
    checks.check_upsample_argmax(x, 512, 512)
    assert k1.upsample_argmax.launches == before + 2  # the logits and the tie case


def test_upsample_argmax_kernel_refuses_non_contiguous(cuda):
    x = torch.randn(2, 16, 16, 11, device=cuda).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k1.upsample_argmax(x, 512, 512)


@pytest.mark.parametrize("mode", k2.MODES)
def test_comm_fusion_kernel_matches_plain(cuda, mode):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 6, 1024, generator=g).to(cuda)
    k = (torch.randn(2, 6, 1024, generator=g) * 2 / 1024 ** 0.5).to(cuda)  # links survive
    v = torch.randn(2, 6, 512, 16, 16, generator=g).to(cuda)
    before = k2.comm_fusion.launches
    checks.check_comm_fusion(q, k, v, mode, diag_bias=0.001)
    assert k2.comm_fusion.launches == before + 1


def test_comm_fusion_kernel_refuses_bf16(cuda):
    q, k = (torch.randn(2, 6, 1024, device=cuda, dtype=torch.bfloat16) for _ in range(2))
    v = torch.randn(2, 6, 512, 16, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        k2.comm_fusion(q, k, v, mode="activated")
