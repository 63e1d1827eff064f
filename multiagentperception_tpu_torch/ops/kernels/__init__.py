"""The port's hand-written CUDA kernels, one module each beside its plain
PyTorch version: ``upsample_argmax`` (K1), ``comm_fusion`` (K2),
``fused_block`` (K3) and ``int8_conv`` (K4, the int8 towers' convolution,
which has no Pallas twin: XLA ran it in the JAX package). Each wrapper
launches its kernel for CUDA tensors (built from ``csrc/`` at first use,
``_build``) and runs the plain version for CPU tensors;
``<wrapper>.launches`` counts kernel launches.

K1, K2 and K4's two launches are custom ops of the namespace ``when2com``
(``torch.ops.when2com.*``: ``upsample_argmax``, ``comm_fusion``,
``int8_quantize``, ``int8_gemm``), each with a CPU implementation (the
plain version), a CUDA one (the launch, which counts) and a fake one, so
that ``torch.export`` carries them. Importing this package registers them
all; it imports nothing of ``models``.
"""

from multiagentperception_tpu_torch.ops.kernels import comm_fusion, int8_conv, upsample_argmax

NAMESPACE = "when2com"
OPS = ("upsample_argmax", "comm_fusion", "int8_quantize", "int8_gemm")

__all__ = ["comm_fusion", "int8_conv", "upsample_argmax", "NAMESPACE", "OPS"]
