"""The port's hand-written CUDA kernels, one module each beside its plain
PyTorch version: ``upsample_argmax`` (K1), ``comm_fusion`` (K2),
``fused_block`` (K3) and ``int8_conv`` (K4, the int8 towers' convolution,
which has no Pallas twin: XLA ran it in the JAX package). Each wrapper
launches its kernel for CUDA tensors (built from ``csrc/`` at first use,
``_build``) and runs the plain version for CPU tensors;
``<wrapper>.launches`` counts kernel launches."""
