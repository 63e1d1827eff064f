"""PyTorch/CUDA port of multiagentperception_tpu (when2com), for NVIDIA Hopper.

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or anything of ``multiagentperception_tpu`` — framework-free code it
needs (config, metrics, data) is copied, not imported. Modules mirror the
JAX package's file names. The TPU's Pallas kernels become hand-written CUDA
kernels in ``csrc/``, built at first use (``ops/kernels``). Entry points run
on ``cuda`` unless the caller asks for ``cpu``.

This slice: MIMOcom evaluation (``python -m multiagentperception_tpu_torch.test``).
"""
