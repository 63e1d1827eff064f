"""Tensor ops of the port: normalize, resize, the comm-graph ops and the
hand-written kernels (``ops.kernels``)."""
