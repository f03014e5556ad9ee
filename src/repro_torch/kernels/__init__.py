"""Kernels: plain PyTorch versions (``ref``), hand-written CUDA kernels
(``csrc/``, built by ``_build``), their wrappers, and the ``ops`` entry
points that pick between them by the device of the input tensor."""
