"""Numeric ops: plain PyTorch references and the hand-written Hopper
kernels (sources under ``../csrc``, built on first use by ``_cuda``)."""
