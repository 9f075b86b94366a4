"""Kernels of the port (CUDA C++ for Hopper, built by ``_build``), each
beside its plain PyTorch version, plus the plain ops around them."""
