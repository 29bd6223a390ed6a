"""OnPair16 kernels: hand-written CUDA for Hopper, their plain PyTorch
versions (``ref``), and the host <-> device bridge (``ops``).

A kernel wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors. Nothing here builds or loads the
CUDA library at import time: ``_build.load()`` runs at the first launch.
"""
