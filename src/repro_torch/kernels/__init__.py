"""Attention kernels: hand-written Hopper CUDA sources under ``csrc/``,
their ctypes wrappers, plain PyTorch versions (``ref``) and the dispatch
from the model layout (``ops``). Nothing is built at import time."""
