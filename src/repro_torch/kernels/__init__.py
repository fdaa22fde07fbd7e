"""Hand-written CUDA C++ kernels for Hopper (``csrc/``), their ctypes
wrappers and plain PyTorch versions, and the dispatch layer ``ops``."""
