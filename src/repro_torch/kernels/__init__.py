"""Hand-written CUDA C++ kernels for Hopper (``csrc/``), their ctypes
wrappers and plain PyTorch versions, and the dispatch layer ``ops``.

As the JAX package's ``repro.kernels``, the package exports the kernel API
entries ``flash_attention`` and ``moe_gemm`` (their kernel modules:
``flash_attn`` and ``grouped_gemm``).
"""
from repro_torch.kernels.ops import flash_attention, moe_gemm

__all__ = ["flash_attention", "moe_gemm"]
