"""repro_torch — the ParallelMLPs population engine in PyTorch, for one
NVIDIA H100.

The PyTorch port of the JAX package ``repro``, grown slice by slice
(ROADMAP.md).  It imports ``torch`` and never ``jax``, and nothing of
``repro``: where it needs a numpy-only module of the JAX package it keeps
its own copy.  The serving path runs through three CUDA C++ kernels
written for ``sm_90a`` (``kernels/csrc``), built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor each kernel wrapper runs its plain PyTorch version, on a
CUDA tensor it launches the kernel or raises — there is no fallback.
"""
