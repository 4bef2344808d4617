"""PyTorch/CUDA port of the CXL-CCL reproduction (``repro``).

Imports ``torch`` and ``numpy`` only - never ``jax`` and nothing of the
``repro`` package.  Its hand-written CUDA kernels (``kernels/csrc``) are
built with ``nvcc`` for Hopper (``sm_90a``) at first use.
"""
