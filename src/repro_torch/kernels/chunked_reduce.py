"""Chunked multi-source reduction: the CUDA kernel's wrapper, its plain
version, its launch count.

The kernel (``csrc/chunked_reduce.cu``) replaces the Pallas TPU kernel
``repro/kernels/chunked_reduce.py::chunked_reduce``: the consumer-side
N-way sum of the ``cxl`` ReduceScatter / AllReduce / Reduce after the
retrieve phase.  ``chunked_reduce`` launches it for a CUDA tensor and
takes the plain PyTorch version for a CPU tensor.

x: (n_src, L) float32 or bfloat16 -> (L,) in x's dtype, summed in f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _plain_device, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, y, n_src, L, dtype, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def chunked_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """``chunked_reduce_ref`` of the JAX package: f32 sum over sources."""
    return x.float().sum(dim=0).to(x.dtype)


def chunked_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` (n_src, L) over its sources.  A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes :func:`chunked_reduce_plain`."""
    if x.dim() != 2:
        raise ValueError(f"chunked_reduce wants x (n_src, L), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"chunked_reduce takes float32/bfloat16, got "
                        f"{x.dtype}")
    if _plain_device(x):
        return chunked_reduce_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"chunked_reduce runs on cuda or cpu, not "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("chunked_reduce kernel needs a contiguous x")
    out = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
    fn = build.entry("chunked_reduce", "chunked_reduce_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                 _DTYPES[x.dtype], stream)
    build.check("chunked_reduce", err)
    chunked_reduce.launches += 1
    by_n = chunked_reduce.launches_by_n
    by_n[x.shape[0]] = by_n.get(x.shape[0], 0) + 1
    return out


chunked_reduce.launches = 0    # kernel launches since the last reset
chunked_reduce.launches_by_n = {}   # the same, by n_src
