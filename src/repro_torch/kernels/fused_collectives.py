"""All-gather-consuming matmul: the CUDA kernel's wrapper, its plain
version, its launch count, and the differentiable ``fused_dense``.

The kernel (``csrc/all_gather_matmul.cu``) replaces the Pallas TPU kernel
``repro/kernels/fused_collectives.py::all_gather_matmul``: ``x @
concat(w_shards)`` over a rank-major stack of FSDP weight shards, read in
place (the stack may be a strided view of the gathered bucket; the
concatenated weight is never built).  ``fused_dense`` wraps it for the
differentiated training path; its backward is the reference's plain
matmul transpose.  The reference's other two fused kernels
(``reduce_scatter_adamw``, ``reduce_scatter_rmsnorm``) have no caller on
the JAX train step and are not ported yet (ROADMAP queue 2).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# x, w, y, T, n, Ks, N, shard_stride, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p]


def _check(x: torch.Tensor, w_shards: torch.Tensor) -> None:
    if x.dim() != 2 or w_shards.dim() != 3:
        raise ValueError(f"all_gather_matmul wants x (T, n*Ks) and "
                         f"w_shards (n, Ks, N), got {tuple(x.shape)} and "
                         f"{tuple(w_shards.shape)}")
    n, ks, _ = w_shards.shape
    if x.shape[1] != n * ks:
        raise ValueError(f"contraction mismatch: x has {x.shape[1]} "
                         f"columns, shards give {n}x{ks}")
    if x.device != w_shards.device:
        raise ValueError("x and w_shards must be on one device")


def all_gather_matmul_plain(x: torch.Tensor,
                            w_shards: torch.Tensor) -> torch.Tensor:
    """``all_gather_matmul_ref`` of the JAX package: the concatenated
    weight's matmul."""
    _check(x, w_shards)
    n, ks, nout = w_shards.shape
    return x @ w_shards.reshape(n * ks, nout)


def all_gather_matmul(x: torch.Tensor,
                      w_shards: torch.Tensor) -> torch.Tensor:
    """``x`` (T, n*Ks) @ concat of ``w_shards`` (n, Ks, N) -> (T, N).  A
    CUDA tensor launches the kernel (float32; or raises); a CPU tensor
    takes :func:`all_gather_matmul_plain`."""
    _check(x, w_shards)
    if x.device.type == "cpu":
        return all_gather_matmul_plain(x, w_shards)
    if x.device.type != "cuda":
        raise ValueError(f"all_gather_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dtype != torch.float32 or w_shards.dtype != torch.float32:
        raise TypeError(f"all_gather_matmul kernel takes float32, got "
                        f"{x.dtype} and {w_shards.dtype}")
    n, ks, nout = w_shards.shape
    if not x.is_contiguous() or w_shards.stride(2) != 1 \
            or w_shards.stride(1) != nout:
        raise ValueError("all_gather_matmul kernel needs a contiguous x "
                         "and shards with contiguous (Ks, N) rows")
    out = torch.empty((x.shape[0], nout), dtype=x.dtype, device=x.device)
    fn = build.entry("all_gather_matmul", "all_gather_matmul_launch",
                     _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w_shards.data_ptr(), out.data_ptr(),
                 x.shape[0], n, ks, nout, w_shards.stride(0), stream)
    build.check("all_gather_matmul", err)
    all_gather_matmul.launches += 1
    return out


all_gather_matmul.launches = 0    # kernel launches since the last reset


class _FusedDense(torch.autograd.Function):
    """Forward through :func:`all_gather_matmul`; backward is the plain
    matmul transpose of the reference's ``_fused_dense_bwd``."""

    @staticmethod
    def forward(ctx, x, w_shards):
        n, ks, nout = w_shards.shape
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = all_gather_matmul(x2, w_shards)
        ctx.save_for_backward(x2, w_shards)
        ctx.lead = lead
        return y.reshape(*lead, nout)

    @staticmethod
    def backward(ctx, g):
        x2, w_shards = ctx.saved_tensors
        n, ks, nout = w_shards.shape
        g2 = g.reshape(-1, nout)
        # dx per shard, reading the stack in place: (n, T, Ks) -> (T, n*Ks)
        dx = torch.matmul(g2, w_shards.transpose(1, 2))
        dx = dx.transpose(0, 1).reshape(g2.shape[0], n * ks)
        dw = (x2.t() @ g2).reshape(n, ks, nout)
        return dx.reshape(*ctx.lead, n * ks), dw


def fused_dense(x: torch.Tensor, w_shards: torch.Tensor) -> torch.Tensor:
    """Differentiable ``x @ concat(w_shards)`` over the last dim of ``x``
    (leading dims are batch), forward via :func:`all_gather_matmul`."""
    return _FusedDense.apply(x, w_shards)
