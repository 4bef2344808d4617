"""The public kernel API: the JAX package's ``kernels.ops`` names.

Each function takes the reference's arguments and layouts and calls the
port's wrapper, which launches the hand-written CUDA kernel for CUDA
tensors (or raises) and takes the plain PyTorch version for CPU tensors
- the counterpart of the reference's interpret mode off the TPU.  The
Pallas grid arguments (``interpret`` and the tile sizes ``rows``,
``tile``, ``block_*``) have no counterpart and are not taken.

As in the JAX package, ``reduce_scatter_rmsnorm`` and
``reduce_scatter_adamw`` are reached only through this API: no model
path calls them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chunked_reduce as _cr
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_collectives as _fc
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssm_scan as _ss


def chunked_reduce(x: torch.Tensor) -> torch.Tensor:
    """(n_src, L) -> (L,) sum with f32 accumulation."""
    return _cr.chunked_reduce(x)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q/k/v: (BH, L, D), the reference kernel's layout (one head per
    batch row); the port's kernel takes (B, L, H, D)."""
    return _fa.flash_attention(q.unsqueeze(2), k.unsqueeze(2),
                               v.unsqueeze(2), causal, window).squeeze(2)


def ssm_scan(x, dt, a, bs, cs, d_res) -> torch.Tensor:
    """Mamba-1 selective scan, x/dt (B, L, D), a (D, N), bs/cs (B, L, N),
    d_res (D,) -> y (B, L, D)."""
    return _ss.ssm_scan(x, dt, a, bs, cs, d_res)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """(T, D) row-wise RMSNorm; the port's kernel takes a float32 scale."""
    return _rn.rms_norm(x, scale.float(), eps)


def reduce_scatter_rmsnorm(shards: torch.Tensor, scale: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """(n_src, T, D) peer partials -> (T, D) rmsnorm of their f32 sum."""
    return _fc.reduce_scatter_rmsnorm(shards, scale, eps)


def reduce_scatter_adamw(shards, p, m, v, lr, bc1, bc2, b1: float = 0.9,
                         b2: float = 0.95, eps: float = 1e-8,
                         weight_decay: float = 0.0) -> tuple:
    """(n_src, L) grad partials + (L,) param and f32 moments -> new
    (p', m', v'); ``lr``/``bc1``/``bc2`` numbers or 0-d tensors."""
    return _fc.reduce_scatter_adamw(shards, p, m, v, lr, bc1, bc2, b1=b1,
                                    b2=b2, eps=eps,
                                    weight_decay=weight_decay)


def all_gather_matmul(x: torch.Tensor,
                      w_shards: torch.Tensor) -> torch.Tensor:
    """(T, n*Ks) @ concat of (n, Ks, N) rank-major shards -> (T, N)."""
    return _fc.all_gather_matmul(x, w_shards)


def fused_dense(x: torch.Tensor, w_shards: torch.Tensor) -> torch.Tensor:
    """Differentiable fused AllGather-consuming matmul (the FSDP path's
    gather+matmul replacement)."""
    return _fc.fused_dense(x, w_shards)
