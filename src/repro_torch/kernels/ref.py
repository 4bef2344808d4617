"""The plain PyTorch version of every kernel under the JAX package's
``kernels.ref`` names (the allclose targets).

Each name is the plain version that sits beside its kernel's wrapper;
nothing here is a second copy.  ``flash_attention_ref`` only adapts the
reference's (BH, L, D) layout to the port's (B, L, H, D).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunked_reduce import \
    chunked_reduce_plain as chunked_reduce_ref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.fused_collectives import (
    all_gather_matmul_plain as all_gather_matmul_ref,
    reduce_scatter_adamw_plain as reduce_scatter_adamw_ref,
    reduce_scatter_rmsnorm_plain as reduce_scatter_rmsnorm_ref)
from repro_torch.kernels.rmsnorm import rms_norm_plain as rms_norm_ref
from repro_torch.kernels.ssm_scan import ssm_scan_plain as ssm_scan_ref

__all__ = ["chunked_reduce_ref", "flash_attention_ref", "ssm_scan_ref",
           "rms_norm_ref", "reduce_scatter_rmsnorm_ref",
           "reduce_scatter_adamw_ref", "all_gather_matmul_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window=None) -> torch.Tensor:
    """(BH, L, D) plain softmax attention."""
    return flash_attention_plain(q.unsqueeze(2), k.unsqueeze(2),
                                 v.unsqueeze(2), causal,
                                 window).squeeze(2)
