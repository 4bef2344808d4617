"""Blocked (FlashAttention-style) attention forward, model layout.

Port of the forward of ``repro/models/flash.py``: q (B, Lq, H, D), k/v
(B, Lk, H, D) with GQA expansion done by the caller, causal masking on
absolute positions (``q_offset`` supports q-chunked callers), an
optional sliding ``window``, and keys past the ragged kv edge masked.
The blocking, the online softmax and the ragged-edge mask that the JAX
version spells out with ``lax.scan`` and padding live in the hand-written
CUDA kernel (``kernels/csrc/flash_attention.cu``), which this calls
through its wrapper; on CPU tensors the wrapper computes the same
function densely.  It is differentiable: the forward keeps each row's
max and normaliser, and the backward is the reference's recompute VJP
(``kernels.flash_attention.flash_attention_train``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    return _fa.flash_attention_train(q, k, v, causal=causal,
                                     window=window, q_offset=q_offset)
