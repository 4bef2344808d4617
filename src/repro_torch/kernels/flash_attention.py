"""FlashAttention forward: the CUDA kernel's wrapper, its plain version,
its launch count.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and takes the
interface of the JAX model's blocked attention (``repro/models/flash.py``):
q (B, Lq, H, D) and k/v (B, Lk, H, D), GQA-expanded, with ``causal``, a
sliding ``window``, ``q_offset`` (absolute position of query row 0) and
a ragged kv length ``kv_len`` (keys at positions >= kv_len are masked).
``flash_attention`` launches it for CUDA tensors and takes the plain
PyTorch version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
# q, k, v, o, then B, Lq, Lk, H, D, causal, window, q_offset, kv_len,
# dtype, then the stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def attention_mask(lq: int, lk: int, causal: bool, window: Optional[int],
                   q_offset: int, kv_len: int,
                   device=None) -> torch.Tensor:
    """(Lq, Lk) bool: which keys each query row may see."""
    qpos = torch.arange(lq, device=device)[:, None] + q_offset
    kpos = torch.arange(lk, device=device)[None, :]
    mask = kpos < kv_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """Dense masked softmax attention: ``flash_attention_ref`` of the JAX
    package generalised to the model layout, ``q_offset`` and a ragged
    kv length.  Materialises the (Lq, Lk) scores."""
    lq, lk, d = q.shape[1], k.shape[1], q.shape[-1]
    kv_len = lk if kv_len is None else kv_len
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    mask = attention_mask(lq, lk, causal, window, q_offset, kv_len,
                          q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype),
                        v).to(q.dtype)


def _check(q, k, v, window, q_offset, kv_len) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention wants q (B, Lq, H, D) and k/v "
                         f"(B, Lk, H, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0 or not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"need q_offset >= 0 and 0 <= kv_len <= Lk, got "
                         f"{q_offset}, {kv_len}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Blocked attention forward in the model layout.  CUDA tensors
    launch the kernel (or raise); CPU tensors take
    :func:`flash_attention_plain`."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    _check(q, k, v, window, q_offset, kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, q_offset,
                                     kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    b, lq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs contiguous, "
                             "16-byte aligned q, k and v")
    out = torch.empty_like(q)
    fn = build.entry("flash_attention", "flash_attention_launch",
                     _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, lq, k.shape[1], h, d, int(causal),
                 0 if window is None else int(window), int(q_offset),
                 kv_len, _DTYPES[q.dtype], stream)
    build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0    # kernel launches since the last reset
