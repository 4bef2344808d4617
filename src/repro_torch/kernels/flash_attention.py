"""FlashAttention forward: the CUDA kernel's wrapper, its plain version,
its launch count.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and takes the
interface of the JAX model's blocked attention (``repro/models/flash.py``):
q (B, Lq, H, D) and k/v (B, Lk, H, D), GQA-expanded, with ``causal``, a
sliding ``window``, ``q_offset`` (absolute position of query row 0) and
a ragged kv length ``kv_len`` (keys at positions >= kv_len are masked).
Its products run on the tensor cores: 3xTF32 for float32, one bf16
product for bfloat16.  ``flash_attention`` launches it for CUDA tensors
and takes the plain PyTorch version for CPU tensors.

``flash_attention_train`` is the differentiable form the training path
calls: its forward also keeps each row's running max and normaliser (the
kernel writes them to an optional output the serving call leaves off),
and its backward is the recompute VJP of ``repro/models/flash.py``
(``_flash_bwd``), blocked as there, in PyTorch, the same code on both
devices.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import PLAIN_DEVICES, _plain_device, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128)
NEG_INF = -1e30          # masked score, as in models/flash.py
BWD_BLOCK = 512          # the reference's DEFAULT_BLOCK
# q, k, v, o, m, l, then B, Lq, Lk, H, D, causal, window, q_offset,
# kv_len, dtype, then the stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


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
                          kv_len: Optional[int] = None,
                          return_stats: bool = False):
    """Dense masked softmax attention: ``flash_attention_ref`` of the JAX
    package generalised to the model layout, ``q_offset`` and a ragged
    kv length.  Materialises the (Lq, Lk) scores.  ``return_stats``
    also returns each row's max m and normaliser l, (B, Lq, H) f32."""
    lq, lk, d = q.shape[1], k.shape[1], q.shape[-1]
    kv_len = lk if kv_len is None else kv_len
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    mask = attention_mask(lq, lk, causal, window, q_offset, kv_len,
                          q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
    if not return_stats:
        return o
    m = s.amax(dim=-1).clamp(min=NEG_INF)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return o, m.transpose(1, 2), l.transpose(1, 2)


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
    if _plain_device(q):
        return flash_attention_plain(q, k, v, causal, window, q_offset,
                                     kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, window, q_offset, kv_len, False)[0]


def _launch(q, k, v, causal, window, q_offset, kv_len, stats: bool):
    """Launch the kernel; with ``stats`` it also writes m and l."""
    b, lq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs contiguous, "
                             "16-byte aligned q, k and v")
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    fn = build.entry("flash_attention", "flash_attention_launch",
                     _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 m.data_ptr() if stats else None,
                 l.data_ptr() if stats else None,
                 b, lq, k.shape[1], h, d, int(causal),
                 0 if window is None else int(window), int(q_offset),
                 kv_len, _DTYPES[q.dtype], stream)
    build.check("flash_attention", err)
    flash_attention.launches += 1
    return out, m, l


flash_attention.launches = 0    # kernel launches since the last reset


def flash_attention_backward(q, k, v, o, m, l, do, causal: bool,
                             window: Optional[int], q_offset: int,
                             kv_len: int, block: int = BWD_BLOCK):
    """Recompute VJP of ``repro/models/flash.py`` (``_flash_bwd``): the
    per-block probabilities are rebuilt from the saved (q, k, v, o, m, l)
    so the (Lq, Lk) matrix never exists.  Blocks wholly masked by the
    causal or window bound are skipped (their terms are exact zeros).
    Returns (dq, dk, dv) in the inputs' dtypes."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    dof, of = do.float(), o.float()
    dmat = (dof * of).sum(dim=-1)                          # (b, lq, h)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i0 in range(0, lq, block):
        i1 = min(lq, i0 + block)
        q_i = q[:, i0:i1].float()
        do_i = dof[:, i0:i1]
        m_i = m[:, i0:i1].transpose(1, 2)[..., None]       # (b, h, bq, 1)
        l_i = l[:, i0:i1].transpose(1, 2)[..., None].clamp(min=1e-20)
        d_i = dmat[:, i0:i1].transpose(1, 2)[..., None]
        q_lo, q_hi = q_offset + i0, q_offset + i1 - 1
        for j0 in range(0, lk, block):
            j1 = min(lk, j0 + block)
            if j0 >= kv_len or (causal and j0 > q_hi) or \
                    (window is not None and j1 - 1 <= q_lo - window):
                continue
            k_j, v_j = k[:, j0:j1].float(), v[:, j0:j1].float()
            s = torch.einsum("bqhd,bkhd->bhqk", q_i, k_j) * scale
            mask = attention_mask(i1 - i0, j1 - j0, causal, window,
                                  q_offset + i0 - j0, kv_len - j0,
                                  q.device)
            s = s.masked_fill(~mask, NEG_INF)
            p = torch.exp(s - m_i) / l_i
            dp = torch.einsum("bqhd,bkhd->bhqk", do_i, v_j)
            ds = p * (dp - d_i) * scale
            dq[:, i0:i1] += torch.einsum("bhqk,bkhd->bqhd", ds, k_j)
            dk[:, j0:j1] += torch.einsum("bhqk,bqhd->bkhd", ds, q_i)
            dv[:, j0:j1] += torch.einsum("bhqk,bqhd->bkhd", p, do_i)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len):
        if _plain_device(q):
            o, m, l = flash_attention_plain(q, k, v, causal, window,
                                            q_offset, kv_len,
                                            return_stats=True)
        else:
            o, m, l = _launch(q, k, v, causal, window, q_offset, kv_len,
                              True)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.args = (causal, window, q_offset, kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, m, l, do,
                                              *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          window: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Differentiable :func:`flash_attention` (full kv length): the same
    forward, kernel on the card and plain version on the CPU, with the
    recompute VJP :func:`flash_attention_backward`.  Without a gradient
    to track it is :func:`flash_attention` and writes no m/l."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention(q, k, v, causal, window, q_offset)
    kv_len = k.shape[1]
    _check(q, k, v, window, q_offset, kv_len)
    if q.device.type not in PLAIN_DEVICES + ("cuda",):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                 kv_len)
