"""Fused collective+compute kernels: the CUDA kernels' wrappers, their
plain versions, their launch counts, and the differentiable
``fused_dense``.

Each kernel replaces the Pallas TPU kernel of the same name in
``repro/kernels/fused_collectives.py``:

* ``all_gather_matmul`` (``csrc/all_gather_matmul.cu``): ``x @
  concat(w_shards)`` over a rank-major stack of FSDP weight shards, read
  in place (the stack may be a strided view of the gathered bucket; the
  concatenated weight is never built), on the tensor cores in 3xTF32
  with an output tile chosen per shape (:func:`agm_geometry`).
  ``fused_dense`` wraps it for the differentiated training path; its
  backward is the reference's plain matmul transpose.
* ``reduce_scatter_rmsnorm`` (``csrc/reduce_scatter_rmsnorm.cu``): the
  f32 sum of a ReduceScatter's n_src partials, normalised per row before
  it is written.
* ``reduce_scatter_adamw`` (``csrc/reduce_scatter_adamw.cu``): the f32
  sum of n_src gradient partials fed straight into the AdamW update;
  the summed gradient is never written.

A wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version for CPU tensors.  As in the JAX package, no model path
calls the two reduce_scatter kernels: the public kernel API
(``kernels.ops``) carries them.
"""
from __future__ import annotations

import ctypes
from typing import Union

import numpy as np
import torch

from repro_torch.kernels import PLAIN_DEVICES, _plain_device, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# x, w, y, T, n, Ks, N, shard_stride, tile, vec, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the kernel's compiled output tiles (BM, BN), in the order tried
AGM_TILES = ((128, 128), (64, 32))
H100_SMS = 132
AGM_FILL = 0.9     # the share of the SMs a tile's grid must give a block


def agm_geometry(t: int, n: int, ks: int, nout: int,
                 sms: int = H100_SMS) -> dict:
    """The kernel's launch for x (t, n*ks) @ (n, ks, nout): the first
    output tile of :data:`AGM_TILES` whose grid gives at least
    :data:`AGM_FILL` of ``sms`` SMs a block (else the last tile), the
    grid ``(M tiles, N tiles)``, and whether every staged copy can move
    16 bytes (the contraction and N multiples of 4 floats; the wrapper
    also checks the shard stride and both bases).  On the H100 the
    128 x 128 tile's 128 blocks at N = 2048 ran faster than every tile
    that gives all 132 SMs a block (PERF.md)."""
    for tile, (bm, bn) in enumerate(AGM_TILES):
        grid = (-(-t // bm), -(-nout // bn))
        if grid[0] * grid[1] >= AGM_FILL * sms or \
                tile == len(AGM_TILES) - 1:
            break
    return {"tile": tile, "block": (bm, bn), "grid": grid,
            "vec": (n * ks) % 4 == 0 and nout % 4 == 0}


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
    if _plain_device(x):
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
    geo = agm_geometry(x.shape[0], n, ks, nout, torch.cuda.
                       get_device_properties(x.device).multi_processor_count)
    vec = geo["vec"] and w_shards.stride(0) % 4 == 0 and \
        x.data_ptr() % 16 == 0 and w_shards.data_ptr() % 16 == 0
    fn = build.entry("all_gather_matmul", "all_gather_matmul_launch",
                     _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w_shards.data_ptr(), out.data_ptr(),
                 x.shape[0], n, ks, nout, w_shards.stride(0), geo["tile"],
                 int(vec), stream)
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


# --------------------------------------------------------------------- #
# reduce_scatter + rmsnorm epilogue
# --------------------------------------------------------------------- #

RS_RMSNORM_STRIPS = 256 * 16   # threads per row x strips each holds
# x, scale, y, n_src, rows, D, eps, dtype, stream
_RS_RMSNORM_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def reduce_scatter_rmsnorm_plain(shards: torch.Tensor, scale: torch.Tensor,
                                 eps: float = 1e-5) -> torch.Tensor:
    """``reduce_scatter_rmsnorm_ref`` of the JAX package: the f32 sum of
    the partials, normalised per row, in the partials' dtype."""
    acc = shards.float().sum(dim=0)
    var = acc.square().mean(dim=-1, keepdim=True)
    return (acc * torch.rsqrt(var + eps) * scale.float()).to(shards.dtype)


def reduce_scatter_rmsnorm(shards: torch.Tensor, scale: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """``shards`` (n_src, T, D) peer partials -> (T, D) rmsnorm of their
    f32 sum, times ``scale`` (D,).  A CUDA tensor launches the kernel
    (float32/bfloat16 partials; a scale in another dtype than float32 is
    converted first) or raises; a CPU tensor takes
    :func:`reduce_scatter_rmsnorm_plain`."""
    if shards.dim() != 3 or scale.dim() != 1 or \
            scale.shape[0] != shards.shape[2]:
        raise ValueError(f"reduce_scatter_rmsnorm wants shards (n_src, T, "
                         f"D) and scale (D,), got {tuple(shards.shape)} and "
                         f"{tuple(scale.shape)}")
    if shards.shape[0] < 1:
        raise ValueError("reduce_scatter_rmsnorm needs n_src >= 1")
    if shards.dtype not in _DTYPES:
        raise TypeError(f"reduce_scatter_rmsnorm takes float32/bfloat16 "
                        f"partials, got {shards.dtype}")
    if shards.device != scale.device:
        raise ValueError("shards and scale must be on one device")
    if _plain_device(shards):
        return reduce_scatter_rmsnorm_plain(shards, scale, eps)
    if shards.device.type != "cuda":
        raise ValueError(f"reduce_scatter_rmsnorm runs on cuda or cpu, not "
                         f"{shards.device}")
    if not shards.is_contiguous():
        raise ValueError("reduce_scatter_rmsnorm kernel needs contiguous "
                         "shards")
    n_src, t, d = shards.shape
    elems = 16 // shards.element_size()
    out = torch.empty((t, d), dtype=shards.dtype, device=shards.device)
    vec = d % elems == 0 and shards.data_ptr() % 16 == 0 and \
        out.data_ptr() % 16 == 0
    if d > RS_RMSNORM_STRIPS * (elems if vec else 1):
        raise ValueError(f"reduce_scatter_rmsnorm kernel takes D up to "
                         f"{RS_RMSNORM_STRIPS * (elems if vec else 1)} here, "
                         f"got {d}")
    scale32 = scale.float().contiguous()
    fn = build.entry("reduce_scatter_rmsnorm",
                     "reduce_scatter_rmsnorm_launch", _RS_RMSNORM_ARGTYPES)
    with torch.cuda.device(shards.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(shards.data_ptr(), scale32.data_ptr(), out.data_ptr(),
                 n_src, t, d, eps, _DTYPES[shards.dtype], stream)
    build.check("reduce_scatter_rmsnorm", err)
    reduce_scatter_rmsnorm.launches += 1
    return out


reduce_scatter_rmsnorm.launches = 0    # kernel launches since the last reset


# --------------------------------------------------------------------- #
# reduce_scatter + AdamW epilogue
# --------------------------------------------------------------------- #

Hyper = Union[float, torch.Tensor]
# g, p, m, v, p_out, m_out, v_out, n_src, L, g_dtype, p_dtype, b1, 1 - b1,
# b2, 1 - b2, eps, weight_decay, lr, bc1, bc2, lr_p, bc1_p, bc2_p, stream
_RS_ADAMW_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [
    ctypes.c_float] * 9 + [ctypes.c_void_p] * 4


def _f32(h: Hyper) -> Hyper:
    """A hyperparameter as the reference takes it, ``jnp.float32(h)``:
    a tensor in float32, a number rounded to float32."""
    if isinstance(h, torch.Tensor):
        return h.float()
    return float(np.float32(h))


def reduce_scatter_adamw_plain(shards: torch.Tensor, p: torch.Tensor,
                               m: torch.Tensor, v: torch.Tensor,
                               lr: Hyper, bc1: Hyper, bc2: Hyper,
                               b1: float = 0.9, b2: float = 0.95,
                               eps: float = 1e-8,
                               weight_decay: float = 0.0) -> tuple:
    """``reduce_scatter_adamw_ref`` of the JAX package: AdamW on the f32
    sum of the gradient partials; returns new (p', m', v')."""
    g = shards.float().sum(dim=0)
    lr, bc1, bc2 = _f32(lr), _f32(bc1), _f32(bc2)
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g.square()
    delta = (m / bc1) / ((v / bc2).sqrt() + eps)
    p32 = p.float()
    if weight_decay:
        delta = delta + weight_decay * p32
    return (p32 - lr * delta).to(p.dtype), m, v


def _check_rs_adamw(shards, p, m, v) -> None:
    if shards.dim() != 2 or any(t.dim() != 1 for t in (p, m, v)) or \
            not p.shape[0] == m.shape[0] == v.shape[0] == shards.shape[1]:
        raise ValueError(f"reduce_scatter_adamw wants shards (n_src, L) and "
                         f"p, m, v (L,), got {tuple(shards.shape)}, "
                         f"{tuple(p.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}")
    if shards.shape[0] < 1:
        raise ValueError("reduce_scatter_adamw needs n_src >= 1")
    if shards.dtype not in _DTYPES or p.dtype not in _DTYPES or \
            m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"reduce_scatter_adamw takes float32/bfloat16 "
                        f"shards and p and float32 moments, got "
                        f"{shards.dtype}, {p.dtype}, {m.dtype}, {v.dtype}")
    if not shards.device == p.device == m.device == v.device:
        raise ValueError("shards, p, m and v must be on one device")


def reduce_scatter_adamw(shards: torch.Tensor, p: torch.Tensor,
                         m: torch.Tensor, v: torch.Tensor, lr: Hyper,
                         bc1: Hyper, bc2: Hyper, b1: float = 0.9,
                         b2: float = 0.95, eps: float = 1e-8,
                         weight_decay: float = 0.0) -> tuple:
    """AdamW on the f32 sum of ``shards`` (n_src, L) gradient partials:
    returns new (p', m', v') from param ``p`` (L,) and float32 moments
    ``m``, ``v`` (L,).  ``lr`` (the schedule's rate) and the bias
    corrections ``bc1``/``bc2`` (``1 - b^step``) are numbers or 0-d
    tensors; a CUDA one is read by the kernel on the device (no host
    sync).  CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`reduce_scatter_adamw_plain`."""
    _check_rs_adamw(shards, p, m, v)
    dev = shards.device
    if dev.type in PLAIN_DEVICES:
        return reduce_scatter_adamw_plain(shards, p, m, v, lr, bc1, bc2, b1,
                                          b2, eps, weight_decay)
    if dev.type != "cuda":
        raise ValueError(f"reduce_scatter_adamw runs on cuda or cpu, not "
                         f"{dev}")
    if not all(t.is_contiguous() for t in (shards, p, m, v)):
        raise ValueError("reduce_scatter_adamw kernel needs contiguous "
                         "shards, p, m and v")
    values, ptrs = [], []
    for name, h in (("lr", lr), ("bc1", bc1), ("bc2", bc2)):
        if isinstance(h, torch.Tensor):
            if h.numel() != 1 or h.device != dev:
                raise ValueError(f"{name} must be a number or a one-element "
                                 f"tensor on {dev}, got {tuple(h.shape)} on "
                                 f"{h.device}")
            h = h.float().contiguous()    # kept alive until the launch
            values.append((0.0, h))
            ptrs.append(h.data_ptr())
        else:
            values.append((float(h), None))
            ptrs.append(None)
    n_src, length = shards.shape
    p_out = torch.empty_like(p)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    fn = build.entry("reduce_scatter_adamw", "reduce_scatter_adamw_launch",
                     _RS_ADAMW_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(shards.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
                 p_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(), n_src,
                 length, _DTYPES[shards.dtype], _DTYPES[p.dtype], b1,
                 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
                 *(x for x, _ in values), *ptrs, stream)
    build.check("reduce_scatter_adamw", err)
    reduce_scatter_adamw.launches += 1
    return p_out, m_out, v_out


reduce_scatter_adamw.launches = 0    # kernel launches since the last reset
