"""RMSNorm: the CUDA kernels' wrappers, their launch geometry, their plain
versions, their launch counts.

The forward kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``repro/kernels/rmsnorm.py::rms_norm``.  The backward kernel beside it
computes the VJP that the JAX package takes by differentiating the jnp
``layers.rms_norm`` (it has no backward kernel): dx and dscale from x and
the upstream gradient in one pass over the rows, then a second small
launch that sums the per-block dscale partials in a fixed order.

``rms_norm`` is differentiable in x and scale.  For a CUDA tensor its
forward launches the forward kernel and its backward
(:func:`rms_norm_vjp`) the backward kernel, or they raise; for a CPU
tensor they take the plain versions, :func:`rms_norm_plain` and
:func:`rms_norm_backward`, which are also what the tests and
``chip_smoke.py`` hold the kernels against.  :func:`rms_geometry` gives
both kernels' launch (the threads per row, the rows per block, the grid)
from the shape and the card's SM count only, so CPU tests pin it.

x: (T, D) float32 or bfloat16, scale: (D,) float32 -> (T, D) in x's dtype;
the gradients: dx in x's dtype, dscale in float32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _plain_device, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, scale, y, rows, D, eps, dtype, vec, v, tpr, rows_per_block, grid,
# stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float] \
    + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# x, dy, scale, dx, part, dscale, rows, D, eps, dtype, vec, v, tpr, grid,
# stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float] \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]
H100_SMS = 132
VEC_COUNTS = (1, 2, 4, 8, 16)   # 16-byte vectors a thread holds (compiled)
# elements a thread holds by preference: few enough that every row of a
# prefill is resident at once (on the H100, 32 or 64 elements a forward
# thread ran slower at T = 1024); a backward thread also holds dy, the
# next row's x and dy and the dscale sums, so it takes fewer
FWD_ELEMS, BWD_ELEMS = 16, 8
BLOCK_THREADS = 256        # a forward block's threads (rows x threads/row)
SPREAD_WARPS = 4           # forward warps per SM below which rows spread
BWD_THREADS_PER_SM = 512   # the backward's grid: this many threads an SM


def _max_threads(elems: int) -> int:
    """The kernel's launch bound for a thread of ``elems`` elements."""
    return 512 if elems <= 16 else 256


def rms_geometry(rows: int, d: int, itemsize: int, sms: int = H100_SMS,
                 backward: bool = False, aligned: bool = True) -> dict:
    """The launch of the forward (or ``backward``) kernel for x (rows, d)
    of ``itemsize`` bytes on a card of ``sms`` SMs.

    ``vec``: elements in a thread's vector (16 bytes; 1 when a row or a
    base is not 16-byte aligned).  ``tpr``: threads per row, the fewest
    (a power of two, at least a warp) with which a thread holds at most
    ``FWD_ELEMS`` / ``BWD_ELEMS`` elements; a forward grid under
    ``SPREAD_WARPS`` warps per SM spreads each row over twice as many
    threads while a thread holds more than one vector.  ``v``: vectors a
    thread holds (a count in :data:`VEC_COUNTS`; columns past d are
    predicated off).  Forward: ``rows_per_block`` rows a block of
    ``threads`` = tpr x rows_per_block, ``grid`` = ceil(rows /
    rows_per_block).  Backward: a block is one row of tpr threads that
    walks ``rows_per_block`` (at most) rows of a grid-stride loop; the
    ``grid`` gives each SM ``BWD_THREADS_PER_SM`` threads and sizes the
    (grid, d) scratch of dscale partials.  Raises ValueError for a row
    wider than the kernel holds."""
    vec = 16 // itemsize if aligned and d * itemsize % 16 == 0 else 1
    nvec = -(-d // vec)
    cap = min(VEC_COUNTS[-1], max(1, (BWD_ELEMS if backward else FWD_ELEMS)
                                  // vec))

    def count(tpr):     # the compiled count that covers nvec at tpr
        return next((c for c in VEC_COUNTS if c * tpr >= nvec), None)

    tpr = 32
    while tpr < 512 and -(-nvec // tpr) > cap:
        tpr *= 2
    v = count(tpr)
    if v is None or tpr > _max_threads(v * vec):
        raise ValueError(f"rms_norm kernel cannot hold a row of {d} "
                         f"columns ({'backward' if backward else 'forward'})")
    while not backward and v > 1 and rows * tpr < SPREAD_WARPS * 32 * sms \
            and 2 * tpr <= _max_threads(count(2 * tpr) * vec):
        tpr *= 2
        v = count(tpr)
    if backward:
        grid = max(1, min(rows, sms * max(1, BWD_THREADS_PER_SM // tpr)))
        return {"vec": vec, "v": v, "tpr": tpr, "threads": tpr,
                "rows_per_block": -(-rows // grid), "grid": grid}
    rpb = max(1, BLOCK_THREADS // tpr)
    return {"vec": vec, "v": v, "tpr": tpr, "threads": tpr * rpb,
            "rows_per_block": rpb, "grid": max(1, -(-rows // rpb))}


# the wrappers' copy: the pure function costs microseconds of Python a
# call, and a decode step (host-bound) norms 65 times; callers only read
# the shared dict
_geometry = functools.lru_cache(maxsize=256)(rms_geometry)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """``layers.rms_norm`` of the JAX package, in PyTorch: f32 math,
    result in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() != 2 or scale.dim() != 1 or scale.shape[0] != x.shape[1]:
        raise ValueError(f"rms_norm wants x (T, D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPES or scale.dtype != torch.float32:
        raise TypeError(f"rms_norm takes float32/bfloat16 x and float32 "
                        f"scale, got {x.dtype} and {scale.dtype}")
    if x.device != scale.device:
        raise ValueError("x and scale must be on one device")


def rms_norm_backward(x: torch.Tensor, scale: torch.Tensor, eps: float,
                      dy: torch.Tensor):
    """VJP of ``y = x * rsqrt(mean(x^2) + eps) * scale`` in f32: returns
    (dx in x's dtype, dscale in f32).  The plain version of the backward
    kernel."""
    x32, g = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    gs = g * scale.float()
    dx = r * (gs - x32 * (r * r) * (gs * x32).mean(dim=-1, keepdim=True))
    dscale = (g * x32 * r).sum(dim=0)
    return dx.to(x.dtype), dscale


def _on_card(x: torch.Tensor, scale: torch.Tensor, *others) -> tuple:
    """(the card's SM count, whether every base is 16-byte aligned) for
    CUDA tensors; raises for another device or a non-contiguous one."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in (x, scale, *others)):
        raise ValueError("rms_norm kernel needs contiguous x and scale")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, *others))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return sms, aligned


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if _plain_device(x):
        return rms_norm_plain(x, scale, eps)
    sms, aligned = _on_card(x, scale)
    geo = _geometry(x.shape[0], x.shape[1], x.element_size(), sms, False,
                    aligned)
    out = torch.empty_like(x)
    fn = build.entry("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 x.shape[0], x.shape[1], eps, _DTYPES[x.dtype],
                 int(geo["vec"] > 1), geo["v"], geo["tpr"],
                 geo["rows_per_block"], geo["grid"], stream)
    build.check("rmsnorm", err)
    rms_norm.launches += 1
    return out


def rms_norm_vjp(x: torch.Tensor, scale: torch.Tensor, eps: float,
                 dy: torch.Tensor, need_dx: bool = True,
                 need_dscale: bool = True):
    """(dx, dscale) of :func:`rms_norm` for the upstream gradient ``dy``,
    None where not needed.  CUDA tensors launch the backward kernel (or
    raise); CPU tensors take :func:`rms_norm_backward`."""
    _check(x, scale)
    if dy.shape != x.shape:
        raise ValueError(f"rms_norm_vjp: dy {tuple(dy.shape)} is not x's "
                         f"shape {tuple(x.shape)}")
    if _plain_device(x):
        dx, dscale = rms_norm_backward(x, scale, eps, dy)
        return dx if need_dx else None, dscale if need_dscale else None
    # autograd may hand an expanded (stride 0) or other-dtype gradient
    dy = dy.to(x.dtype).contiguous()
    sms, aligned = _on_card(x, scale, dy)
    rows, d = x.shape
    geo = _geometry(rows, d, x.element_size(), sms, True, aligned)
    dx = torch.empty_like(x) if need_dx else None
    part = dscale = None
    if need_dscale:
        part = torch.empty((geo["grid"], d), dtype=torch.float32,
                           device=x.device)
        dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    fn = build.entry("rmsnorm", "rmsnorm_backward_launch", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in
                   (x, dy, scale, dx, part, dscale)),
                 rows, d, eps, _DTYPES[x.dtype], int(geo["vec"] > 1),
                 geo["v"], geo["tpr"], geo["grid"], stream)
    build.check("rmsnorm", err)
    rms_norm_vjp.launches += 1
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        need_dx, need_dscale = ctx.needs_input_grad[:2]
        dx, dscale = rms_norm_vjp(x, scale, ctx.eps, dy, need_dx,
                                  need_dscale)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Row-wise RMSNorm of a (T, D) tensor, differentiable in x and
    scale.  A CUDA tensor launches the forward kernel and, in the
    backward, the backward kernel (or raises); a CPU tensor takes
    :func:`rms_norm_plain` and :func:`rms_norm_backward`."""
    _check(x, scale)
    return _RMSNorm.apply(x, scale, eps)


rms_norm.launches = 0         # forward kernel launches since the last reset
rms_norm_vjp.launches = 0     # backward kernel launches (one per backward)
