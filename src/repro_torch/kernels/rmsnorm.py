"""RMSNorm: the CUDA kernel's wrapper, its plain version, its launch count.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``repro/kernels/rmsnorm.py::rms_norm``.  ``rms_norm`` launches it for a
CUDA tensor and takes the plain PyTorch version for a CPU tensor; the
plain version is also what tests and ``chip_smoke.py`` hold the kernel
against.  The gradient is one explicit PyTorch function
(:func:`rms_norm_backward`), the same code on both devices: the JAX
package has no backward kernel either (its model differentiates the jnp
``layers.rms_norm``).

x: (T, D) float32 or bfloat16, scale: (D,) float32 -> (T, D) in x's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, scale, y, rows, D, eps, dtype, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p]


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
    (dx in x's dtype, dscale in f32)."""
    x32, g = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    gs = g * scale.float()
    dx = r * (gs - x32 * (r * r) * (gs * x32).mean(dim=-1, keepdim=True))
    dscale = (g * x32 * r).sum(dim=0)
    return dx.to(x.dtype), dscale


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and scale")
    out = torch.empty_like(x)
    fn = build.entry("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 x.shape[0], x.shape[1], eps, _DTYPES[x.dtype], stream)
    build.check("rmsnorm", err)
    rms_norm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_backward(x, scale, ctx.eps, dy)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Row-wise RMSNorm of a (T, D) tensor, differentiable in x and
    scale.  A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes :func:`rms_norm_plain`; the backward is
    :func:`rms_norm_backward` on both."""
    _check(x, scale)
    return _RMSNorm.apply(x, scale, eps)


rms_norm.launches = 0     # kernel launches since the last reset
