"""Selective scan (Mamba-1): the CUDA kernel's wrapper, its launch
geometry, its plain version, its launch count.

The kernel (``csrc/ssm_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssm_scan.py::ssm_scan``, with an optional starting state
``h0`` and final state ``h_last`` beside it (a prefill fills the decode
cache with ``h_last``; a decode step is L = 1 from the cached state).
``ssm_scan`` launches it for CUDA tensors and takes the plain PyTorch
version for CPU tensors.  The kernel has no backward yet (ROADMAP
queue 2, item 7b): on the card the wrapper refuses inputs that need a
gradient rather than return an output without autograd history; the
plain version on the CPU stays differentiable.

On the card a thread keeps ``k`` lanes of one channel's state in
registers and walks all of L inside its block, in one pass;
:func:`ssm_geometry` gives ``k`` (N, at most 4) and the warps per SM
that the launch leaves the card.  It depends on the shape and the
card's SM count only, so CPU tests pin it.

x, dt: (B, L, D); A: (D, N); B, C: (B, L, N); D: (D,); h0: (B, D, N)
-> y (B, L, D) in x's dtype [, h_last (B, D, N)].  x, dt, B and C are
float32 or bfloat16 (one dtype); A, D and the states are float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (1, 2, 4, 8, 16, 32)     # N: a power of two <= 32
# x, dt, A, B, C, D, h0, y, h_last, then batch, L, D, N, dtype, k, vec,
# stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
H100_SMS = 132
CHANNELS = 32        # channels a block owns (the kernel's kChannels)
SCAN_LANES = 4       # state lanes a thread holds (N itself when N < 4)


def ssm_geometry(b: int, l: int, d: int, n: int,
                 sms: int = H100_SMS) -> dict:
    """The launch :func:`ssm_scan` takes for x (b, l, d) and a state of
    n lanes on a card of ``sms`` SMs: ``k``, the lanes a thread holds
    (:data:`SCAN_LANES`, N when N is smaller), and ``warps_per_sm``, the
    warps its grid of ceil(d / 32) x b blocks gives each SM (L runs
    inside each block, so ``l`` does not change it)."""
    k = min(n, SCAN_LANES)
    warps = b * -(-d // CHANNELS) * (CHANNELS * n // k) / 32
    return {"k": k, "warps_per_sm": warps / sms}


def ssm_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """``ssm_scan_ref`` of the JAX package (sequential, f32 state), from
    ``h0`` instead of zero when given; ``return_state`` also returns the
    final state."""
    bsz, length, d = x.shape
    x32, dt32 = x.float(), dt.float()
    decay = torch.exp(dt32[..., None] * A.float()[None, None])  # (B,L,D,N)
    drive = (dt32 * x32)[..., None] * B.float()[:, :, None, :]
    c32 = C.float()
    h = (torch.zeros((bsz, d, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(length):
        h = decay[:, t] * h + drive[:, t]
        ys.append((h * c32[:, t, None, :]).sum(dim=-1))
    y = (torch.stack(ys, dim=1) + D.float() * x32).to(x.dtype)
    return (y, h) if return_state else y


def _check(x, dt, A, B, C, D, h0) -> None:
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2:
        raise ValueError(f"ssm_scan wants x, dt (B, L, D) and A (D, N), "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    bsz, length, d = x.shape
    n = A.shape[1]
    if A.shape[0] != d or B.shape != (bsz, length, n) \
            or C.shape != B.shape or D.shape != (d,) \
            or (h0 is not None and h0.shape != (bsz, d, n)):
        raise ValueError(f"ssm_scan shapes disagree: x {tuple(x.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, D {tuple(D.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if length < 1:
        raise ValueError("ssm_scan needs L >= 1")
    if n not in STATE_SIZES:
        raise ValueError(f"ssm_scan takes a state size N in {STATE_SIZES},"
                         f" got {n}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"ssm_scan takes x, dt, B, C in one of float32/"
                        f"bfloat16, got {x.dtype}, {dt.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    floats = [A, D] + ([h0] if h0 is not None else [])
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("ssm_scan takes A, D and h0 in float32")
    if any(t.device != x.device for t in [dt, B, C] + floats):
        raise ValueError("ssm_scan's inputs must be on one device")


def _launch(x, dt, A, B, C, D, h0, return_state: bool, geo: dict):
    """One launch of the kernel with the launch ``geo`` (an
    :func:`ssm_geometry`), for :func:`ssm_scan` and the card tests.
    Counts nothing."""
    bsz, length, d = x.shape
    n = A.shape[1]
    y = torch.empty_like(x)
    h_last = (torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
              if return_state else None)
    item = x.element_size()
    vec = (d * item) % 16 == 0 and (length * n * item) % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in (x, dt, B, C))
    fn = build.entry("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in
                   (x, dt, A, B, C, D, h0, y, h_last)),
                 bsz, length, d, n, _DTYPES[x.dtype], geo["k"], int(vec),
                 stream)
    build.check("ssm_scan", err)
    return (y, h_last) if return_state else y


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """Selective scan of ``x`` along L (see the module docstring).  CUDA
    tensors launch the kernel (or raise); CPU tensors take
    :func:`ssm_scan_plain`."""
    _check(x, dt, A, B, C, D, h0)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B, C, D, h0, return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {x.device}")
    inputs = [t for t in (x, dt, A, B, C, D, h0) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            "the ssm_scan kernel has no backward yet (ROADMAP queue 2, "
            "item 7b: training SSM rows on the card waits for a "
            "reverse-scan kernel)")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("ssm_scan kernel needs contiguous inputs")
    bsz, length, d = x.shape
    geo = ssm_geometry(bsz, length, d, A.shape[1], torch.cuda.
                       get_device_properties(x.device).multi_processor_count)
    out = _launch(x, dt, A, B, C, D, h0, return_state, geo)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0    # kernel launches since the last reset
