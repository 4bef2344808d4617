"""Selective scan (the Mamba-1 core, and Mamba-2's with one B/C group):
the CUDA kernels' wrapper, the launch geometry, the plain versions, the
launch counts.

The forward kernel (``csrc/ssm_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssm_scan.py::ssm_scan``, with an optional starting state
``h0`` and final state ``h_last`` beside it (a prefill fills the decode
cache with ``h_last``; a decode step is L = 1 from the cached state).
``ssm_scan`` launches it for CUDA tensors and takes the plain PyTorch
version for CPU tensors.  On the card the scan is a
``torch.autograd.Function``: under grad the forward also writes the
state before every 16th step, and the backward kernel (the same source;
there is no Pallas backward, the reference differentiates its
``associative_scan``) recomputes each 16-step chunk from its checkpoint
with the forward's own step and walks it back (:func:`ssm_scan_vjp`,
counted apart).  :func:`ssm_scan_backward_plain` is the reverse scan it
computes, in PyTorch; on the CPU the plain forward stays differentiable
through autograd.

:func:`ssm_scan_heads` is the per-head (Mamba-2) entry: dt (B, L, nh),
A and D (nh,).  Its forward is the same kernel on each head's values
repeated over its channels; its backward is the backward kernel's head
mode, which forms one decay a (t, head) and sums ddt, dA and dD per head
(:func:`ssm_scan_heads_vjp`, counted as ``ssm_scan_vjp``;
:func:`ssm_scan_heads_backward_plain` in PyTorch).

On the card a thread keeps ``k`` lanes of one channel's state in
registers and walks all of L inside its block, in one pass;
:func:`ssm_geometry` gives ``k`` (N, at most 4) and the warps per SM
that the launch leaves the card, :func:`ssm_bwd_geometry` the
backward's launch (lanes and channels a thread, channels a block, the
cluster).  Both depend on the shape and the card's SM count only, so
CPU tests pin them.

x, dt: (B, L, D); A: (D, N); B, C: (B, L, N); D: (D,); h0: (B, D, N)
-> y (B, L, D) in x's dtype [, h_last (B, D, N)].  x, dt, B and C are
float32 or bfloat16 (one dtype); A, D and the states are float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _plain_device, build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (1, 2, 4, 8, 16, 32, 64)     # N: a power of two <= 64
# x, dt, A, B, C, D, h0, y, h_last, hc, then batch, L, D, N, dtype, k,
# vec, stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# x, dt, A, B, C, D, hc, dy, dh_last, dx, ddt, part_bc, part_h, part_ad,
# terms, dh0, dbc, dad, then batch, L, D, N, P, cb, cl, hs, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + \
    [ctypes.c_void_p]
CKPT = 16            # steps between the forward's state checkpoints
H100_SMS = 132
CHANNELS = 32        # channels a block owns (the kernel's kChannels)
SCAN_LANES = 4       # state lanes a thread holds (N itself when N < 4)
BWD_CLUSTER = 2      # blocks a cluster of the backward, at most


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


def ssm_bwd_geometry(b: int, l: int, d: int, n: int,
                     headdim: Optional[int] = None,
                     sms: int = H100_SMS) -> dict:
    """The launch of the backward kernel for x (b, l, d), a state of n
    lanes, per head of ``headdim`` channels (else per channel), on a card
    of ``sms`` SMs, as ``csrc/ssm_scan.cu``'s ``BwdCfg`` sets it: ``k``
    lanes and ``m`` channels a thread, ``channels`` a block (32; 16 per
    channel at N >= 32; more at small N, so that a block is whole warps),
    ``threads`` a block, ``blocks`` = ceil(d / channels), ``cluster``
    blocks a cluster (:data:`BWD_CLUSTER`, fewer for fewer blocks),
    ``grid`` the blocks padded to whole clusters, ``head_slots`` the most
    heads one block touches (0 per channel), and ``fill``: the mean
    channels an SM over those of the busiest SM when the b x grid blocks
    share the SMs evenly (L runs inside each block and does not change
    it).  Whole channels a block cannot beat ceil(d b / sms) on the
    busiest SM."""
    head = headdim is not None
    k = min(n, 2)
    g = n // k
    m = 4 if head else 2
    cb = max(32 if head or n < 32 else 16, 32 * m // g)
    blocks = -(-d // cb)
    cl = min(BWD_CLUSTER, 1 << (blocks.bit_length() - 1))
    grid = -(-blocks // cl) * cl
    slots = 0
    if head:
        slots = max((min(i * cb + cb, d) - 1) // headdim
                    - i * cb // headdim + 1 for i in range(blocks))
    busiest = -(-b * grid // sms) * cb
    return {"k": k, "m": m, "channels": cb, "threads": cb // m * g,
            "blocks": blocks, "cluster": cl, "grid": grid,
            "head_slots": slots, "fill": b * d / sms / busiest}


def checkpoint_count(l: int) -> int:
    """States the forward writes under grad for L = ``l``: the one
    before every :data:`CKPT`-th step."""
    return -(-l // CKPT)


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


def ssm_scan_backward_plain(x, dt, A, B, C, D, dy, h0=None,
                            dh_last=None):
    """The VJP of :func:`ssm_scan_plain` for the upstream ``dy`` (and
    ``dh_last``, the final state's cotangent), written as the reverse
    scan the backward kernel computes, in f32: with g = dL/dh_t,

        g += C_t dy_t;   dB_t = sum_d g dt x;   dC_t = sum_d dy_t h_t
        dx = dt sum_n g B + D dy;   ddt = x sum_n g B + sum_n g h_{t-1} e A
        dA += g h_{t-1} e dt;   dD += dy x;   g *= e = exp(dt A)

    and dh0 = g at the end.  The states are the forward's, kept whole
    here.  Returns (dx, ddt, dA, dB, dC, dD, dh0) in f32 (dh0 None
    without ``h0``)."""
    bsz, length, d = x.shape
    x32, dt32, a32 = x.float(), dt.float(), A.float()
    b32, c32, dy32 = B.float(), C.float(), dy.float()
    decay = torch.exp(dt32[..., None] * a32)                  # (B,L,D,N)
    drive = (dt32 * x32)[..., None] * b32[:, :, None, :]
    h = torch.zeros((bsz, d, a32.shape[1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0.float()
    hs = [h]
    for t in range(length):
        h = decay[:, t] * h + drive[:, t]
        hs.append(h)
    g = torch.zeros_like(h) if dh_last is None else dh_last.float()
    sdx = torch.empty_like(x32)
    sdt = torch.empty_like(x32)
    dB = torch.empty_like(b32)
    dC = torch.empty_like(c32)
    dA = torch.zeros_like(a32)
    for t in range(length - 1, -1, -1):
        g = g + c32[:, t, None, :] * dy32[:, t, :, None]
        dB[:, t] = (g * (dt32[:, t] * x32[:, t])[..., None]).sum(dim=1)
        dC[:, t] = (hs[t + 1] * dy32[:, t, :, None]).sum(dim=1)
        sdx[:, t] = (g * b32[:, t, None, :]).sum(dim=-1)
        w = g * hs[t] * decay[:, t]
        sdt[:, t] = (w * a32).sum(dim=-1)
        dA = dA + (w * dt32[:, t, :, None]).sum(dim=0)
        g = g * decay[:, t]
    dx = sdx * dt32 + D.float() * dy32
    ddt = sdx * x32 + sdt
    dD = (dy32 * x32).sum(dim=(0, 1))
    return dx, ddt, dA, dB, dC, dD, (g if h0 is not None else None)


def _expand_heads(dt, A, D, headdim: int, n: int):
    """Each head's dt, A and skip D for its ``headdim`` channels: dt (B,
    L, nh) -> (B, L, nh x headdim), A (nh,) -> (nh x headdim, n), D (nh,)
    -> (nh x headdim,)."""
    return (dt.repeat_interleave(headdim, dim=-1),
            A.repeat_interleave(headdim)[:, None].expand(
                A.shape[0] * headdim, n).contiguous(),
            D.repeat_interleave(headdim))


def ssm_scan_heads_plain(x, dt, A, B, C, D, headdim: int, h0=None,
                         return_state: bool = False):
    """The per-head (Mamba-2) scan: :func:`ssm_scan_plain` on each head's
    dt, A and D repeated over its ``headdim`` channels."""
    dt_ch, a_ch, d_ch = _expand_heads(dt, A, D, headdim, B.shape[-1])
    return ssm_scan_plain(x, dt_ch, a_ch, B, C, d_ch, h0, return_state)


def ssm_scan_heads_backward_plain(x, dt, A, B, C, D, dy, headdim: int,
                                  h0=None, dh_last=None):
    """The VJP of :func:`ssm_scan_heads_plain` per head, as the backward
    kernel's head mode computes it, in f32: one decay e = exp(dt_h A_h) a
    (t, head); with g = dL/dh_t (B, nh, headdim, N) and S = sum over the
    head's (channel, lane) of g h_{t-1},

        g += C_t dy_t;   dB_t = sum_d g dt x;   dC_t = sum_d dy_t h_t
        dx = dt_h sum_n g B + D_h dy;   ddt_h = sum_d x sum_n g B + A_h e S
        dA_h += dt e S;   dD_h += sum_d dy x;   g *= e

    and dh0 = g at the end.  Returns (dx (B, L, D), ddt (B, L, nh), dA
    (nh,), dB, dC, dD (nh,), dh0) in f32 (dh0 None without ``h0``)."""
    bsz, length, d = x.shape
    n = B.shape[-1]
    nh = d // headdim
    x32 = x.float().reshape(bsz, length, nh, headdim)
    dy32 = dy.float().reshape(bsz, length, nh, headdim)
    dt32, a32 = dt.float(), A.float()
    b32, c32 = B.float(), C.float()
    e = torch.exp(dt32 * a32)                                # (B, L, nh)
    dtx = dt32[..., None] * x32                              # (B,L,nh,P)
    h = torch.zeros((bsz, nh, headdim, n), dtype=torch.float32,
                    device=x.device) if h0 is None else \
        h0.float().reshape(bsz, nh, headdim, n)
    hs = [h]
    for t in range(length):
        h = e[:, t, :, None, None] * h + \
            dtx[:, t, ..., None] * b32[:, t, None, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh_last is None else \
        dh_last.float().reshape(bsz, nh, headdim, n)
    sdx = torch.empty_like(x32)
    S = torch.empty_like(dt32)
    dB = torch.empty_like(b32)
    dC = torch.empty_like(c32)
    for t in range(length - 1, -1, -1):
        g = g + c32[:, t, None, None, :] * dy32[:, t, ..., None]
        dB[:, t] = (g * dtx[:, t, ..., None]).sum(dim=(1, 2))
        dC[:, t] = (hs[t + 1] * dy32[:, t, ..., None]).sum(dim=(1, 2))
        sdx[:, t] = (g * b32[:, t, None, None, :]).sum(dim=-1)
        S[:, t] = (g * hs[t]).sum(dim=(2, 3))
        g = g * e[:, t, :, None, None]
    dx = (sdx * dt32[..., None] + D.float()[:, None] * dy32).reshape(
        bsz, length, d)
    ddt = (sdx * x32).sum(dim=-1) + a32 * e * S
    dA = (dt32 * e * S).sum(dim=(0, 1))
    dD = (dy32 * x32).sum(dim=(0, 1, 3))
    return dx, ddt, dA, dB, dC, dD, \
        (g.reshape(bsz, d, n) if h0 is not None else None)


def _launch(x, dt, A, B, C, D, h0, return_state: bool, geo: dict,
            checkpoints: bool = False):
    """One launch of the forward kernel with the launch ``geo`` (an
    :func:`ssm_geometry`), for :func:`ssm_scan` and the card tests.
    Counts nothing.  Returns y [, h_last]; with ``checkpoints`` (y,
    h_last or None, hc), hc the state before every :data:`CKPT`-th step,
    (B, ceil(L / CKPT), D, N) f32, what the backward kernel starts its
    chunks from."""
    bsz, length, d = x.shape
    n = A.shape[1]
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    h_last = torch.empty((bsz, d, n), **f32) if return_state else None
    hc = torch.empty((bsz, checkpoint_count(length), d, n), **f32) \
        if checkpoints else None
    item = x.element_size()
    vec = (d * item) % 16 == 0 and (length * n * item) % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in (x, dt, B, C))
    fn = build.entry("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in
                   (x, dt, A, B, C, D, h0, y, h_last, hc)),
                 bsz, length, d, n, _DTYPES[x.dtype], geo["k"], int(vec),
                 stream)
    build.check("ssm_scan", err)
    if checkpoints:
        return y, h_last, hc
    return (y, h_last) if return_state else y


def _backward_launch(x, dt, A, B, C, D, hc, dy, dh_last, want_dh0: bool,
                     geo: dict, headdim: Optional[int] = None):
    """One launch of the backward (the scan kernel, then its two
    fixed-order sums) with the launch ``geo`` (an :func:`ssm_bwd_geometry`),
    f32 inputs, per head of ``headdim`` channels (dt (B, L, nh), A and D
    (nh,)) or per channel; for :func:`ssm_scan_vjp`,
    :func:`ssm_scan_heads_vjp` and the card tests.  Counts nothing.
    Returns (dx, ddt, dA, dB, dC, dD, dh0 or None), ddt, dA and dD per
    head or per channel."""
    bsz, length, d = x.shape
    n = B.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    ncl = geo["grid"] // geo["cluster"]
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    part_bc = torch.empty((bsz, ncl, length, 2 * n), **f32)
    part_h = terms = part_ad = None
    if headdim is not None:
        nh = d // headdim
        part_h = torch.empty((bsz, length, geo["blocks"],
                              geo["head_slots"], 3), **f32)
        terms = torch.empty((bsz * length, 2 * nh), **f32)
        dad = torch.empty((2 * nh,), **f32)
    else:
        part_ad = torch.empty((bsz, d * n + d), **f32)
        dad = torch.empty((d * n + d,), **f32)
    dh0 = torch.empty((bsz, d, n), **f32) if want_dh0 else None
    dbc = torch.empty((bsz, length, 2 * n), **f32)
    fn = build.entry("ssm_scan", "ssm_scan_backward_launch", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in
                   (x, dt, A, B, C, D, hc, dy, dh_last, dx, ddt, part_bc,
                    part_h, part_ad, terms, dh0, dbc, dad)),
                 bsz, length, d, n, headdim or 0, geo["channels"],
                 geo["cluster"], geo["head_slots"], stream)
    build.check("ssm_scan", err)
    if headdim is not None:
        dA, dD = dad[:nh], dad[nh:]
    else:
        dA, dD = dad[:d * n].view(d, n), dad[d * n:]
    return dx, ddt, dA, dbc[..., :n], dbc[..., n:], dD, dh0


def _bwd_geometry_of(x, n: int, headdim: Optional[int] = None) -> dict:
    bsz, length, d = x.shape
    return ssm_bwd_geometry(bsz, length, d, n, headdim,
                            torch.cuda.get_device_properties(
                                x.device).multi_processor_count)


def _geometry_of(x, n: int) -> dict:
    bsz, length, d = x.shape
    return ssm_geometry(bsz, length, d, n, torch.cuda.get_device_properties(
        x.device).multi_processor_count)


def ssm_scan_vjp(x, dt, A, B, C, D, hc, dy, h0=None, dh_last=None):
    """(dx, ddt, dA, dB, dC, dD, dh0) of :func:`ssm_scan` for ``dy``
    (and ``dh_last``), each grad in its input's dtype (dh0 None without
    ``h0``).  CUDA tensors launch the backward kernel from the forward's
    checkpoints ``hc`` (or raise); CPU tensors take
    :func:`ssm_scan_backward_plain`, which needs no checkpoints."""
    dtype = x.dtype
    if _plain_device(x):
        out = ssm_scan_backward_plain(x, dt, A, B, C, D, dy, h0, dh_last)
        return tuple(None if g is None else
                     g.to(dtype) if i in (0, 1, 3, 4) else g
                     for i, g in enumerate(out))
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_vjp runs on cuda or cpu, not "
                         f"{x.device}")
    f = [t.float().contiguous() for t in (x, dt, B, C, dy)]
    dh = None if dh_last is None else dh_last.float().contiguous()
    out = _backward_launch(f[0], f[1], A, f[2], f[3], D, hc, f[4], dh,
                           h0 is not None, _bwd_geometry_of(x, A.shape[1]))
    ssm_scan_vjp.launches += 1
    dx, ddt, dA, dB, dC, dD, dh0 = out
    return (dx.to(dtype), ddt.to(dtype), dA, dB.to(dtype), dC.to(dtype),
            dD, dh0)


class _Scan(torch.autograd.Function):
    """The forward kernel with checkpoints, and the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0):
        y, h_last, hc = _launch(x, dt, A, B, C, D, h0, True,
                                _geometry_of(x, A.shape[1]),
                                checkpoints=True)
        ssm_scan.launches += 1
        ctx.save_for_backward(x, dt, A, B, C, D, h0, hc)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, A, B, C, D, h0, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssm_scan_vjp(x, dt, A, B, C, D, hc, dy, h0, dh_last)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad))


class _MetaScan(torch.autograd.Function):
    """The scan of meta tensors (the dry-run's trace): the outputs, and
    in the backward the inputs' grads, as shapes only.  The plain
    versions step through L in Python (the reference's sequential scan),
    a few ms a step on the meta device: hours for one training step of
    an SSM model at its real sequence length."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, headdim):
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        return (torch.empty_like(x),
                x.new_empty((x.shape[0], x.shape[2], B.shape[-1]),
                            dtype=torch.float32))

    @staticmethod
    def backward(ctx, dy, dh_last):
        return tuple(torch.empty_like(t) if need else None
                     for t, need in zip(ctx.saved_tensors,
                                        ctx.needs_input_grad)) + (None,)


def _meta_scan(x, dt, A, B, C, D, h0, headdim, return_state):
    y, h_last = _MetaScan.apply(x, dt, A, B, C, D, h0, headdim)
    return (y, h_last) if return_state else y


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """Selective scan of ``x`` along L (see the module docstring),
    differentiable in every input.  CUDA tensors launch the kernel (or
    raise), and under grad the backward kernel in the backward; CPU
    tensors take :func:`ssm_scan_plain`; meta tensors its shapes only
    (:class:`_MetaScan`)."""
    _check(x, dt, A, B, C, D, h0)
    if x.device.type == "meta":
        return _meta_scan(x, dt, A, B, C, D, h0, None, return_state)
    if _plain_device(x):
        return ssm_scan_plain(x, dt, A, B, C, D, h0, return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {x.device}")
    inputs = [t for t in (x, dt, A, B, C, D, h0) if t is not None]
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("ssm_scan kernel needs contiguous inputs")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        y, h_last = _Scan.apply(x, dt, A, B, C, D, h0)
        return (y, h_last) if return_state else y
    out = _launch(x, dt, A, B, C, D, h0, return_state,
                  _geometry_of(x, A.shape[1]))
    ssm_scan.launches += 1
    return out


def _check_heads(x, dt, A, B, C, D, headdim, h0) -> None:
    if x.dim() != 3 or dt.dim() != 3 or A.dim() != 1:
        raise ValueError(f"ssm_scan_heads wants x (B, L, D), dt (B, L, nh) "
                         f"and A (nh,), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    bsz, length, d = x.shape
    nh = A.shape[0]
    if headdim < 1 or nh * headdim != d or dt.shape != (bsz, length, nh) \
            or D.shape != (nh,):
        raise ValueError(f"ssm_scan_heads shapes disagree: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)}, headdim "
                         f"{headdim}")
    n = B.shape[-1]
    _check(x, x, A.new_empty((d, n)), B, C, D.new_empty((d,)), h0)
    if dt.dtype != x.dtype or A.dtype != torch.float32 \
            or D.dtype != torch.float32:
        raise TypeError("ssm_scan_heads takes dt in x's dtype, A and D in "
                        "float32")
    if any(t.device != x.device for t in (dt, A, D)):
        raise ValueError("ssm_scan_heads' inputs must be on one device")


def ssm_scan_heads_vjp(x, dt, A, B, C, D, hc, dy, headdim: int, h0=None,
                       dh_last=None):
    """(dx, ddt, dA, dB, dC, dD, dh0) of :func:`ssm_scan_heads` for
    ``dy`` (and ``dh_last``): ddt (B, L, nh), dA and dD (nh,) per head,
    each grad in its input's dtype (dh0 None without ``h0``).  CUDA
    tensors launch the backward kernel in its head mode from the forward's
    checkpoints ``hc`` (or raise); CPU tensors take
    :func:`ssm_scan_heads_backward_plain`."""
    dtype = x.dtype
    if _plain_device(x):
        out = ssm_scan_heads_backward_plain(x, dt, A, B, C, D, dy, headdim,
                                            h0, dh_last)
    elif x.device.type == "cuda":
        f = [t.float().contiguous() for t in (x, dt, B, C, dy)]
        dh = None if dh_last is None else dh_last.float().contiguous()
        out = _backward_launch(f[0], f[1], A, f[2], f[3], D, hc, f[4], dh,
                               h0 is not None,
                               _bwd_geometry_of(x, B.shape[-1], headdim),
                               headdim)
        ssm_scan_vjp.launches += 1
    else:
        raise ValueError(f"ssm_scan_heads_vjp runs on cuda or cpu, not "
                         f"{x.device}")
    return tuple(None if g is None else
                 g.to(dtype) if i in (0, 1, 3, 4) else g
                 for i, g in enumerate(out))


class _HeadScan(torch.autograd.Function):
    """The forward kernel on the heads' values repeated per channel, with
    checkpoints; the backward kernel in its head mode."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, headdim):
        dt_ch, a_ch, d_ch = _expand_heads(dt, A, D, headdim, B.shape[-1])
        y, h_last, hc = _launch(x, dt_ch, a_ch, B, C, d_ch, h0, True,
                                _geometry_of(x, B.shape[-1]),
                                checkpoints=True)
        ssm_scan.launches += 1
        ctx.headdim = headdim
        ctx.save_for_backward(x, dt, A, B, C, D, h0, hc)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, A, B, C, D, h0, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssm_scan_heads_vjp(x, dt, A, B, C, D, hc, dy, ctx.headdim,
                                   h0, dh_last)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def ssm_scan_heads(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   headdim: int, h0: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """The per-head (Mamba-2, one B/C group) scan: x (B, L, nh x
    headdim), dt (B, L, nh), A and D (nh,), B, C and h0 as for
    :func:`ssm_scan`; it computes :func:`ssm_scan` on each head's dt, A
    and D repeated over its channels.  CUDA tensors launch the forward
    kernel on the repeated values (its bits and launch count are
    :func:`ssm_scan`'s) and under grad the backward kernel in its head
    mode, which forms one decay a (t, head) and returns ddt, dA and dD per
    head; CPU tensors take :func:`ssm_scan_heads_plain`, differentiated by
    autograd; meta tensors its shapes only (:class:`_MetaScan`)."""
    _check_heads(x, dt, A, B, C, D, headdim, h0)
    if x.device.type == "meta":
        return _meta_scan(x, dt, A, B, C, D, h0, headdim, return_state)
    if _plain_device(x):
        return ssm_scan_heads_plain(x, dt, A, B, C, D, headdim, h0,
                                    return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_heads runs on cuda or cpu, not "
                         f"{x.device}")
    inputs = [t for t in (x, dt, A, B, C, D, h0) if t is not None]
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("ssm_scan_heads kernel needs contiguous inputs")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        y, h_last = _HeadScan.apply(x, dt, A, B, C, D, h0, headdim)
        return (y, h_last) if return_state else y
    dt_ch, a_ch, d_ch = _expand_heads(dt, A, D, headdim, B.shape[-1])
    out = _launch(x, dt_ch, a_ch, B, C, d_ch, h0, return_state,
                  _geometry_of(x, B.shape[-1]))
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0        # forward kernel launches since the last reset
# backward launches (one per backward, both modes)
ssm_scan_vjp.launches = 0
