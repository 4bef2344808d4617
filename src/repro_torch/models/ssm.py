"""Mamba-1 (S6 selective scan) and Mamba-2 (SSD, scalar A per head)
blocks.

Port of ``repro/models/ssm.py``, channel-parallel over the model axis
as the reference: ``d_inner`` (Mamba-2: its heads) is sharded, the scan
is independent per channel, Mamba-1's ``x_proj`` and both blocks'
``out_proj`` are row-parallel matmuls summed by ``pc.tp_all_reduce``
(``src/repro/models/ssm.py:121, 138, 220``), and Mamba-2's B/C
projection and its conv are replicated.  One place differs on purpose:
at tp > 1 the reference's Mamba-2 gated norm reduces over the rank's
d_inner / tp channels only (``src/repro/models/ssm.py:219``), so its
sharded row is another function than its unsharded one; the port's
gated norm sums its squares over the model axis first
(:func:`gated_norm`), so a row computes the same function at every tp.
The projections are plain ``torch.matmul``; the recurrence
goes through the hand-written ``ssm_scan`` kernel
(``kernels/ssm_scan.py``), in prefill, decode and training (its
backward kernel), where the reference evaluates the same contraction
with ``associative_scan`` and an einsum with C.  The kernel starts from
the cached state and returns the final one, so a decode step is the
same call at L = 1.

Mamba-2 with one B/C group is the Mamba-1 contraction over the D = nh x
headdim channels of ``x``: a channel takes the dt, A and skip D of its
head, and the state (B, nh, headdim, N) is a view of the kernel's (B,
nh x headdim, N).  ``ssm_scan_heads`` takes dt, A and D per head.  Its
forward repeats them over the head's channels and runs the scan kernel,
which forms the decay exp(dt_h A_h), the reference's per-head product of
the same two f32 numbers, per (channel, lane): headdim x N times over
(ROADMAP queue 2).  Its backward kernel forms it once a (t, head) and
returns ddt, dA and dD per head.  Routing through the kernels keeps the
reference's (B, L, nh, headdim, N) states out of memory.

Decode state per row: Mamba-1 (conv_state (B, d_conv - 1, d_inner),
ssm_state (B, d_inner, d_state) f32); Mamba-2 (conv_x (B, d_conv - 1,
d_inner), conv_bc (B, d_conv - 1, 2 d_state) f32, ssm (B, nh, headdim,
d_state) f32).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_heads
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext

Params = dict


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None):
    """h_t = a_t * h_{t-1} + b_t along axis 1 (seq), step by step.
    Returns all h_t and the final state."""
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    hs = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    h_all = torch.stack(hs, dim=1)
    return h_all, h_all[:, -1]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, L, C); w: (C, K).  ``state`` is the
    trailing K-1 inputs from the previous segment (decode).  Returns
    (y, new_state).  The shifted-window sum over K, as the reference
    writes it: ``F.conv1d`` would take cuDNN's TF32 path on the card."""
    b, l, c = x.shape
    k = w.shape[-1]
    if state is None:
        state = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)       # (B, L+K-1, C)
    y = xp[:, 0:l] * w[:, 0]
    for j in range(1, k):
        y = y + xp[:, j:j + l] * w[:, j]
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def init_mamba1(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype,
                device, layers_: int = 1) -> Params:
    """GLOBAL shapes with a leading ``layers_`` axis; ``in_proj`` is
    stored as separate x/z tensors, as in the reference."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    r = _dt_rank(cfg)
    lead = (layers_,)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, s.d_state + 1, **f32))
    return {
        "in_x": layers._dense_init(gen, lead + (cfg.d_model, d_in),
                                   cfg.d_model, dtype, device),
        "in_z": layers._dense_init(gen, lead + (cfg.d_model, d_in),
                                   cfg.d_model, dtype, device),
        "conv_w": torch.randn(lead + (d_in, s.d_conv), generator=gen,
                              device=device).div_(math.sqrt(s.d_conv))
        .to(dtype),
        "x_proj": layers._dense_init(gen, lead + (d_in, r + 2 * s.d_state),
                                     d_in, dtype, device),
        "dt_proj": layers._dense_init(gen, lead + (r, d_in), r, dtype,
                                      device),
        "dt_bias": torch.zeros(lead + (d_in,), **f32),
        "A_log": a_log.expand(lead + (d_in, s.d_state)).clone(),
        "D": torch.ones(lead + (d_in,), **f32),
        "out_proj": layers._dense_init(gen, lead + (d_in, cfg.d_model),
                                       d_in, dtype, device),
    }


def mamba1_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   pc: ParallelContext, state: Optional[tuple] = None,
                   return_state: bool = False):
    """x: (B, L, d_model).  state: (conv_state, ssm_state) for decode
    continuation.  The scan runs in f32 on f32 copies of its inputs, as
    the reference upcasts them.  Port of ``src/repro/models/ssm.py:
    105-141``: at tp > 1 ``x_proj`` is row-parallel, its partial
    products summed over the model axis (:121), so B, C and dt see the
    whole d_inner and the sharded row is the unsharded one."""
    s = cfg.ssm
    r = _dt_rank(cfg)
    xin = x @ params["in_x"]                              # (B, L, d_in)
    z = x @ params["in_z"]
    conv_state = state[0] if state is not None else None
    xc, new_conv = causal_conv1d(xin, params["conv_w"], conv_state)
    xc = F.silu(xc)

    proj = pc.tp_all_reduce(xc @ params["x_proj"])        # (B, L, r+2N)
    dt_in, b_mat, c_mat = torch.split(proj, [r, s.d_state, s.d_state],
                                      dim=-1)
    # F.softplus returns its input above 20, where jax.nn.softplus is
    # exact; the two agree within f32 rounding there.
    dt = F.softplus(dt_in @ params["dt_proj"] + params["dt_bias"])

    A = -torch.exp(params["A_log"])                       # (d_in, N)
    h0 = state[1] if state is not None else None
    y, h_last = ssm_scan(xc.float(), dt.float(), A,
                         b_mat.float().contiguous(),
                         c_mat.float().contiguous(), params["D"],
                         h0=h0, return_state=True)
    y = y.to(x.dtype) * F.silu(z)
    out = pc.tp_all_reduce(y @ params["out_proj"])
    if return_state:
        return out, (new_conv, h_last)
    return out


def mamba1_decode(params: Params, x: torch.Tensor, state: tuple,
                  cfg: ModelConfig, pc: ParallelContext):
    """Single-token decode; x: (B, 1, d_model)."""
    return mamba1_forward(params, x, cfg, pc, state=state,
                          return_state=True)


# ----------------------------------------------------------------------- #
# Mamba-2 (SSD, scalar A per head)
# ----------------------------------------------------------------------- #

def init_mamba2(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype,
                device, layers_: int = 1) -> Params:
    """GLOBAL shapes with a leading ``layers_`` axis, the reference's
    leaves: x/z/dt projections, the replicated B/C projection and its
    f32 conv, per-head A_log and D, the gated norm's scale."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.headdim
    lead = (layers_,)
    f32 = dict(dtype=torch.float32, device=device)

    def conv(width):
        return torch.randn(lead + (width, s.d_conv), generator=gen,
                           device=device).div_(math.sqrt(s.d_conv))

    return {
        "in_x": layers._dense_init(gen, lead + (cfg.d_model, d_in),
                                   cfg.d_model, dtype, device),
        "in_z": layers._dense_init(gen, lead + (cfg.d_model, d_in),
                                   cfg.d_model, dtype, device),
        "in_bc": layers._dense_init(gen, lead + (cfg.d_model,
                                                 2 * s.d_state),
                                    cfg.d_model, dtype, device),
        "in_dt": layers._dense_init(gen, lead + (cfg.d_model, nh),
                                    cfg.d_model, dtype, device),
        "conv_x": conv(d_in).to(dtype),
        "conv_bc": conv(2 * s.d_state),
        "A_log": torch.zeros(lead + (nh,), **f32),
        "D": torch.ones(lead + (nh,), **f32),
        "norm": torch.ones(lead + (d_in,), **f32),
        "out_proj": layers._dense_init(gen, lead + (d_in, cfg.d_model),
                                       d_in, dtype, device),
    }


def mamba2_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   pc: ParallelContext, state: Optional[tuple] = None,
                   return_state: bool = False):
    """x: (B, L, d_model).  state: (conv_x, conv_bc, ssm) for decode
    continuation.  The scan runs in f32 through ``ssm_scan_heads``, dt,
    A and D per head (see the module docstring); the gated norm
    ``rms_norm(y * silu(z), norm)`` spans the whole d_inner at every tp
    (:func:`gated_norm`).  Port of ``src/repro/models/ssm.py:184-224``."""
    s = cfg.ssm
    b, l, _ = x.shape
    d_loc = params["out_proj"].shape[0]
    nh = d_loc // s.headdim
    xin = x @ params["in_x"]
    z = x @ params["in_z"]
    bc = (x @ params["in_bc"]).float()
    dt = x @ params["in_dt"]
    cs_x = state[0] if state is not None else None
    cs_bc = state[1] if state is not None else None
    xconv, new_conv_x = causal_conv1d(xin, params["conv_x"], cs_x)
    bcconv, new_conv_bc = causal_conv1d(bc, params["conv_bc"], cs_bc)
    xin = F.silu(xconv)
    b_mat, c_mat = torch.split(F.silu(bcconv), s.d_state, dim=-1)

    dt = F.softplus(dt.float())                           # (B, L, nh)
    A = -torch.exp(params["A_log"])                       # (nh,)
    h0 = state[2].reshape(b, d_loc, s.d_state) if state is not None \
        else None
    y, h_last = ssm_scan_heads(xin.float().contiguous(), dt, A,
                               b_mat.contiguous(), c_mat.contiguous(),
                               params["D"], s.headdim, h0=h0,
                               return_state=True)
    y = gated_norm(y.to(x.dtype) * F.silu(z), params["norm"],
                   s.expand * cfg.d_model, cfg.norm_eps, pc)
    out = pc.tp_all_reduce(y @ params["out_proj"])
    if return_state:
        return out, (new_conv_x, new_conv_bc,
                     h_last.reshape(b, nh, s.headdim, s.d_state))
    return out


def gated_norm(g: torch.Tensor, scale: torch.Tensor, d_inner: int,
               eps: float, pc: ParallelContext) -> torch.Tensor:
    """RMSNorm of the gated output ``g`` = y * silu(z) (B, L, d_loc)
    over the WHOLE d_inner, whatever the tp.  At tp = 1 the RMSNorm
    kernel's (``layers.rms_norm``).  At tp > 1, where a rank holds
    d_loc = d_inner / tp channels: the local sum of squares (B, L) in
    f32, summed over the model axis by ``pc.tp_all_reduce`` (through
    the ``Communicator``; its autograd transpose sums the cotangent
    back), then ``g * rsqrt(sum / d_inner + eps) * scale``, the
    reference's unsharded ``rms_norm`` (``src/repro/models/layers.py:
    57-62``) on this rank's channels.  The reference's sharded step
    normalises over d_loc instead (``src/repro/models/ssm.py:219``)."""
    if not pc.tp_active:
        return layers.rms_norm(g, scale, eps)
    g32 = g.float()
    ss = pc.tp_all_reduce(g32.square().sum(dim=-1, keepdim=True))
    return (g32 * torch.rsqrt(ss / d_inner + eps) * scale).to(g.dtype)


def mamba2_decode(params: Params, x: torch.Tensor, state: tuple,
                  cfg: ModelConfig, pc: ParallelContext):
    """Single-token decode; x: (B, 1, d_model)."""
    return mamba2_forward(params, x, cfg, pc, state=state,
                          return_state=True)


def mamba_state_shapes(cfg: ModelConfig, tp: int, batch: int,
                       version: int) -> tuple:
    """Decode-state shapes of one row: v1 -> (conv, ssm); v2 ->
    (conv_x, conv_bc, ssm)."""
    s = cfg.ssm
    d_loc = s.expand * cfg.d_model // tp
    if version == 1:
        return ((batch, s.d_conv - 1, d_loc), (batch, d_loc, s.d_state))
    nh = d_loc // s.headdim
    return ((batch, s.d_conv - 1, d_loc),
            (batch, s.d_conv - 1, 2 * s.d_state),
            (batch, nh, s.headdim, s.d_state))
