"""Mixture-of-Experts layer with expert parallelism over the tp axis.

Port of ``repro/models/moe.py``.  Experts are sharded across the model
axis (padded to a multiple of tp, padding experts masked with -inf
router logits); tokens reach their experts through the
``Communicator``'s AllToAll (``pc.tp_all_to_all``), the collective the
paper identifies with MoE, differentiable (its own transpose).

Dispatch is capacity-based and sort-free, in the reference's order:

1. router -> top-k experts per token, weights renormalised;
2. position-in-expert via a cumsum over the flattened (t*k, E) one-hot
   assignment (token-major, slots in top-k order); (token, slot) pairs
   beyond the per-expert capacity are dropped (Switch behaviour);
3. ``index_add`` into an (experts, capacity, d) buffer - a dropped pair
   adds a zero row at its expert's last slot, so the sum stays exact -
   then the AllToAll over tp so each shard receives the buffers of its
   local experts from every peer;
4. local expert SwiGLU (batched products), AllToAll back, weighted
   combine.

With ``pc.tp == 1`` the same code runs unsharded.

``DROPS`` counts the (token, slot) pairs the capacity dropped, summed on
the device (no sync): the train step counts its forward pass only, not
the backward's remat replays, which route again.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext

Params = dict


class DropCounter:
    """Counts the (token, slot) pairs ``route`` routes and drops between
    ``start()`` and ``stop()``; outside them it counts nothing."""

    def __init__(self):
        self.parts = None
        self.assigned = 0

    def start(self) -> None:
        self.parts, self.assigned = [], 0

    def add(self, keep: torch.Tensor) -> None:
        if self.parts is not None:
            self.parts.append((~keep).sum())
            self.assigned += keep.numel()

    def stop(self) -> tuple:
        """(pairs dropped: a 0-d device tensor, or 0 - reading it
        synchronises; pairs routed)."""
        parts, self.parts = self.parts or [], None
        return (torch.stack(parts).sum() if parts else 0), self.assigned


DROPS = DropCounter()


def init_moe(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype,
             device, layers_: int = 1) -> Params:
    """GLOBAL shapes with a leading ``layers_`` axis: experts padded to a
    multiple of tp and stacked on the (expert-parallel) dim after it; the
    f32 router stays replicated and masks padded experts with -inf."""
    m = cfg.moe
    e_pad = m.padded_experts(tp)
    dm, f = cfg.d_model, m.expert_d_ff
    p = {
        "router": layers._dense_init(gen, (layers_, dm, e_pad), dm,
                                     torch.float32, device),
        "wg": layers._dense_init(gen, (layers_, e_pad, dm, f), dm, dtype,
                                 device),
        "wu": layers._dense_init(gen, (layers_, e_pad, dm, f), dm, dtype,
                                 device),
        "wd": layers._dense_init(gen, (layers_, e_pad, f, dm), f, dtype,
                                 device),
    }
    if m.dense_residual_d_ff:
        p["dense"] = layers.init_ffn(gen, dm, m.dense_residual_d_ff, dtype,
                                     device, layers_)
    return p


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          e_pad: int, capacity: Optional[int] = None) -> dict:
    """The router's decisions for tokens ``xt`` (t, d): top-k weights
    (renormalised) and experts, the Switch auxiliary loss, the capacity,
    each (token, slot)'s buffer row ``slot`` (t*k,) and whether it was
    kept (``keep``)."""
    m = cfg.moe
    t, k = xt.shape[0], m.top_k
    logits = xt.float() @ router
    if e_pad != m.num_experts:
        pad = torch.arange(e_pad, device=xt.device) >= m.num_experts
        logits = logits.masked_fill(pad[None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)               # (t, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e[:, 0], e_pad).float().mean(dim=0)
    aux = m.num_experts * torch.sum(me * ce) * m.router_aux_weight

    if capacity is None:
        capacity = max(1, int(t * k * m.capacity_factor) // e_pad)
    # position of each (token, slot) within its expert queue, token-major
    flat_oh = F.one_hot(top_e.reshape(t * k), e_pad)          # (t*k, E)
    pos = torch.cumsum(flat_oh, dim=0) - flat_oh
    pos_in_e = (pos * flat_oh).sum(dim=-1)                    # (t*k,)
    keep = pos_in_e < capacity
    DROPS.add(keep)
    slot = top_e.reshape(t * k) * capacity + torch.clamp(
        pos_in_e, max=capacity - 1)
    return {"top_w": top_w, "top_e": top_e, "aux": aux,
            "capacity": capacity, "slot": slot, "keep": keep}


def moe_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                pc: ParallelContext, capacity: Optional[int] = None):
    """x: (B, L, d).  Returns (out, aux_loss).

    Inside a tp row the activations are replicated, so each shard routes
    a disjoint token slice (when the tokens divide tp) and the combined
    outputs are re-assembled with one tp AllGather, as the reference's
    default ``shard_tokens=True``."""
    m = cfg.moe
    b, l, d = x.shape
    t_full = b * l
    # local expert count from the (model-axis sharded) weight shape
    e_local = params["wg"].shape[0]
    e_pad = e_local * pc.tp
    k = m.top_k

    xt_full = x.reshape(t_full, d)
    sharded = pc.tp > 1 and t_full % pc.tp == 0 and t_full >= pc.tp
    if sharded:
        t = t_full // pc.tp
        start = pc.tp_index() * t
        xt = xt_full[start:start + t]
    else:
        t = t_full
        xt = xt_full
    r = route(xt, params["router"], cfg, e_pad, capacity)
    cap, slot, keep = r["capacity"], r["slot"], r["keep"]
    w_flat = r["top_w"].reshape(t * k)

    # scatter (token, slot) rows into (E, capacity, d); dropped rows are
    # zeros added at their expert's last slot
    src = torch.repeat_interleave(xt, k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((e_pad * cap, d), dtype=x.dtype,
                      device=x.device).index_add(0, slot, src)

    if pc.tp > 1:
        # shard s receives the buffers of experts [s*e_local, (s+1)*
        # e_local) from every peer: peer p's segment holds ITS tokens
        recv = pc.tp_all_to_all(buf).reshape(pc.tp, e_local, cap, d)
        expert_in = recv.transpose(0, 1).reshape(e_local, pc.tp * cap, d)
    else:
        expert_in = buf.reshape(e_pad, cap, d)

    # local expert SwiGLU, batched over experts
    h = F.silu(torch.bmm(expert_in, params["wg"])) \
        * torch.bmm(expert_in, params["wu"])
    expert_out = torch.bmm(h, params["wd"])

    if pc.tp > 1:
        back = expert_out.reshape(e_local, pc.tp, cap, d).transpose(0, 1)
        flat_out = pc.tp_all_to_all(
            back.reshape(pc.tp * e_local * cap, d))
    else:
        flat_out = expert_out.reshape(e_pad * cap, d)

    # gather + weighted combine
    tok_out = flat_out[slot] * (w_flat * keep)[:, None].to(x.dtype)
    combined = tok_out.reshape(t, k, d).sum(dim=1)
    if sharded:
        combined = pc.comm.all_gather(combined, pc.tp_axis)
    out = combined.reshape(b, l, d)

    if "dense" in params:   # Arctic: dense residual MLP in parallel
        out = out + layers.ffn_forward(params["dense"], x, pc)
    return out, r["aux"]
