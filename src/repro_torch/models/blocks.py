"""Decoder rows and layer-group assembly.

Port of ``repro/models/blocks.py`` for row kinds ``a`` (pre-norm
attention + pre-norm SwiGLU FFN), ``e`` (pre-norm attention + pre-norm
MoE FFN, ``models.moe``), ``1`` and ``2`` (pre-norm Mamba-1 / Mamba-2
block), and Zamba2's shared attention rows: ``a`` rows of a
``shared_attention`` model form ``shared`` groups that hold no params
of their own and all apply the one ``shared_a`` set (``models.model``),
each occurrence with its own KV cache.  Consecutive rows of one kind
form a group whose params are stacked along a leading layer axis (the
reference's ``g<i>`` layout); the model loops over a group's layers in
Python where the reference runs ``lax.scan``.  Every row kind trains
at any tp (the Mamba rows channel- and head-sharded over the model
axis, ``models.ssm``), and prefills and decodes at any tp: at tp > 1
an attention row's KV cache is sharded over the sequence (each rank
holds max_seq / tp positions of every kv head, the reference's
flash-decoding layout, ``layers.decode_attention``), cross attention's
``ck``/``cv`` hold the rank's kv heads when kv is sharded (else all of
them), and a Mamba row's state its channels.  The ``a`` rows of a model
with an encoder (whisper-tiny) also hold cross attention (``norm_x``,
``xattn``): their queries attend the encoder's output, and their decode
cache keeps its projected keys and values (``ck``, ``cv``: no token
axis, computed once by the prefill).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext

Params = dict


@dataclasses.dataclass(frozen=True)
class Group:
    kind: str          # 'a' | 'e' | '1' | '2'
    count: int
    shared: bool = False   # single param set reused `count` times


def scan_groups(cfg: ModelConfig) -> list[Group]:
    """Groups in pattern order; consecutive same-kind rows merge."""
    groups: list[Group] = []
    for ch in cfg.layer_pattern:
        shared = ch == "a" and cfg.shared_attention
        if groups and groups[-1].kind == ch \
                and groups[-1].shared == shared:
            groups[-1] = Group(ch, groups[-1].count + 1, shared)
        else:
            groups.append(Group(ch, 1, shared))
    return groups


def _check_kind(kind: str, cfg: ModelConfig) -> None:
    if kind not in ("a", "e", "1", "2"):
        raise ValueError(f"{cfg.name}: unknown row kind {kind!r}")


# ----------------------------------------------------------------------- #
# row init / forward
# ----------------------------------------------------------------------- #

def init_row(gen: torch.Generator, kind: str, cfg: ModelConfig, tp: int,
             dtype, device, layers_: int = 1, cross: bool = False) -> Params:
    """GLOBAL params of ``layers_`` stacked rows (leading layer axis),
    q heads and the FFN laid out for ``tp`` (``sharding.shard_params``
    slices them per rank); ``cross`` adds an ``a`` row's cross attention
    (``norm_x``, ``xattn``)."""
    _check_kind(kind, cfg)
    ones = torch.ones((layers_, cfg.d_model), dtype=torch.float32,
                      device=device)
    if kind in ("1", "2"):
        init = ssm.init_mamba1 if kind == "1" else ssm.init_mamba2
        return {"norm1": ones,
                "mamba": init(gen, cfg, tp, dtype, device, layers_)}
    p = {"norm1": ones,
         "attn": layers.init_attention(gen, cfg, tp, dtype, device,
                                       layers_),
         "norm2": ones.clone()}
    if kind == "e":
        p["moe"] = moe.init_moe(gen, cfg, tp, dtype, device, layers_)
        return p
    p["ffn"] = layers.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device,
                               layers_)
    if cross:
        p["norm_x"] = ones.clone()
        p["xattn"] = layers.init_attention(gen, cfg, tp, dtype, device,
                                           layers_)
    return p


def _ffn_part(p: Params, ff_in: torch.Tensor, kind: str, cfg: ModelConfig,
              pc: ParallelContext, capacity: Optional[int] = None):
    """The row's FFN half on its normed input: the dense SwiGLU (``a``,
    no auxiliary loss) or the MoE (``e``).  Returns (out, aux or None)."""
    if kind == "e":
        return moe.moe_forward(p["moe"], ff_in, cfg, pc, capacity=capacity)
    return layers.ffn_forward(p["ffn"], ff_in, pc), None


def _cross_part(p: Params, h: torch.Tensor, cfg: ModelConfig,
                pc: ParallelContext, positions: torch.Tensor,
                encoder_out: torch.Tensor, return_kv: bool = False):
    """The row's cross-attention half: ``h`` plus attention of its
    normed queries over ``encoder_out``; with ``return_kv`` also the
    unroped (ck, cv)."""
    x_in = layers.rms_norm(h, p["norm_x"], cfg.norm_eps)
    out = layers.attention_forward(p["xattn"], x_in, cfg, pc, positions,
                                   causal=False, kv_source=encoder_out,
                                   return_kv=return_kv)
    if return_kv:
        return h + out[0], out[1]
    return h + out


def row_forward(p: Params, h: torch.Tensor, kind: str, cfg: ModelConfig,
                pc: ParallelContext, positions: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None,
                causal: bool = True, window: Optional[int] = None):
    """Full-sequence forward for one row (training, the encoder).  An
    ``a`` row with cross attention attends ``encoder_out`` after its
    self attention.  Returns (h, aux_loss); the MoE's router loss, zero
    for the other kinds."""
    _check_kind(kind, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in ("1", "2"):
        m_in = layers.rms_norm(h, p["norm1"], cfg.norm_eps)
        fwd = ssm.mamba1_forward if kind == "1" else ssm.mamba2_forward
        return h + fwd(p["mamba"], m_in, cfg, pc), aux
    attn_in = layers.rms_norm(h, p["norm1"], cfg.norm_eps)
    h = h + layers.attention_forward(p["attn"], attn_in, cfg, pc,
                                     positions, causal=causal,
                                     window=window)
    if "xattn" in p and encoder_out is not None:
        h = _cross_part(p, h, cfg, pc, positions, encoder_out)
    ff_in = layers.rms_norm(h, p["norm2"], cfg.norm_eps)
    out, moe_aux = _ffn_part(p, ff_in, kind, cfg, pc)
    return h + out, aux if moe_aux is None else moe_aux


def row_prefill(p: Params, h: torch.Tensor, kind: str, cfg: ModelConfig,
                pc: ParallelContext, positions: torch.Tensor, cache: dict,
                encoder_out: Optional[torch.Tensor] = None,
                window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence forward that also fills this row's decode cache
    ``cache`` (see :func:`row_cache_init`), written in place where the
    reference returns a new one.  Returns h."""
    _check_kind(kind, cfg)
    if kind in ("1", "2"):
        m_in = layers.rms_norm(h, p["norm1"], cfg.norm_eps)
        fwd = ssm.mamba1_forward if kind == "1" else ssm.mamba2_forward
        out, state = fwd(p["mamba"], m_in, cfg, pc, return_state=True)
        for key, new in zip(_ssm_keys(kind), state):
            cache[key].copy_(new)
        return h + out
    attn_in = layers.rms_norm(h, p["norm1"], cfg.norm_eps)
    out, (k, v) = layers.attention_forward(
        p["attn"], attn_in, cfg, pc, positions, causal=True,
        window=window, return_kv=True)
    h = h + out
    _kv_to_cache(k, v, cfg, pc, cache)
    if "xattn" in p and encoder_out is not None:
        h, (ck, cv) = _cross_part(p, h, cfg, pc, positions, encoder_out,
                                  return_kv=True)
        cache["ck"].copy_(ck)
        cache["cv"].copy_(cv)
    ff_in = layers.rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + _ffn_part(p, ff_in, kind, cfg, pc)[0]


def _kv_to_cache(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                 pc: ParallelContext, cache: dict) -> None:
    """(B, L, n_kv_local, hd) head layout -> this rank's slice of the
    flash-decoding cache (B, S_local, n_kv_full, hd): at tp > 1 the heads
    are gathered when kv is sharded, and the L positions, zero-padded to
    max_seq = S_local * tp, give rank i positions i * S_local ... (i +
    1) * S_local - 1 (the reference slices without padding, ROADMAP
    queue 3); at tp = 1 the first L positions.  Positions past L stay
    zero."""
    l, s_local = k.shape[1], cache["k"].shape[1]
    if l > s_local * pc.tp:
        raise ValueError(f"prefill length {l} exceeds max_seq "
                         f"{s_local * pc.tp}")
    if layers.attn_dims(cfg, pc.tp).kv_sharded:
        k = layers._gather_heads(k, pc)
        v = layers._gather_heads(v, pc)
    lo = pc.tp_index() * s_local
    n = min(l, lo + s_local) - lo
    if n > 0:
        cache["k"][:, :n] = k[:, lo:lo + n]
        cache["v"][:, :n] = v[:, lo:lo + n]


def _ssm_keys(kind: str) -> tuple:
    """A Mamba row's cache entries, in the order of its state tuple."""
    return ("conv", "ssm") if kind == "1" else ("conv", "conv_bc", "ssm")


def row_decode(p: Params, h: torch.Tensor, kind: str, cache: dict,
               pos: torch.Tensor, cfg: ModelConfig, pc: ParallelContext,
               window: Optional[int] = None,
               active: Optional[torch.Tensor] = None):
    """Single-token decode for one row; writes the row's cache in place:
    attention ``{'k','v'}`` (see ``layers.decode_attention``; cross
    attention reads ``{'ck','cv'}`` and writes nothing), Mamba-1
    ``{'conv','ssm'}``, Mamba-2 ``{'conv','conv_bc','ssm'}``.  With
    ``active`` ((B,) bool) only those slots' state is written; an
    inactive slot's stays bitwise as it was.  Returns (h, cache)."""
    _check_kind(kind, cfg)
    if kind in ("1", "2"):
        m_in = layers.rms_norm(h, p["norm1"], cfg.norm_eps)
        dec = ssm.mamba1_decode if kind == "1" else ssm.mamba2_decode
        keys = _ssm_keys(kind)
        out, state = dec(p["mamba"], m_in, tuple(cache[k] for k in keys),
                         cfg, pc)
        for key, new in zip(keys, state):
            if active is not None:
                keep = active.reshape(-1, *([1] * (new.dim() - 1)))
                new = torch.where(keep, new.to(cache[key].dtype),
                                  cache[key])
            cache[key].copy_(new)
        return h + out, cache
    attn_in = layers.rms_norm(h, p["norm1"], cfg.norm_eps)
    kv_write = pos % window if window is not None else pos
    out, _, _ = layers.decode_attention(
        p["attn"], attn_in, cache["k"], cache["v"], pos, cfg, pc,
        window=window, kv_write_pos=kv_write, active=active)
    h = h + out
    if "xattn" in p and "ck" in cache:
        x_in = layers.rms_norm(h, p["norm_x"], cfg.norm_eps)
        h = h + _cross_decode(p["xattn"], x_in, cache["ck"], cache["cv"],
                              cfg, pc)
    ff_in = layers.rms_norm(h, p["norm2"], cfg.norm_eps)
    # decode is drop-free: worst case every assignment lands on one
    # expert, so capacity = tokens * top_k
    cap = ff_in.shape[0] * ff_in.shape[1] * cfg.moe.top_k \
        if kind == "e" else None
    h = h + _ffn_part(p, ff_in, kind, cfg, pc, capacity=cap)[0]
    return h, cache


def _cross_decode(p: Params, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, cfg: ModelConfig,
                  pc: ParallelContext) -> torch.Tensor:
    """Cross attention of one query a slot against the cached encoder
    keys and values (B, S_enc, n_kv, hd): local kv heads, the whole
    encoder sequence, the output row-parallel-reduced over tp."""
    d = layers.attn_dims(cfg, pc.tp)
    b = x.shape[0]
    q = layers.dense(x, p["wq"]).reshape(b, 1, d.n_q, d.head_dim)
    kk, vv = layers.select_kv(ck, cv, d, cfg, pc)
    out = layers.attention_scores(q, kk, vv, causal=False)
    out = layers.dense(out.reshape(b, 1, d.n_q * d.head_dim), p["wo"])
    return pc.tp_all_reduce(out)


def row_cache_init(kind: str, cfg: ModelConfig, pc: ParallelContext,
                   batch: int, max_seq: int, dtype, device,
                   layers_: Optional[int] = 1, cross_len: int = 0) -> dict:
    """Zero decode cache of this rank of ``layers_`` stacked rows
    (``layers_`` None: one row without the layer axis, a shared
    occurrence's): attention {'k','v'}: (layers_, batch, max_seq / tp,
    n_kv_full, hd) (the sequence sharded over tp, every kv head), with
    ``cross_len`` also the cross attention's {'ck','cv'}: (layers_,
    batch, cross_len, n_kv, hd) (the rank's kv heads when kv is sharded,
    else all; no token axis); Mamba-1 {'conv': (layers_, batch, d_conv -
    1, d_inner / tp) in ``dtype``, 'ssm': (layers_, batch, d_inner / tp,
    d_state) f32}; Mamba-2 {'conv' in ``dtype``, 'conv_bc': (layers_,
    batch, d_conv - 1, 2 d_state) f32, 'ssm': (layers_, batch, nh / tp,
    headdim, d_state) f32} (no token axis)."""
    _check_kind(kind, cfg)
    lead = () if layers_ is None else (layers_,)
    if kind in ("1", "2"):
        shapes = ssm.mamba_state_shapes(cfg, pc.tp, batch, int(kind))
        # the x conv in the cache dtype; the B/C conv and the state f32
        dtypes = (dtype,) + (torch.float32,) * (len(shapes) - 1)
        return {key: torch.zeros(lead + shape, dtype=dt, device=device)
                for key, shape, dt in zip(_ssm_keys(kind), shapes, dtypes)}
    d = layers.attn_dims(cfg, pc.tp)
    if max_seq % pc.tp:
        raise ValueError(f"max_seq {max_seq} must divide over tp {pc.tp}: "
                         f"the KV cache is sharded over the sequence")
    n_kv_full = d.n_kv * pc.tp if d.kv_sharded else d.n_kv
    out = {}
    for name, length, heads in (("", max_seq // pc.tp, n_kv_full),
                                ("c", cross_len, d.n_kv)):
        if length:
            shape = lead + (batch, length, heads, d.head_dim)
            for leaf in ("k", "v"):
                out[name + leaf] = torch.zeros(shape, dtype=dtype,
                                               device=device)
    return out
