"""Core layers: RMSNorm, RoPE, GQA attention (train/prefill/decode),
SwiGLU FFN, embeddings, sharded-vocab cross-entropy.

Port of ``repro/models/layers.py``.  Tensor parallelism follows the
reference (Megatron-style, each rank holding its shards): column-parallel
weights hold their local out-features slice and need no collective;
row-parallel weights hold their local in-features slice and the partial
product is summed with ``pc.tp_all_reduce``; q heads are padded to a
multiple of tp (zero weights, inert); kv heads are sharded when tp
divides them, else replicated; the vocabulary is sharded over tp for the
embedding and the head.  Decode at tp > 1 shards the KV cache over the
sequence (flash-decoding, :func:`decode_attention`): every rank holds
all kv heads of its slice of the positions.

Names, layouts and the float32 math follow the reference; ``rms_norm``,
the long-sequence branch of ``attention_scores`` and ``dense`` on a
gathered FSDP shard stack go through the hand-written CUDA kernels, all
differentiable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.overlap import StackedShards
from repro_torch.kernels import fused_collectives as _fc
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext

Params = dict


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` may be a rank-major ``StackedShards`` stack
    from the fused FSDP gather (``TrainConfig.fuse_kernels``): the stack
    streams through the ``all_gather_matmul`` kernel (``fused_dense``)
    instead of being concatenated first.  Plain tensors take the
    ordinary matmul."""
    if isinstance(w, StackedShards):
        return _fc.fused_dense(x, w.shards)
    return x @ w


# ---------------------------------------------------------------------- #
# initialization helpers
# ---------------------------------------------------------------------- #

def _dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
                device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    # scaled in place: a full-width stack is never held twice
    return torch.randn(shape, generator=gen, device=device) \
        .mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Normalise over the last axis (f32 math, result in x's dtype)
    through the RMSNorm kernel, rows flattened to (T, D)."""
    d = x.shape[-1]
    return _rn.rms_norm(x.reshape(-1, d), scale, eps).reshape(x.shape)


# ---------------------------------------------------------------------- #
# rotary position embeddings
# ---------------------------------------------------------------------- #

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32,
                               device=device) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]                    # (..,s,1,hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class AttnDims:
    """Local (per-tp-shard) attention dimensions."""
    n_q: int          # local query heads (after padding / tp split)
    n_kv: int         # local kv heads (sharded) or full kv heads (repl.)
    head_dim: int
    kv_sharded: bool


def attn_dims(cfg: ModelConfig, tp: int) -> AttnDims:
    if cfg.kv_sharded(tp) and cfg.padded_heads(tp) != cfg.n_heads:
        # sharded kv + padded q would misalign shard-local GQA grouping
        raise ValueError(
            f"{cfg.name}: q-head padding with sharded kv unsupported")
    return AttnDims(n_q=cfg.padded_heads(tp) // tp,
                    n_kv=(cfg.n_kv_heads // tp if cfg.kv_sharded(tp)
                          else cfg.n_kv_heads),
                    head_dim=cfg.head_dim,
                    kv_sharded=cfg.kv_sharded(tp))


def init_attention(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype,
                   device, layers: int = 1) -> Params:
    """GLOBAL param shapes with a leading ``layers`` axis.  Q heads padded
    to a multiple of tp; padded head weights zeroed so the padding is
    numerically inert under any tp."""
    dm, hd = cfg.d_model, cfg.head_dim
    hq_pad = cfg.padded_heads(tp)
    n_kv = cfg.n_kv_heads
    real = cfg.n_heads * hd
    wq = _dense_init(gen, (layers, dm, hq_pad * hd), dm, dtype, device)
    wk = _dense_init(gen, (layers, dm, n_kv * hd), dm, dtype, device)
    wv = _dense_init(gen, (layers, dm, n_kv * hd), dm, dtype, device)
    wo = _dense_init(gen, (layers, hq_pad * hd, dm), cfg.n_heads * hd,
                     dtype, device)
    if hq_pad != cfg.n_heads:
        wq[..., real:] = 0.0
        wo[:, real:, :] = 0.0
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _gqa_index(n_q_glob_start: int, n_q: int, n_kv: int, cfg: ModelConfig,
               device) -> torch.Tensor:
    """kv head of each query head: global index // unpadded group size,
    clipped to the last kv head (padded q heads are inert)."""
    g = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    q_glob = n_q_glob_start + torch.arange(n_q, device=device)
    return torch.clamp(q_glob // g, 0, n_kv - 1)


def select_kv(k: torch.Tensor, v: torch.Tensor, d: AttnDims,
              cfg: ModelConfig, pc: ParallelContext):
    """Map each *local* query head to its GQA kv head (see the
    reference: aligned repeat for sharded kv, clipped global index for
    replicated kv)."""
    if d.kv_sharded:
        rep = d.n_q // d.n_kv
        return _repeat_kv(k, rep), _repeat_kv(v, rep)
    idx = _gqa_index(pc.tp_index() * d.n_q, d.n_q, d.n_kv, cfg, k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def select_kv_global(k: torch.Tensor, v: torch.Tensor, hq_full: int,
                     cfg: ModelConfig):
    """Same mapping for the decode path where all q heads are present:
    hq_full may include padding; k/v hold all kv heads."""
    idx = _gqa_index(0, hq_full, k.shape[2], cfg, k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


FLASH_THRESHOLD = 1024  # sequences this long use blocked attention


def attention_scores(q, k, v, causal: bool, window: Optional[int] = None,
                     q_offset: int = 0):
    """Attention.  q: (B,Lq,H,hd), k/v: (B,Lk,H,hd).  Long sequences
    dispatch to the blocked flash kernel (O(L) memory)."""
    if q.shape[1] >= FLASH_THRESHOLD and k.shape[1] >= FLASH_THRESHOLD:
        from repro_torch.models.flash import flash_attention
        return flash_attention(q, k, v, causal, window, q_offset)
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    lq, lk = q.shape[1], k.shape[1]
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(lk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      pc: ParallelContext, positions: torch.Tensor,
                      causal: bool = True,
                      window: Optional[int] = None,
                      kv_source: Optional[torch.Tensor] = None,
                      return_kv: bool = False):
    """Full-sequence attention (training, prefill, the encoder).
    ``kv_source`` (B, Lk, d_model) switches to cross attention: keys and
    values from it (the encoder's output), no RoPE on q or k, never
    causal.  The output is row-parallel-reduced over tp.  Returns the
    output, and with ``return_kv`` also (k, v) before GQA expansion:
    roped for self attention, unroped for cross attention."""
    d = attn_dims(cfg, pc.tp)
    b, l, _ = x.shape
    q = dense(x, params["wq"]).reshape(b, l, d.n_q, d.head_dim)
    src = x if kv_source is None else kv_source
    lk = src.shape[1]
    k = dense(src, params["wk"]).reshape(b, lk, d.n_kv, d.head_dim)
    v = dense(src, params["wv"]).reshape(b, lk, d.n_kv, d.head_dim)
    if kv_source is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kk, vv = select_kv(k, v, d, cfg, pc)
    out = attention_scores(q, kk, vv, causal=causal and kv_source is None,
                           window=window)
    out = dense(out.reshape(b, l, d.n_q * d.head_dim), params["wo"])
    out = pc.tp_all_reduce(out)
    if return_kv:
        return out, (k, v)
    return out


# -- decode path --------------------------------------------------------- #

def decode_attention(params: Params, x: torch.Tensor, cache_k, cache_v,
                     pos: torch.Tensor, cfg: ModelConfig,
                     pc: ParallelContext,
                     window: Optional[int] = None,
                     kv_write_pos: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None):
    """One-token decode with a sequence-sharded KV cache, the
    reference's (``src/repro/models/layers.py:231-336``).

    x: (B, 1, d_model).  cache_{k,v}: (B, S_local, n_kv_full, hd), this
    rank's slice of a cache whose global length is S_local * tp (rank i
    holds global slots i * S_local ... (i + 1) * S_local - 1; the whole
    cache at tp = 1), with every kv head.  ``pos``: the global position
    being written - a 0-d int tensor (whole batch at one position) or a
    ``(B,)`` int tensor (per-slot positions, the continuous-batching
    engine).  For a ring-buffer window cache the caller passes
    ``kv_write_pos`` = pos % window (same rank as ``pos``).

    The new token's k and v are computed on every rank (head-sharded kv
    gathers its heads first); the rank that owns global slot ``write //
    S_local`` writes it at ``write % S_local``.  Each rank attends every
    q head (gathered) over its slots, masked by their global index; the
    softmax takes the global max (``pc.tp_psum_max``) and three
    AllReduces (the sum of the weights, the weighted values, the output
    projection of this rank's q-head slice) complete it.

    Unlike the reference, which returns new caches, this writes the new
    token's k/v into ``cache_k``/``cache_v`` IN PLACE.  ``active`` (a
    (B,) bool tensor, vector ``pos`` only) limits the write to those
    slots, so an inactive slot's cache is left exactly as it was.

    Returns (attn_out (B,1,d_model), cache_k, cache_v).
    """
    d = attn_dims(cfg, pc.tp)
    b = x.shape[0]
    s_local = cache_k.shape[1]
    tp_idx = pc.tp_index()
    vec = pos.dim() > 0
    if active is not None and not vec:
        raise ValueError("active slots need per-slot (vector) pos")

    q = dense(x, params["wq"]).reshape(b, 1, d.n_q, d.head_dim)
    rope_pos = pos.reshape(b, 1) if vec else pos.reshape(1)
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k_new = dense(x, params["wk"]).reshape(b, 1, d.n_kv, d.head_dim)
    v_new = dense(x, params["wv"]).reshape(b, 1, d.n_kv, d.head_dim)
    k_new = apply_rope(k_new, rope_pos, cfg.rope_theta)
    if d.kv_sharded:
        k_new = _gather_heads(k_new, pc)      # the cache holds all heads
        v_new = _gather_heads(v_new, pc)

    write = kv_write_pos if kv_write_pos is not None else pos
    local_off = write % s_local
    # whether this rank owns the slot (always, at tp = 1)
    keep = write // s_local == tp_idx if pc.tp_active else None
    if active is not None:
        keep = active if keep is None else keep & active
    # index tensors, never a Python int: no host sync, and the meta
    # device traces it
    if vec:
        at = (torch.arange(b, device=x.device), local_off)
        k_row, v_row = k_new[:, 0], v_new[:, 0]
    else:
        at = (slice(None), local_off.reshape(1))
        k_row, v_row = k_new, v_new
    k_row, v_row = k_row.to(cache_k.dtype), v_row.to(cache_v.dtype)
    if keep is not None:
        keep = keep.reshape(b, 1, 1) if vec else keep
        k_row = torch.where(keep, k_row, cache_k[at])
        v_row = torch.where(keep, v_row, cache_v[at])
    cache_k[at] = k_row
    cache_v[at] = v_row

    # partial attention over the local slots, all q heads
    q_full = _gather_heads(q, pc)                        # (B,1,Hq_full,hd)
    kk, vv = select_kv_global(cache_k, cache_v, q_full.shape[2], cfg)
    logits = torch.einsum("bqhd,bkhd->bhqk", q_full.float(), kk.float())
    logits = logits / math.sqrt(d.head_dim)
    # mask invalid cache slots by their global slot index
    sp = (tp_idx * s_local + torch.arange(s_local, device=x.device)
          )[None, None, None, :]
    pv = pos.reshape(b, 1, 1, 1) if vec else pos
    if window is not None:
        # ring buffer: before the buffer wraps (pos < window) only slots
        # <= pos hold data; afterwards every slot is live.
        valid = (sp <= pv) | (pv >= window)
    else:
        valid = sp <= pv
    logits = logits.masked_fill(~valid, float("-inf"))
    m = pc.tp_psum_max(logits.amax(dim=-1))              # (B,H,1) global
    p = torch.exp(logits - m[..., None])
    p = torch.where(valid, p, 0.0)
    l_glob = pc.tp_all_reduce(p.sum(dim=-1))             # (B,H,1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype), vv)
    o = pc.tp_all_reduce(o.float())
    out = o / torch.clamp(l_glob, min=1e-20).transpose(1, 2)[..., None]
    # row-parallel output projection: this rank's q-head slice only
    out = out[:, :, tp_idx * d.n_q:(tp_idx + 1) * d.n_q]
    out = dense(out.to(x.dtype).reshape(b, 1, d.n_q * d.head_dim),
                params["wo"])
    out = pc.tp_all_reduce(out)
    return out, cache_k, cache_v


def _gather_heads(x: torch.Tensor, pc: ParallelContext) -> torch.Tensor:
    """(B, L, h_local, hd) -> (B, L, h_local * tp, hd): an AllGather over
    tp of the heads (the identity at tp = 1)."""
    if not pc.tp_active:
        return x
    gathered = pc.comm.all_gather(x.movedim(2, 0), pc.tp_axis)
    return gathered.movedim(0, 2)


# ---------------------------------------------------------------------- #
# SwiGLU FFN
# ---------------------------------------------------------------------- #

def init_ffn(gen: torch.Generator, d_model: int, d_ff_local: int, dtype,
             device, layers: int = 1) -> Params:
    return {
        "wg": _dense_init(gen, (layers, d_model, d_ff_local), d_model,
                          dtype, device),
        "wu": _dense_init(gen, (layers, d_model, d_ff_local), d_model,
                          dtype, device),
        "wd": _dense_init(gen, (layers, d_ff_local, d_model), d_ff_local,
                          dtype, device),
    }


def ffn_forward(params: Params, x: torch.Tensor,
                pc: ParallelContext) -> torch.Tensor:
    h = F.silu(dense(x, params["wg"])) * dense(x, params["wu"])
    return pc.tp_all_reduce(dense(h, params["wd"]))


# ---------------------------------------------------------------------- #
# embeddings
# ---------------------------------------------------------------------- #

def init_embedding(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype,
                   device) -> Params:
    """GLOBAL shapes; vocab padded to a multiple of tp."""
    v_pad = cfg.padded_vocab(tp)
    p = {"tok": (torch.randn((v_pad, cfg.d_model), generator=gen,
                             device=device) * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, v_pad), cfg.d_model,
                                dtype, device)
    return p


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 pc: ParallelContext) -> torch.Tensor:
    """Vocab-sharded lookup: each rank contributes the rows of its
    vocabulary slice (zeros elsewhere), summed over tp (one
    AllReduce)."""
    if not pc.tp_active:
        return params["tok"][tokens]
    v_local = params["tok"].shape[0]
    local_ids = tokens.long() - pc.tp_index() * v_local
    in_range = (local_ids >= 0) & (local_ids < v_local)
    emb = params["tok"][local_ids.clamp(0, v_local - 1)]
    emb = torch.where(in_range[..., None], emb, 0.0)
    return pc.tp_all_reduce(emb)


def lm_logits(params: Params, h: torch.Tensor, cfg: ModelConfig,
              pc: ParallelContext) -> torch.Tensor:
    """*Local* vocab-slice logits (B, L, V / tp).  A tied head
    multiplies by a transposed *view* of the embedding table: the
    (V, d_model) table is never copied."""
    w = params.get("head")
    if w is None:
        w = params["tok"].t()
    return h @ w


def sharded_xent(logits_local: torch.Tensor, labels: torch.Tensor,
                 pc: ParallelContext, mask: Optional[torch.Tensor] = None,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy over vocab-sharded logits, as the reference's.

    logits_local: (B, L, V_local); labels: (B, L) global ids.  Three tp
    collectives: the max (``tp_max``, an all-gather), the sum of
    exponentials and the label's logit (AllReduces).  ``vocab_size``
    excludes padded vocabulary ids from the softmax; the max is a
    constant offset of the log-sum-exp, so it is detached."""
    v_local = logits_local.shape[-1]
    logits = logits_local.float()
    start = pc.tp_index() * v_local
    if vocab_size is not None and vocab_size < start + v_local:
        gid = start + torch.arange(v_local, device=logits.device)
        logits = logits.masked_fill(gid >= vocab_size, float("-inf"))
    m = pc.tp_max(logits.amax(dim=-1)).detach()
    z = pc.tp_all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1))
    local_ids = labels.long() - start
    in_range = (local_ids >= 0) & (local_ids < v_local)
    lab = logits.gather(-1, local_ids.clamp(0, v_local - 1)[..., None])
    lab = torch.where(in_range, lab[..., 0], 0.0)
    nll = torch.log(z) + m - pc.tp_all_reduce(lab)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
