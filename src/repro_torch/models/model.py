"""Top-level language model: init, train forward (loss), prefill, decode.

Port of ``repro/models/model.py`` for models built from ``a``
(attention), ``e`` (attention + MoE), ``1`` (Mamba-1) or ``2``
(Mamba-2) rows, with Zamba2's shared attention block, and the two stub
frontends: a vision prefix (Phi-3-vision: projected patch embeddings
``front_proj`` prepended to the tokens, cut off before the logits) and
an encoder (whisper-tiny: projected frame embeddings ``enc_proj``
through a bidirectional stack of ``a`` rows, ``encoder``, and
``enc_norm``, which the decoder's ``a`` rows cross-attend); the training loss
adds the MoE rows' router losses (``aux``), each row's counted once: a
remat replay recomputes tensors, not the sum.  Params keep the
reference's tree (``embed``/``final_norm``/``g<i>`` groups with a
leading layer axis, and ``shared_a``, one un-stacked ``a`` row that
every shared group applies; a shared group has no ``g<i>`` of its
own; ``encoder``, stacked like a group), so ``params_from_numpy`` is a
renaming, not a reshuffle.  Layer
groups run as Python loops where the reference runs ``lax.scan``;
decode caches are updated in place.
``remat`` maps to ``torch.utils.checkpoint`` (non-reentrant): a row's
activations, and the FSDP gathers issued inside it, are recomputed in
the backward pass, as ``jax.checkpoint`` replays them.  A decoder row
closes over the encoder's output, so its gradient reaches the encoder
through the replay too.  The encoder runs without remat and outside
the FSDP gather, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import ledger
from repro_torch.core import tree as tree_mod
from repro_torch.core.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext

Params = dict


# ----------------------------------------------------------------------- #
# init and interchange with the reference
# ----------------------------------------------------------------------- #

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, dtype=torch.float32, tp: int = 1) -> Params:
    """Random params from ``generator``, which must live on ``device``
    (``None``: the CUDA card; raises when there is none), in the GLOBAL
    shapes of a ``tp``-way model axis, as the reference's: q heads and
    the vocabulary padded to a multiple of ``tp`` (padded q heads
    zeroed)."""
    device = resolve_device(device)
    cross = cfg.encoder is not None
    params: Params = {
        "embed": layers.init_embedding(generator, cfg, tp, dtype, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=device),
    }
    for gi, g in enumerate(blocks.scan_groups(cfg)):
        if g.shared:
            if "shared_a" not in params:     # one set for every occurrence
                params["shared_a"] = _layer(blocks.init_row(
                    generator, "a", cfg, tp, dtype, device, 1, cross), 0)
            continue
        params[f"g{gi}"] = blocks.init_row(generator, g.kind, cfg, tp,
                                           dtype, device, g.count, cross)
    fd = cfg.frontend_dim or cfg.d_model
    if cross:
        params["encoder"] = blocks.init_row(generator, "a", cfg, tp, dtype,
                                            device, cfg.encoder.n_layers)
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                        device=device)
        params["enc_proj"] = layers._dense_init(
            generator, (fd, cfg.d_model), fd, dtype, device)
    elif cfg.frontend != "text":
        params["front_proj"] = layers._dense_init(
            generator, (fd, cfg.d_model), fd, dtype, device)
    return params


def abstract_params(cfg: ModelConfig, tp: int = 1,
                    dtype=torch.float32) -> Params:
    """The params' tree of GLOBAL shapes and dtypes at ``tp`` as meta
    tensors (nothing is allocated): what spec construction walks."""
    return init_params(cfg, torch.Generator(), "meta", dtype, tp=tp)


def params_from_numpy(tree, device, cfg: Optional[ModelConfig] = None,
                      tp: int = 1) -> Params:
    """The reference's params as numpy (``jax.tree.map(np.asarray,
    params)``, made with ``init_params(key, cfg, tp)``) -> this
    package's params on ``device``.  With ``cfg`` every leaf's shape is
    checked against ``abstract_params(cfg, tp)``: params padded for
    another tp (heads, vocabulary) raise instead of loading."""
    out = _from_numpy(tree, resolve_device(device))
    if cfg is not None:
        want = {p: tuple(x.shape) for p, x in
                tree_mod.leaves_with_paths(abstract_params(cfg, tp))}
        got = {p: tuple(x.shape) for p, x in
               tree_mod.leaves_with_paths(out)}
        if got != want:
            bad = sorted("/".join(p) for p in set(got) | set(want)
                         if got.get(p) != want.get(p))
            raise ValueError(f"params do not have {cfg.name}'s shapes at "
                             f"tp = {tp}: {bad[:4]}")
    return out


def _from_numpy(tree, device) -> Params:
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_to_numpy(params: Params) -> dict:
    """Inverse of :func:`params_from_numpy`."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def _layer(p: Params, i: int) -> Params:
    """Layer ``i`` of a stacked group (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in p.items()}


# ----------------------------------------------------------------------- #
# shared plumbing: the frontends
# ----------------------------------------------------------------------- #

def prefix_tokens(cfg: ModelConfig) -> int:
    """Positions a vision prefix takes ahead of the tokens (in the
    sequence and the decode cache); 0 for the other models."""
    if cfg.frontend != "text" and cfg.encoder is None:
        return cfg.frontend_tokens
    return 0


def frontend_inputs(cfg: ModelConfig) -> frozenset:
    """The batch entries the model takes beside the tokens: a vision
    prefix's ``frontend``, an encoder's ``source``, or none."""
    if cfg.encoder is not None:
        return frozenset({"source"})
    return frozenset({"frontend"}) if prefix_tokens(cfg) else frozenset()


def _encode(params: Params, source: torch.Tensor, cfg: ModelConfig,
            pc: ParallelContext) -> torch.Tensor:
    """Stub-frontend frames (B, S, frontend_dim) -> the encoder stack
    (bidirectional ``a`` rows, RoPE on arange(S)) -> ``enc_norm``."""
    h = source @ params["enc_proj"]
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(cfg.encoder.n_layers):
        h, _ = blocks.row_forward(_layer(params["encoder"], i), h, "a", cfg,
                                  pc, positions, causal=False)
    return layers.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _embed_inputs(params: Params, batch: dict, cfg: ModelConfig,
                  pc: ParallelContext) -> tuple:
    """(h, n_prefix, encoder_out): the token embeddings, behind the
    projected vision prefix of a ``vision_stub`` model (``n_prefix`` its
    length), and the encoder's output of an encoder-decoder model."""
    h = layers.embed_tokens(params["embed"], batch["tokens"], cfg, pc)
    if cfg.encoder is not None:
        return h, 0, _encode(params, batch["source"], cfg, pc)
    if cfg.frontend != "text":
        front = batch["frontend"] @ params["front_proj"]
        return torch.cat([front.to(h.dtype), h], dim=1), front.shape[1], \
            None
    return h, 0, None


# ----------------------------------------------------------------------- #
# training forward
# ----------------------------------------------------------------------- #

def _maybe_remat(fn, remat: bool):
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _run_groups(params: Params, h, cfg, pc, positions, encoder_out,
                remat: bool, window=None, gather_fn=None, prefetch: int = 0):
    """Run every layer group.  ``gather_fn(group_key, row_params)`` is the
    FSDP hook; ``prefetch >= 1`` is the reference's double-buffered
    schedule: row ``l + 1``'s gather is issued (under
    ``ledger.hidden()``) in the same body that computes row ``l``, and
    the gathered params ride to the next body as its input (so, as in
    the reference, each row's gathered params live until its backward).
    A shared group applies ``params["shared_a"]``: under ``prefetch >=
    1`` gathered once for the group (exposed, as the reference) and
    reused by its occurrences; under ``prefetch 0`` gathered at each
    occurrence inside its remat body (so the replay gathers again).
    """
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    prefetching = gather_fn is not None and prefetch >= 1

    def make_body(kind, group_key):
        def body(hh, p):
            if gather_fn is not None:
                p = gather_fn(group_key, p)   # FSDP: gather row params
            return blocks.row_forward(p, hh, kind, cfg, pc, positions,
                                      encoder_out, window=window)
        return _maybe_remat(body, remat)

    def make_prefetch_body(kind, group_key):
        def body(hh, p_cur, p_next):
            out, aux = blocks.row_forward(p_cur, hh, kind, cfg, pc,
                                          positions, encoder_out,
                                          window=window)
            # issued after the row's compute: the gather saves no tensor
            # for backward, so the remat replay (checkpoint's early stop)
            # ends before it instead of gathering row l+1 again
            with ledger.hidden():
                p_pre = gather_fn(group_key, p_next)
            return out, aux, p_pre
        return _maybe_remat(body, remat)

    def make_consume(kind):
        def body(hh, p):
            return blocks.row_forward(p, hh, kind, cfg, pc, positions,
                                      encoder_out, window=window)
        return _maybe_remat(body, remat)

    for gi, g in enumerate(blocks.scan_groups(cfg)):
        if g.shared:
            shared = params["shared_a"]
            if prefetching:
                shared = gather_fn("shared_a", shared)
                body = make_consume("a")
            else:
                body = make_body("a", "shared_a")
            for _ in range(g.count):
                h, aux = body(h, shared)
                aux_total = aux_total + aux
            continue
        stacked = params[f"g{gi}"]
        if prefetching:
            gathered = gather_fn(f"g{gi}", _layer(stacked, 0))  # prologue
            step = make_prefetch_body(g.kind, f"g{gi}")
            for i in range(1, g.count):
                h, aux, gathered = step(h, gathered, _layer(stacked, i))
                aux_total = aux_total + aux
            h, aux = make_consume(g.kind)(h, gathered)
            aux_total = aux_total + aux
        else:
            body = make_body(g.kind, f"g{gi}")
            for i in range(g.count):
                h, aux = body(h, _layer(stacked, i))
                aux_total = aux_total + aux
    return h, aux_total


def loss_fn(params: Params, batch: dict, cfg: ModelConfig,
            pc: ParallelContext, remat: bool = True,
            window: Optional[int] = None, gather_fn=None,
            prefetch: int = 0):
    """batch: tokens (B, L), labels (B, L), optional loss_mask, and the
    frontend's extras: ``frontend`` (B, frontend_tokens, frontend_dim)
    or ``source`` (B, source_len, frontend_dim).  ``gather_fn`` is the
    FSDP hook (``sharding.fsdp_gather_fn`` /
    ``core.overlap.make_gather_fn``); ``prefetch >= 1`` double-buffers
    it.  Returns (loss, aux_dict)."""
    if gather_fn is not None:
        # embed is used at both ends of the step: gather once up front.
        params = dict(params, embed=gather_fn("embed", params["embed"]))
    h, n_prefix, encoder_out = _embed_inputs(params, batch, cfg, pc)
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux = _run_groups(params, h, cfg, pc, positions, encoder_out,
                         remat=remat, window=window, gather_fn=gather_fn,
                         prefetch=prefetch)
    h = layers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if n_prefix:
        h = h[:, n_prefix:]
    logits = layers.lm_logits(params["embed"], h, cfg, pc)
    xent = layers.sharded_xent(logits, batch["labels"], pc,
                               mask=batch.get("loss_mask"),
                               vocab_size=cfg.vocab_size)
    return xent + aux, {"xent": xent, "aux": aux}


# ----------------------------------------------------------------------- #
# serving: prefill + decode
# ----------------------------------------------------------------------- #

@torch.no_grad()
def prefill(params: Params, batch: dict, cfg: ModelConfig,
            pc: ParallelContext, max_seq: int,
            cache_dtype=torch.bfloat16, window: Optional[int] = None):
    """Full-sequence forward producing last-position logits (B, 1, V;
    at tp > 1 this rank's vocabulary slice, (B, 1, V_pad / tp)) and
    this rank's decode cache (a list aligned with layer groups, each
    {'k','v'}: (layers, B, max_seq / tp, n_kv_full, hd) for attention
    rows, the sequence sharded over tp, with an encoder also
    {'ck','cv'}, or the Mamba rows' state, see
    ``blocks.row_cache_init``; a shared group's entry is a list of its
    occurrences' un-stacked caches).  ``batch`` as for
    :func:`loss_fn`; a vision prefix takes the cache's first positions,
    so ``max_seq`` must hold it too."""
    h, _, encoder_out = _embed_inputs(params, batch, cfg, pc)
    positions = torch.arange(h.shape[1], device=h.device)
    caches = init_cache(cfg, pc, h.shape[0], max_seq, cache_dtype,
                        device=h.device)
    for gi, g in enumerate(blocks.scan_groups(cfg)):
        for i in range(g.count):
            p, c = _row_and_cache(params, caches, gi, g, i)
            h = blocks.row_prefill(p, h, g.kind, cfg, pc, positions, c,
                                   encoder_out, window=window)
    h = layers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_logits(params["embed"], h[:, -1:], cfg, pc)
    return logits, caches


def _row_and_cache(params: Params, caches: list, gi: int, g, i: int):
    """Row ``i`` of group ``gi``: its params (``shared_a`` for a shared
    group) and its cache (views, no copy)."""
    if g.shared:
        return params["shared_a"], caches[gi][i]
    return _layer(params[f"g{gi}"], i), _layer(caches[gi], i)


def init_cache(cfg: ModelConfig, pc: ParallelContext, batch: int,
               max_seq: int, cache_dtype=torch.bfloat16,
               window: Optional[int] = None, device=None):
    """This rank's zero decode cache (``blocks.row_cache_init``: at tp
    > 1 the KV cache's sequence and the Mamba state's channels sharded
    over tp); ``device="meta"`` probes shapes without allocating (the
    serving layout and the dry-run use that).  A shared group's entry
    is a list of one un-stacked cache per occurrence, as the
    reference's."""
    eff_seq = min(max_seq, window) if window else max_seq
    cross_len = cfg.encoder.source_len if cfg.encoder else 0
    device = resolve_device(device)
    return [[blocks.row_cache_init(g.kind, cfg, pc, batch, eff_seq,
                                   cache_dtype, device, None, cross_len)
             for _ in range(g.count)] if g.shared else
            blocks.row_cache_init(g.kind, cfg, pc, batch, eff_seq,
                                  cache_dtype, device, g.count, cross_len)
            for g in blocks.scan_groups(cfg)]


@torch.no_grad()
def decode_step(params: Params, caches: list, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, pc: ParallelContext,
                window: Optional[int] = None,
                active: Optional[torch.Tensor] = None):
    """One decode step.  tokens: (B, 1) int; pos: the position being
    decoded - 0-d (whole batch in lockstep) or (B,) (per-slot positions
    for the continuous-batching engine).  ``caches`` is updated IN PLACE
    (the reference returns new caches); with ``active`` ((B,) bool,
    vector ``pos``) only those slots' caches are written.  Returns
    (logits (B, 1, vocab_size), caches); at tp > 1 the ranks'
    vocabulary slices are gathered over the model axis, as the
    reference's."""
    h = layers.embed_tokens(params["embed"], tokens, cfg, pc)
    for gi, g in enumerate(blocks.scan_groups(cfg)):
        for i in range(g.count):
            p, c = _row_and_cache(params, caches, gi, g, i)
            h, _ = blocks.row_decode(p, h, g.kind, c, pos, cfg, pc,
                                     window=window, active=active)
    h = layers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_logits(params["embed"], h, cfg, pc)
    if pc.tp_active:
        # the vocabulary slices of every rank: one AllGather over tp
        logits = pc.comm.all_gather(logits.movedim(-1, 0),
                                    pc.tp_axis).movedim(0, -1)
    return logits[..., :cfg.vocab_size], caches
