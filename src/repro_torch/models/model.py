"""Top-level language model for serving: init, prefill, decode.

Port of the serving half of ``repro/models/model.py`` for decoder-only
text models built from ``a`` rows.  Params keep the reference's tree
(``embed``/``final_norm``/``g<i>`` groups with a leading layer axis), so
``params_from_numpy`` is a renaming, not a reshuffle.  Layer groups run
as Python loops where the reference runs ``lax.scan``; decode caches are
updated in place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext

Params = dict


# ----------------------------------------------------------------------- #
# init and interchange with the reference
# ----------------------------------------------------------------------- #

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, dtype=torch.float32) -> Params:
    """Random unsharded (tp = 1) params from ``generator``, which must
    live on ``device`` (``None``: the CUDA card; raises when there is
    none)."""
    tp = 1
    device = resolve_device(device)
    if cfg.frontend != "text" or cfg.encoder is not None:
        raise NotImplementedError(f"{cfg.name}: non-text frontends are "
                                  f"not ported yet (ROADMAP item 8)")
    params: Params = {
        "embed": layers.init_embedding(generator, cfg, tp, dtype, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=device),
    }
    for gi, g in enumerate(blocks.scan_groups(cfg)):
        params[f"g{gi}"] = blocks.init_row(generator, g.kind, cfg, tp,
                                           dtype, device, g.count)
    return params


def params_from_numpy(tree, device) -> Params:
    """The reference's params as numpy (``jax.tree.map(np.asarray,
    params)``) -> this package's params on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(resolve_device(device))


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
# serving: prefill + decode
# ----------------------------------------------------------------------- #

@torch.no_grad()
def prefill(params: Params, batch: dict, cfg: ModelConfig,
            pc: ParallelContext, max_seq: int,
            cache_dtype=torch.bfloat16, window: Optional[int] = None):
    """Full-sequence forward producing last-position logits (B, 1, V)
    and the decode cache (a list aligned with layer groups, each
    {'k','v'}: (layers, B, max_seq, n_kv, hd))."""
    tokens = batch["tokens"]
    h = layers.embed_tokens(params["embed"], tokens, cfg, pc)
    positions = torch.arange(h.shape[1], device=h.device)
    caches = init_cache(cfg, pc, h.shape[0], max_seq, cache_dtype,
                        device=h.device)
    for gi, g in enumerate(blocks.scan_groups(cfg)):
        for i in range(g.count):
            h = blocks.row_prefill(_layer(params[f"g{gi}"], i), h, g.kind,
                                   cfg, pc, positions,
                                   _layer(caches[gi], i), window=window)
    h = layers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_logits(params["embed"], h[:, -1:], cfg, pc)
    return logits, caches


def init_cache(cfg: ModelConfig, pc: ParallelContext, batch: int,
               max_seq: int, cache_dtype=torch.bfloat16,
               window: Optional[int] = None, device=None):
    """Zero decode cache; ``device="meta"`` probes shapes without
    allocating (the serving layout uses that)."""
    eff_seq = min(max_seq, window) if window else max_seq
    device = resolve_device(device)
    return [blocks.row_cache_init(g.kind, cfg, pc, batch, eff_seq,
                                  cache_dtype, device, g.count)
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
    (logits (B, 1, vocab_size), caches)."""
    h = layers.embed_tokens(params["embed"], tokens, cfg, pc)
    for gi, g in enumerate(blocks.scan_groups(cfg)):
        for i in range(g.count):
            h, _ = blocks.row_decode(_layer(params[f"g{gi}"], i), h,
                                     g.kind, _layer(caches[gi], i), pos,
                                     cfg, pc, window=window, active=active)
    h = layers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_logits(params["embed"], h, cfg, pc)
    return logits[..., :cfg.vocab_size], caches
