"""AdamW + schedules over nested-dict params.

Port of ``repro.optim.optimizer``.  The update is elementwise, so it is
shard-transparent: applied to a rank's FSDP shards it computes what it
would on the full arrays.  Unlike the reference, which returns new
arrays, ``adamw_update`` updates params and moments in place (under
``no_grad``), so a step holds no second copy of either.  Global-norm
clipping is not shard-transparent; like the reference, the sharded
trainer at tp = 1 clips each rank's local shards by their local norm
(the launcher passes ``clip_norm=None``).  Schedules are evaluated in
float32, as the reference's jnp code does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import tree


class AdamWState(NamedTuple):
    step: int
    mu: Any        # first moment (tree like params)
    nu: Any        # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def adamw_init(params: Any) -> AdamWState:
    def zeros(_path, x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return AdamWState(step=0, mu=tree.map_with_path(zeros, params),
                      nu=tree.map_with_path(zeros, params))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: AdamWState, lr: float,
                 cfg: AdamWConfig = AdamWConfig()) -> tuple:
    """Returns (params, new_state); params and moments are updated in
    place.  ``lr`` is a scalar (a schedule evaluated at state.step)."""
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1.0 - np.float32(b1) ** np.float32(step))
    bc2 = float(1.0 - np.float32(b2) ** np.float32(step))
    for path, p in tree.leaves_with_paths(params):
        g32 = tree.get(grads, path).float()
        m, v = tree.get(state.mu, path), tree.get(state.nu, path)
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).add_(g32.square(), alpha=1 - b2)
        # (m / bc1) / (sqrt(v / bc2) + eps), the same roundings with at
        # most two leaf-sized temporaries alive (a rank's shard of a
        # stacked group is 768 MiB at Phi-3-vision's width)
        delta = v.div(bc2).sqrt_().add_(cfg.eps)
        delta = m.div(bc1).div_(delta)
        if cfg.weight_decay and p.dim() >= 2:   # decay matrices only
            delta.add_(cfg.weight_decay * p.float())
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_((p.float() - delta).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> tuple:
    """Global-norm clip of the grads this process holds.  Returns
    (clipped, norm)."""
    sq = sum(g.float().square().sum() for g in tree.leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree.map_with_path(lambda _p, g: (g * scale).to(g.dtype),
                              grads), norm


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> Callable:
    f32 = np.float32

    def lr(step: int) -> float:
        t = np.clip(f32(step) / f32(total_steps), f32(0), f32(1))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t, dtype=f32))
        return float(f32(base_lr) * (f32(final_frac)
                                     + f32(1 - final_frac) * cos))
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int,
                         total_steps: int) -> Callable:
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup))

    def lr(step: int) -> float:
        if step < warmup:
            w = min(np.float32(1), np.float32(step) / np.float32(
                max(1, warmup)))
            return float(np.float32(base_lr) * w)
        return cos(step - warmup)
    return lr
