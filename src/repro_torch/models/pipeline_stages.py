"""Pipeline-parallel stage partitioning of the layer stack.

Port of ``repro.models.pipeline_stages``.  A pipeline stage owns a
contiguous slice of ``cfg.layer_pattern``: stage 0 also runs the
embedding, the last stage the final norm, the logits and the loss.  Two
consumers:

* **Cost modelling / placement** - ``partition_stages`` balances any
  pattern (dense, MoE, SSM, hybrid) into contiguous slices.
* **Execution** (``training.pipeline``) - the stacked layer params keep
  their single ``g0`` tree, split on the leading layer dim into one
  contiguous slab a stage (``stage_param_specs``: the stage axis in
  place of the layer dim), and every stage rank runs its slab with the
  same row body as ``model``'s group runner.  This path requires a
  uniform stack (``uniform_stage_rows``): one group, no shared
  attention, no encoder or frontend prefix, rows divisible by stages.

Embedding and final norm are replicated over the stage axis (the
embedding is used at both ends of the pipeline through the tied head);
their gradients are summed over the stage axis by
``training.pipeline.sync_stage_grads``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tree
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _layer, _maybe_remat
from repro_torch.models.pcontext import ParallelContext

Params = dict


@dataclasses.dataclass(frozen=True)
class StageSlice:
    """One pipeline stage's contiguous slice of the layer pattern."""
    index: int
    start: int            # first layer row (inclusive)
    stop: int             # past-the-end row
    pattern: str          # the rows this stage executes

    @property
    def count(self) -> int:
        return self.stop - self.start


def partition_stages(cfg: ModelConfig, n_stages: int) -> list[StageSlice]:
    """Balanced contiguous split of ``cfg.layer_pattern``: every stage
    gets ``floor(L/S)`` rows and the first ``L mod S`` stages one extra
    (the last stage already carries the logits/loss epilogue, so the
    remainder is front-loaded)."""
    n_rows = len(cfg.layer_pattern)
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    if n_stages > n_rows:
        raise ValueError(f"{n_stages} stages > {n_rows} layer rows")
    base, extra = divmod(n_rows, n_stages)
    out, start = [], 0
    for s in range(n_stages):
        cnt = base + (1 if s < extra else 0)
        out.append(StageSlice(s, start, start + cnt,
                              cfg.layer_pattern[start:start + cnt]))
        start += cnt
    return out


def uniform_stage_rows(cfg: ModelConfig, n_stages: int) -> int:
    """Rows per stage for the execution path, validating that the stack
    is uniform enough to split the stacked layer axis evenly (the
    reference's errors and messages)."""
    if cfg.encoder is not None or cfg.frontend != "text":
        raise NotImplementedError(
            "pipeline execution supports decoder-only text models")
    groups = blocks.scan_groups(cfg)
    if len(groups) != 1 or groups[0].shared:
        raise NotImplementedError(
            "pipeline execution needs a uniform layer stack (one scan "
            f"group); {cfg.name!r} has pattern {cfg.layer_pattern!r}")
    if n_stages < 1 or groups[0].count % n_stages:
        raise ValueError(
            f"{groups[0].count} layers not divisible by {n_stages} stages")
    return groups[0].count // n_stages


def stage_param_specs(abstract: Params, stage_axis: str,
                      base: Params | None = None) -> Params:
    """Specs (``models.sharding``'s tuples, one entry a dim) splitting
    the stacked layer axis over the stage axis: each stage rank holds its
    contiguous slab of rows.  Embedding and final norm stay replicated.
    ``base`` composes an existing spec tree: the stage axis replaces the
    layer-dim entry of the layer-stacked leaves and the other leaves
    keep their base spec."""
    def spec(path, x):
        if path[0].startswith("g"):
            rest = tuple(tree.get(base, path))[1:] if base is not None \
                else (None,) * (x.dim() - 1)
            return (stage_axis,) + rest
        if base is not None:
            return tuple(tree.get(base, path))
        return (None,) * x.dim()
    return tree.map_with_path(spec, abstract)


def stage_forward(slab: Params, h: torch.Tensor, cfg: ModelConfig,
                  pc: ParallelContext, positions: torch.Tensor,
                  remat: bool = True):
    """Run this rank's slab of layer rows (leading dim = local rows) with
    the same row body as ``model._run_groups``; under ``remat`` each row
    is checkpointed, as in ``model.loss_fn``.  Returns (h, aux_sum)."""
    kind = cfg.layer_pattern[0]

    def body(hh, p):
        return blocks.row_forward(p, hh, kind, cfg, pc, positions)

    body = _maybe_remat(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(tree.leaves(slab)[0].shape[0]):
        h, a = body(h, _layer(slab, i))
        aux = aux + a
    return h, aux
