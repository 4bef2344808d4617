"""Parameter sharding specs: FSDP over the data axis (the paper's Sec. 5.5
case study: FSDP AllGather before use, ReduceScatter on grads - both
through the ``Communicator``).

Port of ``repro.models.sharding``.  A spec is a plain tuple with one
entry per dim: an axis name, a tuple of names (a hierarchical dp axis,
outer level first) or None.  ``param_specs`` assigns:

* the tensor-parallel dim (over ``model``): Megatron column/row rules
  per leaf name, as the reference writes them (the Mamba leaves too:
  at tp = 1 the axis shards nothing, but it keeps the FSDP dim where
  the reference puts it); ``wk``/``wv`` stay
  replicated over ``model`` when tp does not divide the kv heads (with
  tp = 1 the axis has size 1, so it shards nothing);
* the FSDP dim (over the dp axis): the first remaining dim (after a
  stacked group's layer dim) that divides dp (a tuple axis: the product
  of its levels' sizes), for leaves of at least
  ``FSDP_MIN_SIZE`` elements.  Smaller leaves (norms) stay replicated
  and get their grads summed by ``sync_grads``, over every dp level and
  the model axis that does not shard them.

Axis names go through the placement alias registry
(``set_axis_aliases``, ``tuner.placement``) first, so specs built with
the logical names land on the mesh axes a placement chose.
"""
from __future__ import annotations

import collections
from typing import Any, Optional, Union

from repro_torch.core import tree
from repro_torch.models.pcontext import ParallelContext

FSDP_MIN_SIZE = 65536

# -- axis-name indirection (tuner.placement) -------------------------------
# Model code and the spec tables below speak logical axis names ("model",
# "data").  A placement may bind a logical axis to differently-named mesh
# axes - in particular split one logical axis across adjacent fabric
# levels, each a mesh axis of its own; the registry maps logical -> mesh
# axes at spec-construction time.

_AXIS_ALIASES: dict = {}


def set_axis_aliases(aliases: dict) -> None:
    """Install the placement's logical->mesh axis map, e.g.
    ``{"data": ("pod", "node")}``.  Values are a mesh axis name or a
    tuple of them (outermost first, the rank-major convention)."""
    _AXIS_ALIASES.clear()
    _AXIS_ALIASES.update(aliases)


def clear_axis_aliases() -> None:
    _AXIS_ALIASES.clear()


def resolve_axis(axis):
    """Map a logical axis spec (name or tuple of names) through the
    alias registry, flattening tuple-valued aliases.  Unaliased names
    pass through, so callers can resolve unconditionally."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        out: list = []
        for a in axis:
            r = _AXIS_ALIASES.get(a, a)
            out.extend(r) if isinstance(r, (tuple, list)) else \
                out.append(r)
        return tuple(out)
    r = _AXIS_ALIASES.get(axis, axis)
    return tuple(r) if isinstance(r, (tuple, list)) else r


# leaf name -> dim sharded over the model axis (None = replicated)
TP_DIM = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 0,
    "wg": None, "wu": None, "wd": None,    # resolved by rank below
    "tok": 0, "head": 1,
    "router": None,
    # Mamba rows: x/z/dt projections and their per-channel leaves column-
    # sharded, out_proj row-sharded; Mamba-2's B/C projection and its
    # conv replicated (B and C are shared across heads)
    "in_x": 1, "in_z": 1, "in_dt": 1, "in_bc": None,
    "conv_w": 0, "conv_x": 0, "conv_bc": None,
    "x_proj": 0, "dt_proj": 1, "dt_bias": 0,
    "A_log": 0, "D": 0, "norm": 0,
    "out_proj": 0,
    "norm1": None, "norm2": None, "norm_x": None,
    "final_norm": None, "enc_norm": None,
    "enc_proj": None, "front_proj": None,
}

# Axis sizes for spec construction; set by callers before building specs
# (module-level, as in the reference, so spec building stays a tree walk).
_MESH_SIZES: dict = {}


def set_mesh_sizes(sizes: dict) -> None:
    _MESH_SIZES.clear()
    _MESH_SIZES.update(sizes)


def _axes_of(axis) -> tuple:
    """The names of an axis spec: () for None, a name's 1-tuple, or the
    tuple itself."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _size(axis) -> int:
    n = 1
    for a in _axes_of(axis):
        n *= _MESH_SIZES.get(a, 1)
    return n


def _is_stacked(names: tuple) -> bool:
    """Group entries 'g<i>' hold layer-stacked params."""
    return any(n == "encoder" or (n.startswith("g") and n[1:].isdigit())
               for n in names[:-1])


def _tp_dim(names: tuple, rank: int, stacked: bool) -> Optional[int]:
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    base_rank = rank - (1 if stacked else 0)
    if leaf in ("wg", "wu", "wd"):
        if parent == "moe" or base_rank == 3:
            return 0
        return 1 if leaf in ("wg", "wu") else 0
    if leaf in ("wk", "wv") and parent in ("attn", "xattn"):
        return 1
    return TP_DIM.get(leaf)


def param_specs(params: Any, cfg, *, model_axis: str = "model",
                dp_axis: Union[str, tuple, None] = None,
                fsdp: bool = True) -> Any:
    """Spec tree matching ``params`` (tensors, meta tensors included).
    Axis names resolve through the alias registry first.  The encoder
    and the frontend projections stay dp-replicated: the model uses
    them outside the FSDP gather hook, as the reference does."""
    model_axis = resolve_axis(model_axis)
    dp_axis = resolve_axis(dp_axis)
    tp = _size(model_axis)
    dp = _size(dp_axis)

    def spec_for(names, leaf) -> tuple:
        shape = tuple(leaf.shape)
        rank = len(shape)
        stacked = _is_stacked(names)
        tp_d = _tp_dim(names, rank, stacked)
        if tp_d is not None and stacked:
            tp_d += 1
        if tp_d is not None and not cfg.kv_sharded(tp) and \
                names[-1] in ("wk", "wv"):
            tp_d = None
        dims: list = [None] * rank
        if tp_d is not None:
            dims[tp_d] = model_axis
        numel = 1
        for d in shape:
            numel *= d
        no_fsdp = any(n in ("encoder", "enc_proj", "front_proj")
                      for n in names)
        if fsdp and dp_axis is not None and not no_fsdp \
                and numel >= FSDP_MIN_SIZE:
            for i in range(1 if stacked else 0, rank):
                if dims[i] is None and shape[i] % dp == 0:
                    dims[i] = dp_axis
                    break
        return tuple(dims)

    return tree.map_with_path(spec_for, params)


def row_specs(specs: Any) -> Any:
    """Drop the leading (layer) dim of stacked specs: specs of one row's
    param slice, used by the per-row FSDP gather."""
    return tree.map_with_path(
        lambda names, s: s[1:] if _is_stacked(names) and s else s, specs)


def _dim_of(spec: tuple, axis) -> Optional[int]:
    for i, s in enumerate(spec):
        if s == axis:
            return i
    return None


def shard_params(full: Any, specs: Any, dp_axis, rank: int, n: int,
                 tp_axis: Optional[str] = None, tp_rank: int = 0,
                 tp: int = 1) -> Any:
    """This rank's shards of the GLOBAL params: each leaf's ``tp_rank``-th
    of ``tp`` equal slices along its ``tp_axis`` dim, then the
    ``rank``-th of ``n`` along its dp dim (contiguous copies);
    replicated leaves are copied whole.  For a tuple ``dp_axis``,
    ``rank`` is the rank-major index over its levels and ``n`` their
    product."""
    def shard(path, x):
        spec = tree.get(specs, path)
        tdim = _dim_of(spec, tp_axis) if tp > 1 else None
        if tdim is not None:
            x = x.chunk(tp, dim=tdim)[tp_rank]
        dim = _dim_of(spec, dp_axis)
        if dim is not None:
            x = x.chunk(n, dim=dim)[rank]
        return x.contiguous() if dim is not None or tdim is not None \
            else x.clone()
    return tree.map_with_path(shard, full)


def missing_axes(spec: tuple, dp_axis, tp_axis: Optional[str] = None
                 ) -> tuple:
    """The axes a leaf's grad must still be summed over, outer first:
    every dp level when the spec shards the leaf over none of them, then
    ``tp_axis`` (innermost) when it does not shard the leaf, as the
    reference's ``sync_grads`` orders them (``tp_axis`` None at tp =
    1)."""
    dp = _axes_of(dp_axis)
    have = set()
    for s in spec:
        have.update(_axes_of(s))
    out = dp if dp and not any(a in have for a in dp) else ()
    if tp_axis is not None and tp_axis not in have:
        out = out + (tp_axis,)
    return out


def sync_grads(grads: Any, specs: Any, pc: ParallelContext,
               dp_axis) -> Any:
    """Sum the grads of replicated params over the axes that do not
    shard them (FSDP leaves already got their dp sum through the
    gather's transpose; tp-sharded leaves are complete locally), as one
    AllReduce over the tuple of missing axes, dp levels first and the
    model axis innermost, so the Communicator can decompose it against
    the topology.  Per-leaf reference path;
    the trainer uses ``core.overlap.bucketed_sync_grads`` (same result,
    fused size-capped buffers)."""
    def fix(path, g):
        missing = missing_axes(tree.get(specs, path), dp_axis,
                               pc.tp_axis)
        if missing:
            g = pc.comm.all_reduce(
                g, missing[0] if len(missing) == 1 else missing)
        return g
    return tree.map_with_path(fix, grads)


def fsdp_gather_fn(all_row_specs: dict, pc: ParallelContext, dp_axis):
    """Returns gather(group_key, row_params) -> gathered params: one
    AllGather per dp-sharded leaf, whose autograd transpose is the
    matching ReduceScatter (per-leaf reference path; the trainer uses
    ``core.overlap.make_gather_fn``); ``gather.calls`` counts the calls
    by group key."""
    def gather(group_key: str, row_params):
        gather.calls[group_key] += 1
        specs = all_row_specs[group_key]

        def g(path, x):
            dim = _dim_of(tree.get(specs, path), dp_axis)
            if dim is None:
                return x
            full = pc.comm.all_gather(x.movedim(dim, 0), dp_axis)
            return full.movedim(0, dim)
        return tree.map_with_path(g, row_params)
    gather.calls = collections.Counter()
    return gather
