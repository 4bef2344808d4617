"""Communication/compute overlap: gradient bucketing and fused FSDP gathers.

Port of ``repro.core.overlap``; the dp axis may be a tuple of levels,
outer first:

* **Bucketing** (``assign_buckets`` + ``pack``/``unpack``): same-dtype
  leaves that want the same collective are coalesced, in deterministic
  leaf order, into size-capped flat buffers; ``bucketed_sync_grads``
  issues one AllReduce per bucket instead of one per leaf, and
  ``make_gather_fn`` one FSDP AllGather per row bucket, whose autograd
  transpose is the matching fused ReduceScatter.
* **Fused gathers** (``fuse=True``): the 2-D matmul weights gather in
  their own bucket inside ``ledger.fused()`` and come back as
  :class:`StackedShards` - the rank-major (n, Ks, N) stack, a strided
  view of the gathered bucket - which ``models.layers.dense`` streams
  through the ``all_gather_matmul`` kernel without concatenating it.

Packing is pure data movement, so fused collectives are numerically the
per-leaf ones.  The prefetch schedule lives in ``models.model``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import ledger, tree
from repro_torch.models.sharding import missing_axes

MiB = 1024 ** 2

# NCCL's default fused-gradient-buffer cap is 25 MB; same default here.
DEFAULT_BUCKET_BYTES = 25 * MiB


class StackedShards:
    """A gathered FSDP weight kept in rank-major stacked form (n, Ks, N)
    instead of concatenated (n*Ks, N); ``models.layers.dense``
    dispatches on this type."""

    def __init__(self, shards: torch.Tensor):
        self.shards = shards

    def __repr__(self):
        return f"StackedShards(shape={tuple(self.shards.shape)})"


# Matmul weights the fused all_gather+matmul kernel may consume: 2-D,
# dp-sharded on dim 0 (the contraction dim of the ``x @ w`` that eats
# them).  Everything else gathers on the ordinary concatenated path.
FUSABLE_PARAMS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd"})


@dataclasses.dataclass(frozen=True)
class Slot:
    """One leaf's position inside a fused flat buffer."""

    index: int          # position in the caller's flat leaf list
    offset: int         # element offset into the bucket buffer
    size: int           # element count
    shape: tuple        # shape to restore on unpack


@dataclasses.dataclass(frozen=True)
class Bucket:
    key: tuple          # (group_key, dtype name)
    slots: tuple        # tuple[Slot, ...] in deterministic leaf order
    elems: int          # total element count of the fused buffer


def assign_buckets(entries: Sequence[tuple],
                   cap_bytes: Optional[int]) -> list:
    """Greedy size-capped bucket assignment of ``(index, shape, dtype,
    group_key)`` entries, grouped by (group_key, dtype); a leaf larger
    than the cap gets its own bucket.  ``cap_bytes=None`` fuses each
    group into one bucket; ``cap_bytes <= 0`` gives one bucket per
    leaf."""
    groups: dict = {}
    order: list = []
    for index, shape, dtype, group_key in entries:
        key = (group_key, str(dtype).replace("torch.", ""))
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((index, tuple(shape), dtype.itemsize))
    buckets: list = []
    for key in order:
        slots: list = []
        elems = nbytes = 0
        for index, shape, itemsize in groups[key]:
            size = 1
            for d in shape:
                size *= int(d)
            leaf_bytes = size * itemsize
            if slots and cap_bytes is not None and (
                    cap_bytes <= 0 or nbytes + leaf_bytes > cap_bytes):
                buckets.append(Bucket(key=key, slots=tuple(slots),
                                      elems=elems))
                slots, elems, nbytes = [], 0, 0
            slots.append(Slot(index=index, offset=elems, size=size,
                              shape=shape))
            elems += size
            nbytes += leaf_bytes
        if slots:
            buckets.append(Bucket(key=key, slots=tuple(slots),
                                  elems=elems))
    return buckets


def pack(bucket: Bucket, leaves: Sequence) -> torch.Tensor:
    """Fuse the bucket's leaves into one flat 1-D buffer."""
    parts = [leaves[s.index].reshape(-1) for s in bucket.slots]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unpack(bucket: Bucket, flat: torch.Tensor) -> list:
    """Inverse of ``pack``: [(index, leaf)] restored to slot shapes."""
    return [(s.index, flat[s.offset:s.offset + s.size].reshape(s.shape))
            for s in bucket.slots]


def _axis_dim(spec: tuple, axis) -> Optional[int]:
    for i, s in enumerate(spec):
        if s == axis:
            return i
    return None


def bucketed_sync_grads(grads: Any, specs: Any, pc, dp_axis,
                        bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> Any:
    """Fused ``models.sharding.sync_grads``: grads of leaves replicated
    over dp levels or the model axis, coalesced by (missing axes, dtype)
    into size-capped flat buffers, one AllReduce (sum) each over the
    tuple of missing axes (``("data", "model")`` for a norm at tp > 1) -
    the per-leaf path's collective."""
    items = tree.leaves_with_paths(grads)
    entries = []
    for i, (path, g) in enumerate(items):
        missing = missing_axes(tree.get(specs, path), dp_axis, pc.tp_axis)
        if missing:
            entries.append((i, g.shape, g.dtype, missing))
    out = [g for _, g in items]
    for bucket in assign_buckets(entries, bucket_bytes):
        missing = bucket.key[0]
        flat = pc.comm.all_reduce(
            pack(bucket, out), missing[0] if len(missing) == 1 else missing)
        for index, leaf in unpack(bucket, flat):
            out[index] = leaf
    return tree.from_paths([(p, g) for (p, _), g in zip(items, out)])


def make_gather_fn(all_row_specs: dict, pc, dp_axis,
                   bucket_bytes: Optional[int] = None,
                   fuse: bool = False):
    """Returns ``gather(group_key, row_params) -> gathered params``.

    Every leaf sharded over the dp axis is moved to dim 0, raveled and
    fused with its same-dtype neighbours into flat buffers; one
    AllGather per bucket replaces one per leaf, and the per-leaf blocks
    are sliced back out of the rank-major result with reshapes, so the
    autograd transpose is the matching fused ReduceScatter.
    ``fuse=True`` routes the 2-D matmul weights (``FUSABLE_PARAMS``)
    through their own bucket, gathered inside ``ledger.fused()`` and
    returned as :class:`StackedShards`.  Over a tuple axis the gather is
    rank-major over all its levels, so the stack holds the product of
    their sizes in shards.  The gather runs over the dp axis only: a
    leaf's model-axis shard stays local (at tp > 1, ``wq``/``wk``/
    ``wv``/``wg``/``wu`` stack their dp shards of this rank's columns;
    ``wo``/``wd``, dp-sharded on dim 1, gather concatenated).
    ``gather.calls`` counts the calls by group key (a remat replay's
    too)."""
    def gather(group_key: str, row_params):
        gather.calls[group_key] += 1
        specs = all_row_specs[group_key]
        items = tree.leaves_with_paths(row_params)
        n_total = pc.comm.axis_size(dp_axis)
        moved: dict = {}
        dims: dict = {}
        entries = []
        fused_ix = set()
        for i, (path, x) in enumerate(items):
            dim = _axis_dim(tree.get(specs, path), dp_axis)
            if dim is None:
                continue
            m = x.movedim(dim, 0)
            moved[i] = m
            dims[i] = dim
            fusable = (fuse and path[-1] in FUSABLE_PARAMS and dim == 0
                       and m.dim() == 2)
            if fusable:
                fused_ix.add(i)
            entries.append((i, m.shape, m.dtype,
                            ("fused",) if fusable else ()))

        out = [x for _, x in items]
        src = [moved.get(i, x) for i, x in enumerate(out)]
        for bucket in assign_buckets(entries, bucket_bytes):
            is_fused = bucket.key[0] == ("fused",)
            flat = pack(bucket, src)
            with ledger.fused(is_fused):
                full = pc.comm.all_gather(flat, dp_axis)
            blocks = full.reshape(n_total, bucket.elems)
            for s in bucket.slots:
                m = blocks[:, s.offset:s.offset + s.size].reshape(
                    (n_total,) + s.shape)
                if s.index in fused_ix:
                    # keep the rank-major shard stack: the consuming
                    # matmul streams it without concatenation
                    out[s.index] = StackedShards(m)
                    continue
                m = m.reshape((n_total * s.shape[0],) + s.shape[1:])
                out[s.index] = m.movedim(0, dims[s.index])
        return tree.from_paths([(p, x) for (p, _), x in zip(items, out)])
    gather.calls = collections.Counter()
    return gather
