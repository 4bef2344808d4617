"""The flat collectives of the port, over a ``torch.distributed`` group.

Port of the flat primitives of ``repro.core.mesh_collectives`` (all_gather,
reduce_scatter, all_reduce in ``faithful`` and ``two_phase`` mode,
all_to_all, broadcast, reduce, gather, scatter, and the p2p ring shift),
with the reference's semantics: rank-major ``tiled`` layout along axis 0,
a leading dim that must divide the axis for reduce_scatter / all_to_all /
scatter (``ValueError``), padding in two-phase mode, and zeros on the
non-root ranks of reduce and gather.

Two realizations:

* ``ring_*`` - the group's built-in collectives (the baseline; what NCCL
  would do across cards).  The ranks of a one-card mesh run on ``gloo``,
  which takes CUDA tensors only for broadcast and all_reduce, so the other
  primitives stage CUDA tensors through the host.
* the plain names - the paper's pool schedules on the shared host pool
  (``core.pool.SharedPool``): every rank publishes its buffer into its own
  partition, consumers retrieve the byte ranges they need, and a reduce /
  reduce-scatter / all-reduce lands the N partials of the rank's segment
  in one (n_src, L) buffer that the ``chunked_reduce`` kernel sums.  The
  slicing factor is the number of doorbell-committed chunks per round
  (``core.pool.split_window``).  On the TPU the reference realized these
  schedules as ppermute rings; here they are what the paper built.

An ``AxisGroup`` is one flat level.  A hierarchical (tuple) axis is a
sequence of them, outer level first, and :func:`hierarchical_all_reduce`
composes per-level collectives that the caller injects (the
``Communicator`` picks each level's backend).  Every level group has its
own process group and its own pool, since a pool's epochs agree only
among ranks that issue the same collectives.

A grouped (ragged) level - a topology level with a shape vector such as
``(3, 1)`` - lives on one flat axis of ``sum(shape)`` ranks split into
contiguous rank groups (:class:`Grouping`).  Its schedules, ported from
the reference's masked ppermute rings, run each phase on the ranks that
take part: within-group work on this rank's group (its own process group
and pool), the exchange between the group sub-roots (each group's first
rank) on the sub-roots' group and pool, and the fan-out from this rank's
group root.  Under ``cxl`` every sum of N sources lands in one (N, L)
buffer that ``chunked_reduce`` sums (the faithful AllReduce on the
group); under ``ring`` the groups' own collectives do the work.  A group
of one rank has no group of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.pool import SharedPool
from repro_torch.kernels.chunked_reduce import chunked_reduce

DEFAULT_CHUNKS = 4


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One flat mesh axis: this rank's place in a process group, and the
    shared pool its ``cxl`` collectives run on (None: ring only).  An
    axis that a grouped topology level covers also carries its
    :class:`Grouping`."""

    name: str
    rank: int
    size: int
    group: Optional[dist.ProcessGroup] = None    # None: the default group
    pool: Optional[SharedPool] = None
    grouped: Optional["Grouping"] = None

    def global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def need_pool(self) -> SharedPool:
        if self.pool is None:
            raise ValueError(f"axis {self.name!r} has no shared pool: the "
                             f"cxl backend needs one")
        return self.pool


@dataclasses.dataclass(frozen=True)
class Grouping:
    """A grouped level's rank groups as this rank sees them: the shape
    vector (contiguous groups, ``(3, 1)``: ranks 0-2 and rank 3), this
    rank's group (``inner``; None for a group of one) and, on a sub-root
    when there is more than one group, the group of the sub-roots
    (``cross``; named after the level whose fabric carries it)."""

    shape: tuple
    inner: Optional[AxisGroup] = None
    cross: Optional[AxisGroup] = None


def hierarchical_all_reduce(x: torch.Tensor, levels: Sequence[AxisGroup],
                            *, rs_fn: Callable, ar_fn: Callable,
                            ag_fn: Callable) -> torch.Tensor:
    """Level-decomposed AllReduce over ``levels`` (outer level first):

        ReduceScatter innermost..levels[1]  ->  AllReduce over levels[0]
        on the 1/prod(inner) shard          ->  AllGather back out.

    Each byte crosses the outer (pool-spanning) fabric once, at
    1/prod(inner) of the payload.  ``rs_fn`` / ``ar_fn`` / ``ag_fn`` are
    ``(tensor, AxisGroup) -> tensor`` single-level collectives.  The
    flat payload is zero-padded to a multiple of prod(inner), as in the
    reference.
    """
    levels = tuple(levels)
    inner = levels[1:]
    prod_inner = 1
    for ax in inner:
        prod_inner *= ax.size
    flat = x.reshape(-1)
    pad = (-flat.numel()) % max(1, prod_inner)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    seg = flat
    for ax in reversed(inner):      # innermost level first
        seg = rs_fn(seg, ax)
    seg = ar_fn(seg, levels[0])     # the only traffic across the outer
    for ax in inner:                # inverse order back out
        seg = ag_fn(seg, ax)
    if pad:
        seg = seg[:-pad]
    return seg.reshape(x.shape)


class _MetaPool:
    """The pool of a meta trace: an exchange that moves nothing."""

    def exchange(self, *_args, **_kwargs) -> None:
        return None


META_POOL = _MetaPool()


def _meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def _pool(ax: AxisGroup, x: torch.Tensor):
    """The pool ``x``'s exchange runs on: ``META_POOL`` for a meta
    tensor, else the axis's (which must exist)."""
    return META_POOL if _meta(x) else ax.need_pool()


def _lead(x: torch.Tensor) -> int:
    return x.shape[0] if x.dim() else 1


def _check_divides(x: torch.Tensor, n: int) -> None:
    if _lead(x) % n:
        raise ValueError(f"leading dim {_lead(x)} must divide axis {n}")


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a contiguous tensor."""
    return x.reshape(-1).view(torch.uint8)


def _gathered_shape(x: torch.Tensor, n: int) -> tuple:
    return (n * _lead(x),) + tuple(x.shape[1:])


def _split_chunks(x: torch.Tensor, n_chunks: int) -> list:
    """Split along axis 0 (the paper's slicing factor), one chunk when
    the leading dim does not divide: the reference's rule.  The pool
    schedules commit ``len`` of it chunks per round, each behind its own
    doorbell."""
    lead = _lead(x)
    if n_chunks <= 1 or x.dim() == 0 or lead % n_chunks:
        return [x]
    return list(torch.split(x, lead // n_chunks))


def _segment(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rank 0's segment of ``x`` split over ``n`` ranks (for its shape)."""
    return x[:_lead(x) // n] if x.dim() else x


# --------------------------------------------------------------------- #
# ring: the group's built-in collectives
# --------------------------------------------------------------------- #

def _host(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().cpu()


def ring_all_gather(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    if ax.size == 1:
        return x
    if _meta(x):
        return x.new_empty(_gathered_shape(x, ax.size))
    out = torch.empty(_gathered_shape(x, ax.size), dtype=x.dtype)
    dist.all_gather_into_tensor(out, _host(x), group=ax.group)
    return out.to(x.device)


def ring_reduce_scatter(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    if ax.size == 1:
        return x
    _check_divides(x, ax.size)
    if _meta(x):
        return x.new_empty((x.shape[0] // ax.size,) + tuple(x.shape[1:]))
    out = torch.empty((x.shape[0] // ax.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype)
    dist.reduce_scatter_tensor(out, _host(x), group=ax.group)
    return out.to(x.device)


def ring_all_reduce(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    if ax.size == 1:
        return x
    if _meta(x):
        return torch.empty_like(x)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=ax.group)
    return out


def ring_all_max(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """The elementwise max over the axis: the group's ``MAX``
    AllReduce."""
    if ax.size == 1:
        return x
    if _meta(x):
        return torch.empty_like(x)
    out = _host(x).clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    return out.to(x.device)


def ring_all_to_all(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    if ax.size == 1:
        return x
    _check_divides(x, ax.size)
    if _meta(x):
        return torch.empty_like(x)
    out = torch.empty(x.shape, dtype=x.dtype)
    dist.all_to_all_single(out, _host(x), group=ax.group)
    return out.to(x.device)


def ring_broadcast(x: torch.Tensor, ax: AxisGroup,
                   root: int = 0) -> torch.Tensor:
    if _meta(x):
        return torch.empty_like(x)
    out = x.contiguous().clone()
    dist.broadcast(out, src=ax.global_rank(root), group=ax.group)
    return out


def ring_reduce(x: torch.Tensor, ax: AxisGroup,
                root: int = 0) -> torch.Tensor:
    if _meta(x):
        return torch.empty_like(x)
    out = _host(x).clone()
    dist.reduce(out, dst=ax.global_rank(root), group=ax.group)
    if ax.rank != root:
        return torch.zeros_like(x)
    return out.to(x.device)


def ring_gather(x: torch.Tensor, ax: AxisGroup,
                root: int = 0) -> torch.Tensor:
    if _meta(x):
        return x.new_empty(_gathered_shape(x, ax.size))
    parts = [torch.empty(x.shape, dtype=x.dtype) for _ in range(ax.size)] \
        if ax.rank == root else None
    dist.gather(_host(x), parts, dst=ax.global_rank(root), group=ax.group)
    if ax.rank != root:
        return torch.zeros(_gathered_shape(x, ax.size), dtype=x.dtype,
                           device=x.device)
    return torch.cat([p.reshape((_lead(x),) + tuple(x.shape[1:]))
                      for p in parts]).to(x.device)


def ring_scatter(x: torch.Tensor, ax: AxisGroup,
                 root: int = 0) -> torch.Tensor:
    _check_divides(x, ax.size)
    seg = (x.shape[0] // ax.size,) + tuple(x.shape[1:])
    if _meta(x):
        return x.new_empty(seg)
    parts = [p.contiguous() for p in _host(x).reshape(
        (ax.size,) + seg)] if ax.rank == root else None
    out = torch.empty(seg, dtype=x.dtype)
    dist.scatter(out, parts, src=ax.global_rank(root), group=ax.group)
    return out.to(x.device)


def ring_p2p(x: torch.Tensor, ax: AxisGroup, shift: int = 1) -> torch.Tensor:
    n = ax.size
    if n == 1 or shift % n == 0:
        return x
    if _meta(x):
        return torch.empty_like(x)
    out = torch.empty(x.shape, dtype=x.dtype)
    reqs = [dist.isend(_host(x), ax.global_rank((ax.rank + shift) % n),
                       group=ax.group),
            dist.irecv(out, ax.global_rank((ax.rank - shift) % n),
                       group=ax.group)]
    for r in reqs:
        r.wait()
    return out.to(x.device)


# --------------------------------------------------------------------- #
# cxl: the paper's schedules on the shared host pool
# --------------------------------------------------------------------- #

def _others(ax: AxisGroup) -> list:
    """Peers in the paper's read rotation, from (rank + 1) % n."""
    return [(ax.rank + t) % ax.size for t in range(1, ax.size)]


def all_gather(x: torch.Tensor, ax: AxisGroup,
               n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """Every rank publishes its shard; every rank retrieves the others'
    into a rank-major output (``tiled=True`` semantics)."""
    n = ax.size
    if n == 1:
        return x
    x = x.contiguous()
    s = x.numel() * x.element_size()
    out = torch.empty(_gathered_shape(x, n), dtype=x.dtype, device=x.device)
    ob = _bytes(out)
    ob[ax.rank * s:(ax.rank + 1) * s].copy_(_bytes(x))
    _pool(ax, x).exchange(_bytes(x), s,
                            [(p, 0, ob[p * s:(p + 1) * s])
                             for p in _others(ax)],
                            len(_split_chunks(x, n_chunks)))
    return out


def reduce_scatter(x: torch.Tensor, ax: AxisGroup,
                   n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """Rank r returns ``sum_ranks(x)[r*seg:(r+1)*seg]``: it retrieves the
    N partials of its own segment and reduces them locally."""
    n = ax.size
    if n == 1:
        return x
    _check_divides(x, n)
    x = x.contiguous()
    flat = x.reshape(-1)
    seg_len = flat.numel() // n
    sb = seg_len * flat.element_size()
    buf = torch.empty((n, seg_len), dtype=x.dtype, device=x.device)
    bb = _bytes(buf)
    xb = _bytes(flat)
    lo, hi = ax.rank * sb, (ax.rank + 1) * sb
    bb[lo:hi].copy_(xb[lo:hi])
    # nobody reads my own segment of my buffer: leave it unpublished
    _pool(ax, x).exchange(xb, flat.numel() * flat.element_size(),
                            [(p, lo, bb[p * sb:(p + 1) * sb])
                             for p in _others(ax)],
                            len(_split_chunks(_segment(x, n), n_chunks)),
                            skip=(lo, hi))
    return chunked_reduce(buf).reshape((x.shape[0] // n,)
                                       + tuple(x.shape[1:]))


def all_reduce(x: torch.Tensor, ax: AxisGroup, *, mode: str = "two_phase",
               n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """``faithful``: every rank retrieves every peer's full buffer and
    reduces locally (the paper's Sec. 5.2 algorithm).  ``two_phase``:
    reduce_scatter + all_gather of the padded flat buffer."""
    n = ax.size
    if n == 1:
        return x
    if mode == "faithful":
        return chunked_reduce(_stack(x, ax, n_chunks)).reshape(x.shape)
    if mode == "two_phase":
        flat = x.reshape(-1)
        pad = (-flat.numel()) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        seg = reduce_scatter(flat, ax, n_chunks=n_chunks)
        full = all_gather(seg, ax, n_chunks=n_chunks)
        if pad:
            full = full[:-pad]
        return full.reshape(x.shape)
    raise ValueError(f"unknown all_reduce mode {mode!r}")


def _stack(x: torch.Tensor, ax: AxisGroup, n_chunks: int) -> torch.Tensor:
    """Every rank's ``x`` flattened, rank-major in one (n, L) buffer:
    every rank retrieves every peer's full buffer."""
    x = x.contiguous()
    flat = x.reshape(-1)
    s = flat.numel() * flat.element_size()
    buf = torch.empty((ax.size, flat.numel()), dtype=x.dtype,
                      device=x.device)
    bb = _bytes(buf)
    bb[ax.rank * s:(ax.rank + 1) * s].copy_(_bytes(flat))
    _pool(ax, x).exchange(_bytes(flat), s,
                          [(p, 0, bb[p * s:(p + 1) * s])
                           for p in _others(ax)],
                          len(_split_chunks(x, n_chunks)))
    return buf


def all_max(x: torch.Tensor, ax: AxisGroup,
            n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """The elementwise max over the axis: the max of the faithful
    AllReduce's (n, L) stack."""
    if ax.size == 1:
        return x
    return _stack(x, ax, n_chunks).amax(dim=0).reshape(x.shape)


def all_to_all(x: torch.Tensor, ax: AxisGroup,
               n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """Segment p of the result is rank p's segment ``my_rank``."""
    n = ax.size
    if n == 1:
        return x
    _check_divides(x, n)
    x = x.contiguous()
    out = torch.empty_like(x)
    xb, ob = _bytes(x), _bytes(out)
    sb = xb.numel() // n
    lo, hi = ax.rank * sb, (ax.rank + 1) * sb
    ob[lo:hi].copy_(xb[lo:hi])
    _pool(ax, x).exchange(xb, xb.numel(),
                            [(p, lo, ob[p * sb:(p + 1) * sb])
                             for p in _others(ax)],
                            len(_split_chunks(_segment(x, n), n_chunks)),
                            skip=(lo, hi))
    return out


def broadcast(x: torch.Tensor, ax: AxisGroup, root: int = 0,
              n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """The root publishes; every other rank retrieves."""
    n = ax.size
    if n == 1:
        return x
    x = x.contiguous()
    k = len(_split_chunks(x, n_chunks))
    s = x.numel() * x.element_size()
    if ax.rank == root:
        _pool(ax, x).exchange(_bytes(x), s, [], k)
        return x
    out = torch.empty_like(x)
    _pool(ax, x).exchange(None, s, [(root, 0, _bytes(out))], k)
    return out


def reduce(x: torch.Tensor, ax: AxisGroup, root: int = 0,
           n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """The root retrieves every peer's buffer and reduces it; the other
    ranks publish and return zeros."""
    n = ax.size
    if n == 1:
        return x
    x = x.contiguous()
    k = len(_split_chunks(x, n_chunks))
    flat = x.reshape(-1)
    s = flat.numel() * flat.element_size()
    if ax.rank != root:
        _pool(ax, x).exchange(_bytes(flat), s, [], k)
        return torch.zeros_like(x)
    buf = torch.empty((n, flat.numel()), dtype=x.dtype, device=x.device)
    bb = _bytes(buf)
    bb[root * s:(root + 1) * s].copy_(_bytes(flat))
    _pool(ax, x).exchange(None, s, [(p, 0, bb[p * s:(p + 1) * s])
                                      for p in _others(ax)], k)
    return chunked_reduce(buf).reshape(x.shape)


def gather(x: torch.Tensor, ax: AxisGroup, root: int = 0,
           n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """Gather-to-root (rank order along axis 0); non-root ranks zeros."""
    n = ax.size
    if n == 1:
        return x
    x = x.contiguous()
    k = len(_split_chunks(x, n_chunks))
    s = x.numel() * x.element_size()
    if ax.rank != root:
        _pool(ax, x).exchange(_bytes(x), s, [], k)
        return torch.zeros(_gathered_shape(x, n), dtype=x.dtype,
                           device=x.device)
    out = torch.empty(_gathered_shape(x, n), dtype=x.dtype, device=x.device)
    ob = _bytes(out)
    ob[root * s:(root + 1) * s].copy_(_bytes(x))
    _pool(ax, x).exchange(None, s, [(p, 0, ob[p * s:(p + 1) * s])
                                      for p in _others(ax)], k)
    return out


def scatter(x: torch.Tensor, ax: AxisGroup, root: int = 0,
            n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """Rank r receives segment r of the root's axis 0."""
    n = ax.size
    if n == 1:
        return x
    _check_divides(x, n)
    x = x.contiguous()
    k = len(_split_chunks(x, n_chunks))
    seg = (x.shape[0] // n,) + tuple(x.shape[1:])
    xb = _bytes(x)
    sb = xb.numel() // n
    if ax.rank == root:
        lo, hi = root * sb, (root + 1) * sb
        _pool(ax, x).exchange(xb, xb.numel(), [], k, skip=(lo, hi))
        return x[root * seg[0]:(root + 1) * seg[0]]
    out = torch.empty(seg, dtype=x.dtype, device=x.device)
    _pool(ax, x).exchange(None, xb.numel(),
                            [(root, ax.rank * sb, _bytes(out))], k)
    return out


def p2p_shift(x: torch.Tensor, ax: AxisGroup, shift: int = 1,
              n_chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """Every rank sends ``x`` to the rank ``shift`` ahead and returns the
    payload from the rank ``shift`` behind (cyclic): a pool write, a
    doorbell commit and the consumer's read."""
    n = ax.size
    if n == 1 or shift % n == 0:
        return x
    x = x.contiguous()
    k = len(_split_chunks(x, n_chunks))
    out = torch.empty_like(x)
    _pool(ax, x).exchange(_bytes(x), x.numel() * x.element_size(),
                            [((ax.rank - shift) % n, 0, _bytes(out))], k)
    return out


# --------------------------------------------------------------------- #
# grouped / ragged schedules (irregular topology levels)
# --------------------------------------------------------------------- #

def _group_tables(group_shape) -> tuple:
    """Static per-rank tables for contiguous rank groups: returns
    (n, roots, group size per rank, position-in-group per rank,
    group root per rank)."""
    shape = tuple(int(g) for g in group_shape)
    if not shape or any(g < 1 for g in shape):
        raise ValueError(f"bad group shape {group_shape!r}")
    gsize, gpos, groot, roots = [], [], [], []
    start = 0
    for g in shape:
        roots.append(start)
        for p in range(g):
            gsize.append(g)
            gpos.append(p)
            groot.append(start)
        start += g
    return start, tuple(roots), gsize, gpos, groot


def _grouping(ax: AxisGroup) -> Grouping:
    """``ax``'s groups, checked against its size (the reference's
    ``_check_axis``)."""
    if ax.grouped is None:
        raise ValueError(f"axis {ax.name!r} carries no rank groups: build "
                         f"the mesh with the topology that groups it "
                         f"(launch.mesh.make_host_mesh(..., topology=))")
    want = sum(ax.grouped.shape)
    if want != ax.size:
        raise ValueError(f"group shape {ax.grouped.shape} spans {want} "
                         f"ranks but axis {ax.name!r} has {ax.size}")
    return ax.grouped


def _sum_on(x: torch.Tensor, sub: Optional[AxisGroup], backend: str,
            n_chunks: int) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``sub`` (None or one rank: x):
    under ``cxl`` every rank retrieves every peer's buffer and
    ``chunked_reduce`` sums the (N, L) stack (the faithful AllReduce)."""
    if sub is None or sub.size == 1:
        return x
    if backend == "ring":
        return ring_all_reduce(x, sub)
    return all_reduce(x, sub, mode="faithful", n_chunks=n_chunks)


def _from_root(x: torch.Tensor, sub: Optional[AxisGroup], backend: str,
               n_chunks: int) -> torch.Tensor:
    """Every rank of ``sub`` receives the value of its first rank (the
    group root); ``x`` off the root only gives the shape."""
    if sub is None or sub.size == 1:
        return x
    if backend == "ring":
        return ring_broadcast(x, sub, 0)
    return broadcast(x, sub, root=0, n_chunks=n_chunks)


def grouped_all_reduce(x: torch.Tensor, ax: AxisGroup,
                       n_chunks: int = DEFAULT_CHUNKS,
                       backend: str = "cxl") -> torch.Tensor:
    """AllReduce *within* each rank group of the grouped axis ``ax``:
    every rank returns its group's sum."""
    return _sum_on(x, _grouping(ax).inner, backend, n_chunks)


def subroot_all_reduce(x: torch.Tensor, ax: AxisGroup,
                       n_chunks: int = DEFAULT_CHUNKS,
                       backend: str = "cxl") -> torch.Tensor:
    """AllReduce *across* the group sub-roots (the first rank of each
    group); every other rank passes ``x`` through.  The only traffic
    between groups, on the parent level's fabric."""
    return _sum_on(x, _grouping(ax).cross, backend, n_chunks)


def grouped_broadcast(x: torch.Tensor, ax: AxisGroup,
                      n_chunks: int = DEFAULT_CHUNKS,
                      backend: str = "cxl") -> torch.Tensor:
    """Every rank receives its group sub-root's value."""
    return _from_root(x, _grouping(ax).inner, backend, n_chunks)


def ragged_all_reduce(x: torch.Tensor, ax: AxisGroup,
                      n_chunks: int = DEFAULT_CHUNKS, backend: str = "cxl",
                      cross_chunks: Optional[int] = None,
                      cross_backend: Optional[str] = None) -> torch.Tensor:
    """AllReduce over a grouped axis: within-group AllReduce, sub-root
    exchange across groups, grouped broadcast back out.  A sum over the
    whole axis (the flat AllReduce's result up to summation order).
    ``cross_chunks`` / ``cross_backend`` steer the sub-root hop (default:
    ``n_chunks`` / ``backend``)."""
    y = grouped_all_reduce(x, ax, n_chunks, backend)
    z = subroot_all_reduce(y, ax, cross_chunks or n_chunks,
                           cross_backend or backend)
    return grouped_broadcast(z, ax, n_chunks, backend)


def ragged_all_gather(x: torch.Tensor, ax: AxisGroup,
                      n_chunks: int = DEFAULT_CHUNKS, backend: str = "cxl",
                      cross_chunks: Optional[int] = None,
                      cross_backend: Optional[str] = None) -> torch.Tensor:
    """Padding-free all-gather over a grouped axis, rank-major along
    axis 0 (the flat ``all_gather``'s result exactly).

    Phase 1 gathers the group's shards at its sub-root, which writes
    them into a zeroed full-size buffer at the group's global offset;
    phase 2 sums the sub-roots' buffers across groups - the blocks sit at
    disjoint offsets, so the sum IS the concatenation; phase 3 fans the
    assembled buffer out within each group."""
    n = ax.size
    if n == 1:
        return x
    if x.dim() == 0:
        raise ValueError("ragged_all_gather needs at least 1-d input")
    gr = _grouping(ax)
    _, _, gsize, gpos, groot = _group_tables(gr.shape)
    x = x.contiguous()
    lead = x.shape[0]
    inner, g, root = gr.inner, gsize[ax.rank], groot[ax.rank]
    if inner is None:
        blk = x
    elif backend == "ring":
        blk = ring_gather(x, inner, 0)
    else:
        blk = gather(x, inner, root=0, n_chunks=n_chunks)
    if gpos[ax.rank] == 0:
        buf = x.new_zeros(_gathered_shape(x, n))
        buf[root * lead:(root + g) * lead] = blk
        buf = subroot_all_reduce(buf, ax, cross_chunks or n_chunks,
                                 cross_backend or backend)
    else:
        buf = x.new_empty(_gathered_shape(x, n))
    return grouped_broadcast(buf, ax, n_chunks, backend)


def ragged_reduce_scatter(x: torch.Tensor, ax: AxisGroup,
                          n_chunks: int = DEFAULT_CHUNKS,
                          backend: str = "cxl",
                          cross_chunks: Optional[int] = None,
                          cross_backend: Optional[str] = None
                          ) -> torch.Tensor:
    """Padding-free reduce-scatter over a grouped axis: rank r returns
    ``sum_ranks(x)[r*seg:(r+1)*seg]`` with ``seg = lead / sum(shape)``,
    the flat ``reduce_scatter``'s semantics.

    Phase 1 sums within each group, phase 2 completes every segment at
    once across the sub-roots (each carries its group's partial of every
    segment), phase 3 fans the group's segments out from its sub-root:
    each rank receives only its own rank-major segment."""
    n = ax.size
    if n == 1:
        return x
    _check_divides(x, n)
    gr = _grouping(ax)
    _, _, gsize, gpos, groot = _group_tables(gr.shape)
    seg = x.shape[0] // n
    g, root = gsize[ax.rank], groot[ax.rank]
    part = grouped_all_reduce(x.contiguous(), ax, n_chunks, backend)
    if gpos[ax.rank] == 0:
        full = subroot_all_reduce(part, ax, cross_chunks or n_chunks,
                                  cross_backend or backend)
        blk = full[root * seg:(root + g) * seg]
    else:
        blk = part[root * seg:(root + g) * seg]   # the shape only
    if gr.inner is None:
        return blk
    if backend == "ring":
        return ring_scatter(blk, gr.inner, 0)
    return scatter(blk.contiguous(), gr.inner, root=0, n_chunks=n_chunks)


def ragged_gather(x: torch.Tensor, ax: AxisGroup, root: int = 0,
                  n_chunks: int = DEFAULT_CHUNKS, backend: str = "cxl",
                  cross_chunks: Optional[int] = None,
                  cross_backend: Optional[str] = None) -> torch.Tensor:
    """Gather-to-root over a grouped axis (rank-major concatenation,
    zeros off the root), via the padding-free assembly of
    :func:`ragged_all_gather`."""
    full = ragged_all_gather(x, ax, n_chunks, backend, cross_chunks,
                             cross_backend)
    return full if ax.rank == root else torch.zeros_like(full)
