"""Collective -> transfer-schedule compiler (paper Sec. 4.3-4.5).

Every collective primitive is compiled into an explicit, ordered list of
pool *writes* (the publish phase) and pool *reads* (the retrieve phase) per
rank.  The placement of each block follows the interleaving math of
Sec. 4.3; the issue order follows the rotation rule ("start from
``(rank_id+1) % nranks``"); each chunk carries a doorbell index.

The same schedule drives three consumers:

* ``core.pool.execute`` executes it functionally against an in-memory pool
  (correctness oracle for the address math);
* ``core.simulator`` timestamps it under the pool's bandwidth/latency model
  (reproduces the paper's throughput numbers);
* the tuner prices it (``tuner.costmodel`` through the simulator).

Copied unchanged from ``repro.core.schedule`` (framework-free); the
port's deployable ``cxl`` path is ``core.mesh_collectives`` on
``core.pool.SharedPool``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.core import chunking
from repro_torch.core.doorbell import DOORBELL_BYTES
from repro_torch.core.interleave import (PoolLayout, Placement, publish_order,
                                   rank_partitioned, round_robin)

PRIMITIVES = ("broadcast", "scatter", "gather", "reduce", "all_gather",
              "reduce_scatter", "all_reduce", "all_to_all")

# Paper Table 2 taxonomy: type (1) rooted collectives use round-robin
# striping over ALL devices; type (2) N->N collectives use rank-partitioned
# device ownership (Eq. 4).
ROOTED = ("broadcast", "scatter", "gather", "reduce")
N_TO_N = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all")


class OpKind(enum.Enum):
    WRITE = "write"
    READ = "read"


@dataclasses.dataclass(frozen=True)
class TransferOp:
    """One pool transfer (a single cudaMemcpyAsync in the paper's terms)."""

    kind: OpKind
    rank: int                     # issuing rank
    device: int                   # CXL device touched
    pool_offset: int              # byte address within the unified pool space
    buf_offset: int               # byte offset within the local send/recv buf
    size: int                     # bytes
    doorbell: int                 # doorbell index guarding this chunk
    data_key: tuple               # (producer, segment, chunk) identity
    producer: int                 # rank that publishes this data
    reduce: bool = False          # read feeds a reduction (+=) not a copy


@dataclasses.dataclass
class Schedule:
    primitive: str
    nranks: int
    msg_bytes: int                # N in Table 2 (bytes per rank)
    layout: PoolLayout
    root: Optional[int]
    slicing_factor: int
    writes: dict[int, list[TransferOp]]   # rank -> ordered writeStream ops
    reads: dict[int, list[TransferOp]]    # rank -> ordered readStream ops
    num_doorbells: int

    def all_writes(self) -> list[TransferOp]:
        return [op for r in sorted(self.writes) for op in self.writes[r]]

    def all_reads(self) -> list[TransferOp]:
        return [op for r in sorted(self.reads) for op in self.reads[r]]

    def write_for(self, data_key: tuple) -> TransferOp:
        for ops in self.writes.values():
            for op in ops:
                if op.data_key == data_key:
                    return op
        raise KeyError(data_key)


class _Builder:
    """Accumulates ops while tracking per-rank write-issue counters (the
    counter doubles as ``data_id`` so consecutive publications round-robin
    across the rank's devices, cf. Fig. 6).

    ``placement='naive'`` models the CXL-CCL-Naive baseline (Sec. 5.1):
    memory is allocated sequentially from the bottom of the pool, so all
    traffic converges on device 0 (the hot-spot the interleaving removes).
    """

    def __init__(self, primitive: str, nranks: int, msg_bytes: int,
                 layout: PoolLayout, root: Optional[int],
                 slicing_factor: int, placement: str = "interleaved"):
        self.placement = placement
        self._naive_cursor = 0
        self.primitive = primitive
        self.nranks = nranks
        self.msg_bytes = msg_bytes
        self.layout = layout
        self.root = root
        self.slicing_factor = slicing_factor
        self.writes: dict[int, list[TransferOp]] = {r: [] for r in
                                                    range(nranks)}
        self.reads: dict[int, list[TransferOp]] = {r: [] for r in
                                                   range(nranks)}
        self._write_counter: dict[int, int] = {r: 0 for r in range(nranks)}
        self._placements: dict[tuple, Placement] = {}
        # Static per-rank write bound: at most one (segment, chunk) pair per
        # peer; used to stripe doorbell slots disjointly across ranks.
        self.max_writes_per_rank = 0  # set by build() before op emission

    def place(self, writer: int, rooted: bool,
              data_id: int | None = None,
              size: int | None = None) -> Placement:
        if data_id is None:
            data_id = self._write_counter[writer]
        self._write_counter[writer] += 1
        if self.placement == "naive":
            # Sequential allocation from the bottom of the pool: ignores
            # devices entirely, exactly what hardware would do without an
            # explicit placement mechanism (Sec. 4.2 challenge 1).
            off = self.layout.doorbell_region + self._naive_cursor
            self._naive_cursor += size if size is not None else \
                self.layout.block_size
            dev = off // self.layout.device_capacity
            return Placement(dev, data_id, off, doorbell_index=data_id)
        if rooted:
            return round_robin(self.layout, data_id)
        return rank_partitioned(self.layout, writer, self.nranks, data_id)

    def write(self, writer: int, buf_offset: int, size: int,
              data_key: tuple, rooted: bool,
              data_id: int | None = None) -> None:
        pl = self.place(writer, rooted, data_id, size=size)
        # Compact, statically computable doorbell slot: the builder knows
        # the per-rank write bound, so rooted placements use the global
        # data_id and partitioned ones get a per-rank stripe.
        if rooted:
            doorbell = pl.doorbell_index
        else:
            doorbell = writer * self.max_writes_per_rank + pl.doorbell_index
        pl = dataclasses.replace(pl, doorbell_index=doorbell)
        self._placements[data_key] = pl
        self.writes[writer].append(TransferOp(
            kind=OpKind.WRITE, rank=writer, device=pl.device_index,
            pool_offset=pl.device_location, buf_offset=buf_offset,
            size=size, doorbell=pl.doorbell_index, data_key=data_key,
            producer=writer))

    def read(self, reader: int, data_key: tuple, buf_offset: int,
             reduce: bool = False) -> None:
        pl = self._placements[data_key]
        producer = data_key[0]
        self.reads[reader].append(TransferOp(
            kind=OpKind.READ, rank=reader, device=pl.device_index,
            pool_offset=pl.device_location, buf_offset=buf_offset,
            size=self._size_of(data_key), doorbell=pl.doorbell_index,
            data_key=data_key, producer=producer, reduce=reduce))

    def _size_of(self, data_key: tuple) -> int:
        for ops in self.writes.values():
            for op in ops:
                if op.data_key == data_key:
                    return op.size
        raise KeyError(data_key)

    def finish(self) -> Schedule:
        dbs = max((op.doorbell for ops in self.writes.values()
                   for op in ops), default=0) + 1
        return Schedule(self.primitive, self.nranks, self.msg_bytes,
                        self.layout, self.root, self.slicing_factor,
                        self.writes, self.reads, num_doorbells=dbs)


def make_layout(num_devices: int, device_capacity: int, block_size: int,
                num_doorbells: int) -> PoolLayout:
    db_region = num_doorbells * DOORBELL_BYTES
    # Align the data region start to the block size for tidy addresses.
    db_region = (db_region + block_size - 1) // block_size * block_size
    return PoolLayout(num_devices=num_devices,
                      device_capacity=device_capacity,
                      doorbell_region=db_region, block_size=block_size)


def build(primitive: str, nranks: int, msg_bytes: int, *,
          num_devices: int = 6, device_capacity: int = 128 * 1024**3,
          slicing_factor: int = chunking.DEFAULT_SLICING_FACTOR,
          root: int = 0, granularity: int = 1,
          clamp_chunks: bool = True,
          placement: str = "interleaved") -> Schedule:
    """Compile ``primitive`` into a pool transfer schedule.

    ``msg_bytes`` follows Table 2's ``N``: the per-rank send size for all
    primitives except scatter, where the root holds ``N * nranks`` and each
    rank receives ``N``.
    """
    if primitive not in PRIMITIVES:
        raise ValueError(f"unknown primitive {primitive!r}")
    if nranks < 1:
        raise ValueError("nranks must be >= 1")
    if msg_bytes <= 0:
        raise ValueError("msg_bytes must be positive")

    rooted = primitive in ROOTED
    seg_bytes = msg_bytes // nranks if primitive in (
        "reduce_scatter", "all_to_all") else msg_bytes
    if primitive in ("reduce_scatter", "all_to_all"):
        if msg_bytes % nranks:
            raise ValueError(
                f"{primitive} needs msg_bytes divisible by nranks")
    chunks = chunking.split(seg_bytes, slicing_factor, clamp=clamp_chunks,
                            granularity=granularity)
    block_size = max(c.size for c in chunks)

    # Upper bound on doorbells: every (rank, segment, chunk) written.
    max_writes = nranks * nranks * len(chunks)
    layout = make_layout(num_devices, device_capacity, block_size,
                         num_doorbells=max_writes)
    b = _Builder(primitive, nranks, msg_bytes, layout, root if rooted else
                 None, slicing_factor, placement=placement)
    b.max_writes_per_rank = nranks * len(chunks)

    if primitive == "broadcast":
        _broadcast(b, chunks, root)
    elif primitive == "scatter":
        _scatter(b, chunks, root)
    elif primitive in ("gather", "reduce"):
        _gather(b, chunks, root, reduce=(primitive == "reduce"))
    elif primitive in ("all_gather", "all_reduce"):
        _all_gather(b, chunks, reduce=(primitive == "all_reduce"))
    elif primitive in ("reduce_scatter", "all_to_all"):
        _segmented_n_to_n(b, chunks,
                          reduce=(primitive == "reduce_scatter"))
    return b.finish()


def _broadcast(b: _Builder, chunks, root: int) -> None:
    """Root stripes its buffer over all devices (Eq. 1-3); every other rank
    reads all chunks, rotating its start offset so concurrent readers hit
    disjoint devices."""
    for c in chunks:
        b.write(root, c.offset, c.size, (root, 0, c.index), rooted=True)
    n = len(chunks)
    for r in range(b.nranks):
        if r == root:
            continue
        for i in range(n):
            c = chunks[(r + i) % n]
            b.read(r, (root, 0, c.index), c.offset)


def _scatter(b: _Builder, chunks, root: int) -> None:
    """Root writes one segment per destination rank, segments striped
    round-robin; rank i reads only segment i."""
    seg = b.msg_bytes
    order = publish_order(root, b.nranks)  # rotate segment publication
    for dest in order:
        if dest == root:
            continue  # root's own segment never travels through the pool
        for c in chunks:
            b.write(root, dest * seg + c.offset, c.size,
                    (root, dest, c.index), rooted=True)
    for r in range(b.nranks):
        if r == root:
            continue
        for c in chunks:
            b.read(r, (root, r, c.index), c.offset)
    # Root's own segment never travels through the pool (local copy).


def _gather(b: _Builder, chunks, root: int, reduce: bool) -> None:
    """Each non-root rank publishes its buffer; the root reads producers in
    rotated order.  For reduce, reads accumulate into the root's buffer.

    N->1 has many concurrent writers even though it is a "rooted" type, so
    the logical ``data_id`` is globalized as ``rank*F + chunk``: producers
    land on distinct devices (Eq. 1) instead of colliding on device 0."""
    nf = len(chunks)
    for r in range(b.nranks):
        if r == root:
            continue
        for c in chunks:
            b.write(r, c.offset, c.size, (r, 0, c.index), rooted=True,
                    data_id=r * nf + c.index)
    for p in publish_order(root, b.nranks):
        if p == root:
            continue
        for c in chunks:
            dst = c.offset if reduce else p * b.msg_bytes + c.offset
            b.read(root, (p, 0, c.index), dst, reduce=reduce)


def _all_gather(b: _Builder, chunks, reduce: bool) -> None:
    """N->N full-buffer exchange.  Writers stay inside their own device
    partition (Eq. 4); reader r pulls producers in ``publish_order(r)`` so
    reads rotate away from concurrent writes (Fig. 6).  ``reduce=True``
    turns this into the paper's AllReduce: every rank reduces everything
    locally (no partial-result reuse - Sec. 5.2)."""
    for r in range(b.nranks):
        for c in chunks:
            b.write(r, c.offset, c.size, (r, 0, c.index), rooted=False)
    for r in range(b.nranks):
        for p in publish_order(r, b.nranks):
            if p == r:
                continue
            for c in chunks:
                dst = c.offset if reduce else p * b.msg_bytes + c.offset
                b.read(r, (p, 0, c.index), dst, reduce=reduce)


def _segmented_n_to_n(b: _Builder, chunks, reduce: bool) -> None:
    """ReduceScatter / AllToAll: rank r publishes segment ``dest`` of its
    send buffer for every other rank, starting from ``(r+1) % nranks``
    (Fig. 6); then reads its own segment from every producer."""
    seg = b.msg_bytes // b.nranks
    for r in range(b.nranks):
        for dest in publish_order(r, b.nranks):
            if dest == r:
                continue  # own segment stays local
            for c in chunks:
                b.write(r, dest * seg + c.offset, c.size,
                        (r, dest, c.index), rooted=False)
    for r in range(b.nranks):
        for p in publish_order(r, b.nranks):
            if p == r:
                continue
            for c in chunks:
                dst = c.offset if reduce else p * seg + c.offset
                b.read(r, (p, r, c.index), dst, reduce=reduce)
