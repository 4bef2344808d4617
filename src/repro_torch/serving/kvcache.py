"""Paged KV-cache management: HBM block accounting + pool-resident tier.

Port of ``repro/serving/kvcache.py``.  The engine keeps its numeric
decode state as one dense slot-major cache (batch axis = decode slots)
on the device.  Everything *around* that state is paged:

* :class:`BlockManager` (framework-free copy) accounts HBM in fixed
  ``block_tokens`` blocks with refcounted, hash-chained prefix blocks;
* :class:`CacheLayout` maps between one slot of the dense cache and a
  canonical byte image, byte-identical to the reference's (leaves in
  sorted-key order, each slot slice in C order), so pool images
  interchange between the two packages.  Slots are sliced on the device
  and only the slot's bytes cross to the host, and insertion writes the
  cache IN PLACE where the reference builds a new pytree;
* :class:`PooledKVStore` (framework-free copy) is the pool-resident
  tier: payloads in a ``core.pool.PoolBlockAllocator`` region, each
  entry committed by ringing a ``DoorbellRegion`` doorbell after its
  payload blocks land, cross-engine sharing in ``RefcountRegion`` words.

Placement is priced like wire traffic: :func:`price_kv_block` compares
the pool round-trip against recomputing the tokens (prefill roofline on
the H100), yielding a ``Choice`` with backend ``"pool"`` or
``"recompute"`` that is recorded in the ledger.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ledger
from repro_torch.core.doorbell import DoorbellRegion, RefcountRegion
from repro_torch.core.hw import CXL_POOL, H100_SXM, CXLPoolConfig
from repro_torch.core.pool import PoolBlockAllocator
from repro_torch.tuner.costmodel import roofline_compute_time
from repro_torch.tuner.plan import Choice, Plan


def cache_leaves(tree) -> list:
    """Leaves of a cache tree in ``jax.tree.leaves`` order: lists in
    order, dict keys sorted (``k`` before ``v``)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in cache_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in cache_leaves(item)]
    return [tree]


def tensor_bytes(t: torch.Tensor) -> bytes:
    """C-order bytes of a tensor (copied to the host)."""
    return t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy() \
        .tobytes()


def tensor_from_bytes(data: bytes, offset: int, shape, dtype: torch.dtype,
                      device) -> torch.Tensor:
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    raw = np.frombuffer(data, np.uint8, count=nbytes, offset=offset).copy()
    return torch.from_numpy(raw).view(dtype).reshape(shape).to(device)


# -- dense-slot <-> bytes mapping ------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One cache leaf: where its batch/seq axes live."""

    shape: tuple
    dtype: torch.dtype
    batch_axis: int
    seq_axis: Optional[int]     # None: no per-token extent (ring buffers)

    def slot_seq_axis(self) -> int:
        """The seq axis once the batch axis is indexed away."""
        return self.seq_axis - (1 if self.batch_axis < self.seq_axis
                                else 0)


def _diff_axis(a, b) -> Optional[int]:
    axes = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    if not axes:
        return None
    if len(axes) > 1:
        raise ValueError(f"ambiguous axis between {a} and {b}")
    return axes[0]


class CacheLayout:
    """Structural map of the engine's cache.

    Axes are derived by probing ``model.init_cache`` shapes on the
    ``meta`` device (no allocation) at two batch sizes and two
    ``max_seq`` values: the axis that scales with batch is the slot
    axis, the axis that scales with ``max_seq`` is the token axis.
    Leaves that scale with neither (every leaf under a sliding
    ``window`` shorter than the sequence) carry no per-token extent and
    are serialized whole.
    """

    def __init__(self, cfg, pc, batch: int, max_seq: int, cache_dtype,
                 window: Optional[int] = None):
        from repro_torch.models import model
        self.batch = int(batch)
        self.max_seq = int(max_seq)
        self.window = window
        self.eff_seq = min(max_seq, window) if window else max_seq

        def probe(b, s):
            return cache_leaves(model.init_cache(
                cfg, pc, b, s, cache_dtype=cache_dtype, window=window,
                device="meta"))

        self.leaves: list[LeafSpec] = []
        for lr, lb, ls in zip(probe(batch, max_seq),
                              probe(batch + 1, max_seq),
                              probe(batch, max_seq * 2)):
            b_ax = _diff_axis(lr.shape, lb.shape)
            if b_ax is None:
                raise ValueError(f"cache leaf {tuple(lr.shape)} has no "
                                 f"batch axis")
            self.leaves.append(LeafSpec(
                shape=tuple(lr.shape), dtype=lr.dtype, batch_axis=b_ax,
                seq_axis=_diff_axis(lr.shape, ls.shape)))

    # A cache is block-sharable when *every* leaf has a token axis:
    # then a [t0, t1) token range is a complete, self-contained slice
    # of decode state.  Ring-buffer windows break that.
    @property
    def block_sharable(self) -> bool:
        return all(sp.seq_axis is not None for sp in self.leaves)

    def _ntok(self, ntok: int) -> int:
        return min(int(ntok), self.eff_seq)

    def _chunk_shape(self, sp: LeafSpec, n: Optional[int]) -> list:
        shape = list(sp.shape)
        del shape[sp.batch_axis]
        if sp.seq_axis is not None and n is not None:
            shape[sp.slot_seq_axis()] = n
        return shape

    def bytes_for(self, ntok: int) -> int:
        """Image size of one slot holding ``ntok`` tokens."""
        n = self._ntok(ntok)
        return sum(int(np.prod(self._chunk_shape(sp, n), dtype=np.int64))
                   * sp.dtype.itemsize for sp in self.leaves)

    def bytes_for_range(self, t0: int, t1: int) -> int:
        """Image size of a [t0, t1) token range (block-sharable only)."""
        return sum(int(np.prod(self._chunk_shape(sp, t1 - t0),
                               dtype=np.int64)) * sp.dtype.itemsize
                   for sp in self.leaves)

    # -- views of one slot (device side, no copy) -------------------------

    def _slot_views(self, caches, slot: int, t0: int,
                    t1: Optional[int]) -> list:
        """Per leaf: the slot's [t0, t1) token view (whole slot for
        token-free leaves or ``t1=None``)."""
        out = []
        for leaf, sp in zip(cache_leaves(caches), self.leaves):
            view = leaf.select(sp.batch_axis, slot)
            if sp.seq_axis is not None and t1 is not None:
                view = view.narrow(sp.slot_seq_axis(), t0, t1 - t0)
            out.append(view)
        return out

    # -- extraction / insertion (canonical byte order) --------------------

    def extract_slot(self, caches, slot: int, ntok: int) -> bytes:
        """Serialize slot ``slot``'s first ``ntok`` tokens of state.  The
        slot is sliced on the device; only its bytes reach the host."""
        n = self._ntok(ntok)
        return b"".join(tensor_bytes(v)
                        for v in self._slot_views(caches, slot, 0, n))

    def insert_slot(self, caches, slot: int, ntok: int, data: bytes):
        """Inverse of :meth:`extract_slot`, IN PLACE: slot ``slot`` holds
        exactly the image afterwards (positions beyond ``ntok`` zeroed,
        so a restored slot is canonical).  Returns ``caches``."""
        n = self._ntok(ntok)
        if len(data) != self.bytes_for(ntok):
            raise ValueError(f"cache image is {len(data)} bytes, slot "
                             f"at {ntok} tokens needs "
                             f"{self.bytes_for(ntok)}")
        off = 0
        for whole, part, sp in zip(self._slot_views(caches, slot, 0, None),
                                   self._slot_views(caches, slot, 0, n),
                                   self.leaves):
            shape = tuple(part.shape)
            chunk = tensor_from_bytes(data, off, shape, sp.dtype,
                                      whole.device)
            off += chunk.numel() * sp.dtype.itemsize
            whole.zero_()
            part.copy_(chunk)
        return caches

    def copy_slot(self, caches, slot: int, src_caches, src_slot: int,
                  ntok: int):
        """Device-side twin of ``insert_slot(caches, slot, ntok,
        extract_slot(src_caches, src_slot, ntok))`` for a source cache of
        the same structure (e.g. a batch-1 prefill): the same bytes land,
        without the host round trip.  IN PLACE; returns ``caches``."""
        n = self._ntok(ntok)
        for whole, part, src in zip(
                self._slot_views(caches, slot, 0, None),
                self._slot_views(caches, slot, 0, n),
                self._slot_views(src_caches, src_slot, 0, n)):
            whole.zero_()
            part.copy_(src)
        return caches

    def extract_token_range(self, caches, slot: int, t0: int,
                            t1: int) -> bytes:
        """Serialize a token range of one slot (block-sharable only)."""
        if not self.block_sharable:
            raise ValueError("cache layout has token-free leaves; "
                             "ranges are not self-contained")
        return b"".join(tensor_bytes(v)
                        for v in self._slot_views(caches, slot, t0, t1))

    def insert_token_range(self, caches, slot: int, t0: int, t1: int,
                           data: bytes):
        """Write a token range of one slot IN PLACE; returns ``caches``."""
        if not self.block_sharable:
            raise ValueError("cache layout has token-free leaves; "
                             "ranges are not self-contained")
        if len(data) != self.bytes_for_range(t0, t1):
            raise ValueError("token-range image size mismatch")
        off = 0
        for part, sp in zip(self._slot_views(caches, slot, t0, t1),
                            self.leaves):
            chunk = tensor_from_bytes(data, off, tuple(part.shape),
                                      sp.dtype, part.device)
            off += chunk.numel() * sp.dtype.itemsize
            part.copy_(chunk)
        return caches


# -- HBM block accounting --------------------------------------------------

def chain_hashes(tokens, block_tokens: int) -> list:
    """Rolling content hash per complete token block: block i's hash
    covers tokens [0, (i+1)*block_tokens), so equal hashes mean equal
    *prefixes*, which is what makes them pool-addressable."""
    out = []
    h = b""
    toks = list(int(t) for t in tokens)
    for i in range(len(toks) // block_tokens):
        blk = toks[i * block_tokens:(i + 1) * block_tokens]
        h = hashlib.sha256(
            h + np.asarray(blk, np.int64).tobytes()).hexdigest()
        out.append(h)
        h = h.encode()
    return out


class BlockManager:
    """HBM accounting in fixed-size token blocks with refcounted,
    hash-chained prefix sharing.

    Purely host-side bookkeeping (the numeric state lives in the dense
    slot cache): per-request block tables, a free list, and a
    hash -> block directory so two requests with the same prompt prefix
    pin the same logical blocks (refcount 2) instead of two copies.
    ``alloc``/``append`` raise ``MemoryError`` when the budget is
    exhausted - the scheduler turns that into preemption.
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks <= 0 or block_tokens <= 0:
            raise ValueError("num_blocks/block_tokens must be positive")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref: dict = {}        # block id -> refcount
        self._by_hash: dict = {}    # chain hash -> block id
        self._hash_of: dict = {}    # block id -> chain hash
        self._tables: dict = {}     # request key -> [block ids]
        self._ntok: dict = {}       # request key -> tokens held
        self.shared_block_hits = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for(self, ntok: int) -> int:
        return -(-int(ntok) // self.block_tokens)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def table(self, key) -> list:
        return list(self._tables[key])

    def tokens_held(self, key) -> int:
        return self._ntok[key]

    def holders(self) -> list:
        return list(self._tables)

    def can_fit(self, ntok: int, hashes=()) -> bool:
        need = self.blocks_for(ntok)
        reused = sum(1 for h in hashes if h in self._by_hash)
        return need - min(reused, need) <= len(self._free)

    def alloc(self, key, ntok: int, hashes=()) -> list:
        """Allocate ``key``'s table for ``ntok`` tokens.  ``hashes`` is
        the prompt's chain-hash list (complete blocks only): matching
        blocks are shared (refcount bump) instead of allocated."""
        if key in self._tables:
            raise ValueError(f"request {key!r} already holds blocks")
        need = self.blocks_for(ntok)
        table = []
        try:
            for i in range(need):
                h = hashes[i] if i < len(hashes) else None
                if h is not None and h in self._by_hash:
                    b = self._by_hash[h]
                    self._ref[b] += 1
                    self.shared_block_hits += 1
                else:
                    if not self._free:
                        raise MemoryError(
                            f"HBM block budget exhausted "
                            f"({self.used_blocks}/{self.num_blocks} "
                            f"used)")
                    b = self._free.pop()
                    self._ref[b] = 1
                    if h is not None:
                        self._by_hash[h] = b
                        self._hash_of[b] = h
                table.append(b)
        except MemoryError:
            self._release(table)
            raise
        self._tables[key] = table
        self._ntok[key] = int(ntok)
        return list(table)

    def append(self, key, n: int = 1) -> None:
        """Grow ``key`` by ``n`` decode tokens (new blocks unhashed)."""
        table = self._tables[key]
        ntok = self._ntok[key] + int(n)
        grown = []
        try:
            while len(table) < self.blocks_for(ntok):
                if not self._free:
                    raise MemoryError(
                        f"HBM block budget exhausted growing "
                        f"{key!r} ({self.used_blocks}/"
                        f"{self.num_blocks} used)")
                b = self._free.pop()
                self._ref[b] = 1
                table.append(b)
                grown.append(b)
        except MemoryError:
            for b in grown:
                table.remove(b)
            self._release(grown)
            raise
        self._ntok[key] = ntok

    def free(self, key) -> None:
        self._release(self._tables.pop(key))
        del self._ntok[key]

    def _release(self, blocks) -> None:
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                h = self._hash_of.pop(b, None)
                if h is not None:
                    del self._by_hash[h]
                self._free.append(b)


# -- pool-resident tier ----------------------------------------------------

@dataclasses.dataclass
class _PoolEntry:
    index: int          # doorbell / refcount word index
    blocks: list        # pool block ids, payload order
    nbytes: int


class PooledKVStore:
    """Hash-addressed KV pages in pool memory, doorbell-committed.

    Payload bytes live in a :class:`PoolBlockAllocator` region (every
    access through the pool fault shim with bounded retries); entry
    ``i``'s commit doorbell and cross-engine refcount are the words at
    index-calculated addresses ``i * DOORBELL_BYTES`` in their regions.
    The publish protocol is write-payload -> set-refcount -> ring:
    a reader that finds the doorbell STALE treats the entry as absent,
    so a half-written entry is never served.  When the region fills,
    the least-recently-used entry with a zero refcount word is
    reclaimed; pinned (acquired) entries never are.

    One store instance shared by several engines *is* the
    cross-replica prefix cache: keys are content-derived (chain
    hashes), so identical system prompts collide on purpose.
    """

    def __init__(self, budget_bytes: int, *, block_bytes: int = 1 << 16,
                 max_entries: int = 512,
                 cfg: Optional[CXLPoolConfig] = None):
        self.alloc = PoolBlockAllocator(budget_bytes, block_bytes,
                                        cfg or CXL_POOL)
        self.doorbells = DoorbellRegion(max_entries)
        self.refs = RefcountRegion(max_entries)
        self.max_entries = int(max_entries)
        self._dir: "OrderedDict[object, _PoolEntry]" = OrderedDict()
        self._free_idx = list(range(max_entries - 1, -1, -1))
        # Telemetry + modeled cost.
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.dropped = 0
        self.reclaimed = 0
        self.predicted_write_s = 0.0
        self.predicted_read_s = 0.0

    def __contains__(self, key) -> bool:
        e = self._dir.get(key)
        return e is not None and self.doorbells.is_ready(e.index)

    def keys(self) -> list:
        return list(self._dir)

    def predict_put_s(self, nbytes: int) -> float:
        bb = self.alloc.block_bytes
        whole, rem = divmod(int(nbytes), bb)
        return whole * self.alloc.predict_write_s(bb) + (
            self.alloc.predict_write_s(rem) if rem else 0.0)

    def predict_get_s(self, nbytes: int) -> float:
        bb = self.alloc.block_bytes
        whole, rem = divmod(int(nbytes), bb)
        return whole * self.alloc.predict_read_s(bb) + (
            self.alloc.predict_read_s(rem) if rem else 0.0)

    def put(self, key, payload: bytes, *, rank: int = 0) -> bool:
        """Publish ``payload`` under ``key``.  Returns False when the
        pool budget cannot hold it even after reclaiming unpinned
        entries (callers fall back to recompute)."""
        if key in self._dir:
            self._dir.move_to_end(key)
            return True
        nblocks = max(1, -(-len(payload) // self.alloc.block_bytes))
        while (not self._free_idx
               or self.alloc.free_blocks < nblocks):
            if not self._reclaim_one():
                self.dropped += 1
                return False
        index = self._free_idx.pop()
        blocks = self.alloc.alloc(nblocks)
        bb = self.alloc.block_bytes
        for i, b in enumerate(blocks):
            self.alloc.write_block(b, payload[i * bb:(i + 1) * bb],
                                   rank=rank)
        self.refs.reset(index)
        self.doorbells.ring(index)   # commit point
        self._dir[key] = _PoolEntry(index, blocks, len(payload))
        self.puts += 1
        self.predicted_write_s += self.predict_put_s(len(payload))
        return True

    def get(self, key, *, rank: int = 0) -> Optional[bytes]:
        """Fetch a committed entry's payload (None on miss or when the
        doorbell has not rung - a half-published entry is a miss)."""
        e = self._dir.get(key)
        if e is None or not self.doorbells.is_ready(e.index):
            self.misses += 1
            return None
        self._dir.move_to_end(key)
        out = b"".join(self.alloc.read_block(b, rank=rank)
                       for b in e.blocks)[:e.nbytes]
        self.hits += 1
        self.predicted_read_s += self.predict_get_s(e.nbytes)
        return out

    def acquire(self, key, *, rank: int = 0) -> int:
        return self.refs.acquire(self._dir[key].index, rank=rank)

    def release(self, key, *, rank: int = 0) -> int:
        return self.refs.release(self._dir[key].index, rank=rank)

    def refcount(self, key) -> int:
        return self.refs.read(self._dir[key].index)

    def remove(self, key) -> None:
        """Drop an entry outright (one-shot eviction images)."""
        e = self._dir.pop(key)
        if self.refs.read(e.index) > 0:
            self._dir[key] = e
            self._dir.move_to_end(key, last=False)
            raise ValueError(f"pooled entry {key!r} still referenced")
        self._reclaim(e)

    def _reclaim_one(self) -> bool:
        for key, e in self._dir.items():
            if self.refs.read(e.index) == 0:
                del self._dir[key]
                self._reclaim(e)
                self.reclaimed += 1
                return True
        return False

    def _reclaim(self, e: _PoolEntry) -> None:
        self.alloc.free(e.blocks)
        self.doorbells.reset(e.index)
        self.refs.reset(e.index)
        self._free_idx.append(e.index)

    @property
    def stats(self) -> dict:
        return {"entries": len(self._dir), "puts": self.puts,
                "hits": self.hits, "misses": self.misses,
                "dropped": self.dropped, "reclaimed": self.reclaimed,
                "pool_blocks_used": self.alloc.used_blocks,
                "pool_blocks_free": self.alloc.free_blocks,
                "pool_retried": self.alloc.retried,
                "predicted_write_s": self.predicted_write_s,
                "predicted_read_s": self.predicted_read_s}


# -- placement pricing (the tuner's oracle, applied to cache pages) --------

def price_kv_block(nbytes: int, recompute_flops: float, *,
                   pool_cfg: Optional[CXLPoolConfig] = None,
                   block_bytes: int = 1 << 16,
                   peak_flops: float = H100_SXM.peak_flops_bf16,
                   hbm_bw: float = H100_SXM.hbm_bw) -> Choice:
    """Evict-to-pool vs recompute: the pool round-trip is a block write
    plus a block read through the CXL cost constants, recompute is the
    roofline residency of re-running prefill over the covered tokens at
    ``peak_flops``/``hbm_bw`` (the H100's by default).  Returns a
    ``Choice`` (backend ``"pool"`` | ``"recompute"``) whose
    predicted/baseline times are the two candidates."""
    cfg = pool_cfg or CXL_POOL
    nblocks = max(1, -(-int(nbytes) // block_bytes))
    per_w = cfg.memcpy_overhead + block_bytes / cfg.server_bw
    per_r = per_w + cfg.access_latency
    pool_s = nblocks * (per_w + per_r)
    rec_s = roofline_compute_time(max(0.0, recompute_flops),
                                  peak_flops=peak_flops, hbm_bw=hbm_bw)
    pick_pool = pool_s <= rec_s
    return Choice(backend="pool" if pick_pool else "recompute",
                  slicing_factor=1, allreduce_mode="kv_tier",
                  predicted_time=min(pool_s, rec_s),
                  baseline_time=max(pool_s, rec_s))


def resolve_kv_choice(primitive: str, nbytes: int,
                      recompute_flops: float, *,
                      plan: Optional[Plan] = None,
                      pool_cfg: Optional[CXLPoolConfig] = None,
                      block_bytes: int = 1 << 16) -> Choice:
    """Resolve a cache-placement cell: a tuned plan cell wins (the
    sweep in ``launch/tune --kv-block-bytes`` writes them), otherwise
    the live oracle prices it.  Either way the decision lands in the
    ledger's auto-choice audit exactly like a collective's."""
    choice = plan.lookup(primitive, max(1, nbytes), 1) \
        if plan is not None else None
    if choice is None:
        choice = price_kv_block(nbytes, recompute_flops,
                                pool_cfg=pool_cfg, block_bytes=block_bytes)
    ledger.record_choice(primitive, max(1, nbytes), 1, choice.backend,
                         choice.slicing_factor, choice.allreduce_mode,
                         predicted_time=choice.predicted_time,
                         baseline_time=choice.baseline_time)
    return choice
