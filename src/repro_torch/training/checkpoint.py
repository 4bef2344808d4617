"""Checkpointing: save and restore a tree of arrays on disk.

Port of the disk part of ``repro.training.checkpoint``, with the same
layout, so a checkpoint written by either package restores in the
other: ``<dir>/step_<n:08d>/arrays.npz`` (the leaves as numpy, keyed
``a<i>`` in the order of their sorted paths), ``tree.json``
(``{"paths": [...]}``, each path its keys joined by ``/``) and
``meta.json`` (``{"step": n, ...}``).  Trees are nested dicts, lists
and tuples, visited as ``jax.tree`` visits them: dict keys sorted, a
sequence by index; leaves are tensors (copied to the host) or numpy
arrays.

``save`` is atomic: the snapshot is staged into ``step_<n>.tmp`` and
renamed into place, so a process dying mid-save never leaves a corrupt
*latest* checkpoint; ``latest_step`` and ``restore`` skip ``.tmp``
leftovers.  ``restore`` checks every path and shape against the target
structure and returns numpy leaves.

``PoolCheckpointStore`` is the pool-resident variant: double-buffered
snapshot slots in CXL pool memory, committed by a doorbell ring, priced
by the pool cost model, so a restarted or re-admitted rank rejoins warm
from pooled memory instead of cold disk.  Its slots hold the
reference's self-describing image byte for byte (an 8-byte header
length, the JSON header, the raw leaf bytes).  Alone it keeps its own
host buffer, as the reference does; in a run of rank processes every
rank maps one shared region (``PoolRegion``: the ranks' heartbeat words,
then one store partition a rank, each pinned with ``cudaHostRegister``
by its rank on the card, as ``core.pool.SharedPool`` is), snapshots its
own shards into its partition with device-to-host copies, and reads
every partition's commit words, so all ranks agree on the newest step
every rank committed (``common_latest``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import pool as pool_mod
from repro_torch.core.doorbell import (DOORBELL_BYTES, EpochWords,
                                      HeartbeatRegion)
from repro_torch.core.hw import CXLPoolConfig, MiB


def _flatten(tree: Any, prefix: tuple = ()) -> list:
    """[(path, leaf)]: dict keys in sorted order, sequences by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, prefix + (i,))]
    return [(prefix, tree)]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any,
         meta: Optional[dict] = None) -> str:
    """Atomic save: stage into ``step_<n>.tmp``, rename into place."""
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    if os.path.isdir(tmp):  # stale leftover from a process that died
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    index = []
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arrays[f"a{i}"] = _to_numpy(leaf)
        index.append(_path_str(path))
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"paths": index}, f)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if os.path.isdir(out):  # re-save of the same step
        shutil.rmtree(out)
    os.rename(tmp, out)  # the commit point
    return out


def _step_of(name: str) -> Optional[int]:
    """Step index of a committed checkpoint dir name, else None
    (``.tmp`` staging leftovers and strangers are not checkpoints)."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for d in os.listdir(ckpt_dir)
             if (s := _step_of(d)) is not None]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (validates paths and
    shapes; a leaf with a ``shape`` - a tensor, meta tensors included,
    or an array - must match it).  Only committed checkpoints are
    eligible; a ``step_<n>.tmp`` leftover is never read."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.isdir(src):
        hint = (" (a .tmp staging dir exists: the save was interrupted "
                "before commit)" if os.path.isdir(src + ".tmp") else "")
        raise FileNotFoundError(f"no committed checkpoint at {src}{hint}")
    with open(os.path.join(src, "tree.json")) as f:
        saved_paths = json.load(f)["paths"]
    flat = _flatten(like)
    if len(flat) != len(saved_paths):
        raise ValueError(
            f"checkpoint has {len(saved_paths)} leaves, target structure "
            f"has {len(flat)}")
    leaves = []
    with np.load(os.path.join(src, "arrays.npz")) as data:
        for i, (path, leaf) in enumerate(flat):
            ps = _path_str(path)
            if ps != saved_paths[i]:
                raise ValueError(
                    f"leaf {i} path mismatch: checkpoint "
                    f"{saved_paths[i]!r} vs target {ps!r}")
            arr = data[f"a{i}"]
            if hasattr(leaf, "shape") and \
                    tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{ps}: shape {arr.shape} != {tuple(leaf.shape)}")
            leaves.append(arr)
    return _unflatten(like, iter(leaves))


def load_meta(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Pool-resident checkpointing


def _leaf_bytes(leaf) -> tuple:
    """(dtype name, shape, flat uint8 tensor of the leaf's bytes) of a
    tensor (on any device) or an array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        return (str(t.dtype).removeprefix("torch."), list(t.shape),
                t.reshape(-1).view(torch.uint8))
    arr = np.ascontiguousarray(np.asarray(leaf))
    return (str(arr.dtype), list(arr.shape),
            torch.from_numpy(arr.reshape(-1).view(np.uint8)))


@dataclasses.dataclass
class PoolCheckpointStore:
    """Double-buffered, doorbell-committed snapshots in CXL pool memory.

    Layout (paper-style index calculation, no allocator): the region
    begins with ``slots`` commit words; the remaining capacity is split
    into ``slots`` equal snapshot slots.  Each snapshot is a
    self-describing byte image - an 8-byte header length, a JSON header
    (step, leaf paths/dtypes/shapes/offsets, user meta), then the raw
    leaf bytes.  A commit word holds its slot's step plus one (0: STALE),
    so any process that maps the words reads what is committed.

    Write protocol: pick the slot NOT holding the newest committed
    snapshot, reset its word (mark STALE), stream the image into the
    slot through the pool fault shim with bounded retry-with-backoff
    (``core.pool.with_retries``), then ring the word - the commit point.
    A rank dying mid-write leaves the other slot's committed snapshot
    intact, so ``restore`` always sees a consistent image.  With
    ``nranks`` partitions in a shared ``region`` the slot kept is the
    one holding the newest step every partition committed
    (``common_latest``): a rank whose writes fail cannot leave the others
    without a step they all hold.

    Each ``snapshot`` returns a report priced by the pool cost model
    (per-leaf copy overhead + bytes over the pool server bandwidth +
    the doorbell commit), so planners can budget checkpoint cadence
    against step time.  Leaves are tensors (on any device: a card's are
    device-to-host copies into the slot) or arrays; ``restore`` gives
    arrays for array leaves of ``like`` and tensors on the device of
    tensor leaves (or fills the tensors of ``out`` in place).
    """

    capacity_bytes: int = 64 * 1024 * 1024
    slots: int = 2
    cfg: CXLPoolConfig = dataclasses.field(default_factory=CXLPoolConfig)
    retries: int = 3
    backoff_s: float = 0.0
    sleep: Callable[[float], None] = lambda _s: None
    # shared memory (uint8, on the host) holding ``nranks`` partitions of
    # ``capacity_bytes``, partition r at ``base + r * stride``; None: a
    # buffer of this store's own
    region: Optional[torch.Tensor] = None
    rank: int = 0                     # this store's partition
    nranks: int = 1
    base: int = 0
    stride: int = 0

    def __post_init__(self) -> None:
        if self.slots < 2:
            raise ValueError("need >= 2 slots for crash-safe commits")
        self.words_bytes = self.slots * DOORBELL_BYTES
        usable = self.capacity_bytes - self.words_bytes
        self.slot_bytes = usable // self.slots
        if self.slot_bytes <= 0:
            raise ValueError("pool checkpoint capacity too small")
        if self.region is None:
            self.region = torch.zeros(self.capacity_bytes,
                                      dtype=torch.uint8)
        self.stride = self.stride or self.capacity_bytes
        mem = self.region.numpy()
        self._words = [EpochWords(mem[self.partition_offset(r):],
                                  self.slots)
                       for r in range(self.nranks)]
        self.retried = 0  # transient pool faults absorbed by retries

    # -- addressing -------------------------------------------------------
    def partition_offset(self, rank: int) -> int:
        return self.base + rank * self.stride

    def slot_offset(self, slot: int) -> int:
        """A slot's offset in this store's partition."""
        return self.words_bytes + slot * self.slot_bytes

    def _bytes(self, offset: int, nbytes: int) -> torch.Tensor:
        lo = self.partition_offset(self.rank) + offset
        return self.region[lo:lo + nbytes]

    def slot_steps(self, rank: Optional[int] = None) -> list:
        """The committed step of each slot of partition ``rank`` (this
        store's by default), -1 for a STALE slot."""
        words = self._words[self.rank if rank is None else rank]
        return [words.read(s) - 1 for s in range(self.slots)]

    def committed(self, rank: Optional[int] = None) -> list:
        """The steps partition ``rank`` holds committed, sorted."""
        return sorted(s for s in self.slot_steps(rank) if s >= 0)

    def common_latest(self) -> Optional[int]:
        """The newest step every partition holds committed, or None."""
        common = set(self.committed(0))
        for r in range(1, self.nranks):
            common &= set(self.committed(r))
        return max(common) if common else None

    def _next_slot(self) -> int:
        """The slot to overwrite: the one NOT holding the newest
        committed snapshot (of every partition, when there are
        several and they share one)."""
        steps = self.slot_steps()
        keep = self.common_latest() if self.nranks > 1 else None
        if keep is None or keep not in steps:
            newest = max(range(self.slots), key=lambda s: steps[s])
        else:
            newest = steps.index(keep)
        return (newest + 1) % self.slots

    # -- pool access through the fault shim -------------------------------
    def _store(self, rank: int, offset: int, nbytes: int,
               write: Callable[[], None]) -> None:
        def attempt() -> None:
            pool_mod.check_fault("ckpt_write", rank=rank, offset=offset,
                                 size=nbytes)
            write()

        def note(_attempt: int, _exc: Exception) -> None:
            self.retried += 1

        pool_mod.with_retries(attempt, retries=self.retries,
                              backoff_s=self.backoff_s, sleep=self.sleep,
                              on_retry=note)

    def _load(self, rank: int, offset: int, nbytes: int) -> torch.Tensor:
        def attempt() -> torch.Tensor:
            pool_mod.check_fault("ckpt_read", rank=rank, offset=offset,
                                 size=nbytes)
            return self._bytes(offset, nbytes)

        return pool_mod.with_retries(attempt, retries=self.retries,
                                     backoff_s=self.backoff_s,
                                     sleep=self.sleep)

    # -- cost model -------------------------------------------------------
    def predict_write_s(self, total_bytes: int, n_leaves: int) -> float:
        """Pool cost model for one snapshot: per-leaf memcpy setup, the
        image over the pool server link, one doorbell commit."""
        c = self.cfg
        return (n_leaves * c.memcpy_overhead
                + total_bytes / c.server_bw
                + c.doorbell_latency)

    # -- public API -------------------------------------------------------
    def snapshot(self, step: int, tree: Any, meta: Optional[dict] = None,
                 rank: Optional[int] = None) -> dict:
        """Write a snapshot of ``tree`` into the stale slot and commit.
        ``rank`` is the accessing rank the fault shim sees (this
        store's partition by default).

        Raises ``PoolAccessError`` only if a fault persists past the
        retry budget; the previous committed snapshot stays readable
        either way."""
        rank = self.rank if rank is None else rank
        entries, raws, off = [], [], 0
        for path, leaf in _flatten(tree):
            dtype, shape, raw = _leaf_bytes(leaf)
            entries.append({"path": _path_str(path), "dtype": dtype,
                            "shape": shape, "offset": off,
                            "nbytes": raw.numel()})
            raws.append(raw)
            off += raw.numel()
        header = json.dumps({"step": step, "leaves": entries,
                             "meta": meta or {}}).encode()
        size = 8 + len(header) + off
        if size > self.slot_bytes:
            raise ValueError(
                f"snapshot needs {size} bytes > slot capacity "
                f"{self.slot_bytes}; raise capacity_bytes")
        slot = self._next_slot()
        base = self.slot_offset(slot)
        before = self.retried

        def write() -> None:
            head = np.frombuffer(len(header).to_bytes(8, "little") + header,
                                 dtype=np.uint8)
            self._bytes(base, head.size).copy_(torch.from_numpy(head.copy()))
            at = base + head.size
            cuda = False
            for raw in raws:
                cuda |= raw.is_cuda
                self._bytes(at, raw.numel()).copy_(raw, non_blocking=True)
                at += raw.numel()
            if cuda:
                torch.cuda.synchronize()

        self._words[self.rank].ring(slot, 0)   # in-flight: not restorable
        self._store(rank, base, size, write)
        self._words[self.rank].ring(slot, step + 1)   # the commit point
        return {"slot": slot, "step": step, "bytes": size,
                "leaves": len(entries), "retries": self.retried - before,
                "predicted_write_s": self.predict_write_s(size,
                                                          len(entries))}

    def latest(self) -> Optional[int]:
        """Newest committed (doorbell READY) snapshot step, or None."""
        steps = self.committed()
        return max(steps) if steps else None

    def image(self, step: int) -> bytes:
        """The committed image of ``step`` (header length, header, leaf
        bytes), as the slot holds it."""
        base = self.slot_offset(self._slot_of(step))
        hlen = int.from_bytes(self._bytes(base, 8).numpy().tobytes(),
                              "little")
        doc = json.loads(self._bytes(base + 8, hlen).numpy().tobytes())
        n = 8 + hlen + sum(e["nbytes"] for e in doc["leaves"])
        return self._bytes(base, n).numpy().tobytes()

    def _slot_of(self, step: int) -> int:
        steps = self.slot_steps()
        if step not in steps:
            raise LookupError(f"no committed pool snapshot for step {step}")
        return steps.index(step)

    def restore(self, like: Any, step: Optional[int] = None,
                rank: Optional[int] = None, out: Any = None
                ) -> tuple[Any, dict]:
        """Restore the snapshot for ``step`` (default: newest committed)
        into the structure of ``like``; returns ``(tree, meta)``.  With
        ``out`` (``like``'s structure, tensor leaves) the leaves are
        copied into ``out``'s tensors, which come back as the tree."""
        rank = self.rank if rank is None else rank
        if step is None:
            step = self.latest()
            if step is None:
                raise LookupError("no committed pool snapshot")
        base = self.slot_offset(self._slot_of(step))
        hlen = int.from_bytes(
            self._load(rank, base, 8).numpy().tobytes(), "little")
        doc = json.loads(self._load(rank, base + 8, hlen).numpy().tobytes())
        payload_base = base + 8 + hlen
        flat = _flatten(like)
        if len(flat) != len(doc["leaves"]):
            raise ValueError(
                f"pool snapshot has {len(doc['leaves'])} leaves, target "
                f"structure has {len(flat)}")
        dests = [x for _, x in _flatten(out)] if out is not None else None
        leaves = []
        for i, (path, leaf) in enumerate(flat):
            ent = doc["leaves"][i]
            if _path_str(path) != ent["path"]:
                raise ValueError(
                    f"leaf {i} path mismatch: snapshot {ent['path']!r} vs "
                    f"target {_path_str(path)!r}")
            raw = self._load(rank, payload_base + ent["offset"],
                             ent["nbytes"])
            if isinstance(leaf, torch.Tensor) or dests is not None:
                dst = dests[i] if dests is not None else torch.empty(
                    ent["shape"], dtype=getattr(torch, ent["dtype"]),
                    device=leaf.device)
                if dst.dtype != getattr(torch, ent["dtype"]) or \
                        list(dst.shape) != ent["shape"]:
                    raise ValueError(
                        f"{ent['path']}: snapshot {ent['dtype']} "
                        f"{ent['shape']} into {dst.dtype} "
                        f"{list(dst.shape)}")
                with torch.no_grad():
                    # byte for byte: the slot's leaf offsets need not be
                    # aligned to the element size
                    dst.view(-1).view(torch.uint8).copy_(raw)
                leaves.append(dst)
            else:
                arr = raw.numpy().view(np.dtype(ent["dtype"]))
                leaves.append(arr.reshape(ent["shape"]).copy())
        return _unflatten(like, iter(leaves)), doc["meta"]


_REGION_ALIGN = 2 * MiB


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class PoolRegion:
    """One rank's mapping of the region the ranks of a run share for
    resilience: the ranks' heartbeat words (``heartbeats``), then one
    ``PoolCheckpointStore`` partition a rank (``store``: this rank's),
    each partition 2 MiB aligned.  ``path`` is a file every rank maps
    (``core.pool.create_backing``); on the card this rank's partition is
    pinned with ``cudaHostRegister``, and a failure to pin raises."""

    def __init__(self, path: str, nranks: int, rank: int,
                 capacity_bytes: int, device, **store_kw):
        hb, stride, total = self.layout(nranks, capacity_bytes)
        self.buf = torch.from_file(path, shared=True, size=total,
                                   dtype=torch.uint8)
        self.heartbeats = HeartbeatRegion(nranks, mem=self.buf.numpy()[:hb])
        self.store = PoolCheckpointStore(
            capacity_bytes, region=self.buf, rank=rank, nranks=nranks,
            base=hb, stride=stride, **store_kw)
        self._pinned = None
        if torch.device(device).type == "cuda":
            ptr = self.buf.data_ptr() + self.store.partition_offset(rank)
            err = torch.cuda.cudart().cudaHostRegister(ptr, stride, 1)
            if int(err) != 0:
                raise RuntimeError(
                    f"cudaHostRegister of rank {rank}'s {stride}-byte "
                    f"checkpoint partition failed: cudaError {int(err)}")
            self._pinned = ptr

    @staticmethod
    def layout(nranks: int, capacity_bytes: int) -> tuple:
        """(heartbeat bytes, partition stride, total bytes)."""
        hb = _round_up(HeartbeatRegion.region_bytes_for(nranks),
                       _REGION_ALIGN)
        stride = _round_up(capacity_bytes, _REGION_ALIGN)
        return hb, stride, hb + nranks * stride

    @classmethod
    def total_bytes(cls, nranks: int, capacity_bytes: int) -> int:
        return cls.layout(nranks, capacity_bytes)[2]

    def close(self) -> None:
        if self._pinned is not None:
            torch.cuda.cudart().cudaHostUnregister(self._pinned)
            self._pinned = None
