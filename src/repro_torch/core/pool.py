"""Pool fault shim, the block allocator of the pool tier, and the shared
host pool of the ``cxl`` backend.

Ported from ``repro.core.pool`` (framework-free): the fault hook that
every pool access consults, bounded retry-with-backoff, and
:class:`PoolBlockAllocator`, which the serving KV tier
(``repro_torch.serving.kvcache``) stores evicted and prefix-shared cache
pages in.  :class:`PoolEmulator`, :func:`execute` and :func:`run_collective`
(copied unchanged) run a ``core.schedule.Schedule`` functionally against
an in-memory byte pool, enforcing the doorbell protocol: the oracle for
the placement math that the tuner's simulator prices.

:class:`SharedPool` is the pool as the paper built it, on one host: a
buffer every rank maps (pinned with ``cudaHostRegister`` when the ranks
run on a card), one data partition per rank (N->N writers never touch
another rank's partition), and two regions of epoch words
(``core.doorbell.EpochWords``): a doorbell per (producer, chunk) and a
done word per consumer.  Producers publish chunks with device-to-host
copies and ring the chunk's doorbell only once the copy has landed;
consumers poll, retrieve with host-to-device copies, and ring their done
word once those copies have landed, which is what lets a producer
overwrite its partition in the next round.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import schedule as sched
from repro_torch.core.doorbell import (DOORBELL_BYTES, DoorbellRegion,
                                      EpochWords)
from repro_torch.core.hw import CXL_POOL, CXLPoolConfig, MiB
from repro_torch.core.interleave import PoolLayout


class PoolAccessError(RuntimeError):
    """A pool-side load/store (or doorbell/heartbeat word) failed.

    Raised by an installed fault hook to model the unhappy path of the
    pooled fabric: a dead rank whose writes never land, a CXL port
    returning poisoned reads, a transient timeout.  Collective and
    checkpoint paths decide per-site whether the error is retryable
    (``with_retries``) or a confirmed failure for the monitor.
    """


# Module-level fault hook: ``hook(op, info)`` is consulted before every
# emulated pool access and raises PoolAccessError to inject a failure.
# One slot (not a list of hooks): fault injection composes inside a
# FaultPlan, not by stacking hooks.
_FAULT_HOOK: list[Optional[Callable[[str, dict], None]]] = [None]


def set_fault_hook(hook: Callable[[str, dict], None]) -> None:
    """Install ``hook(op, info)``; it raises ``PoolAccessError`` to
    inject a failure at that access.  ``op`` names the access kind
    ("write" / "read" / "heartbeat" / "kv_write" / ...), ``info``
    carries at least the acting ``rank`` where known."""
    _FAULT_HOOK[0] = hook


def clear_fault_hook() -> None:
    _FAULT_HOOK[0] = None


def get_fault_hook() -> Optional[Callable[[str, dict], None]]:
    return _FAULT_HOOK[0]


def check_fault(op: str, **info: Any) -> None:
    """Consult the installed fault hook (no-op when none is set)."""
    hook = _FAULT_HOOK[0]
    if hook is not None:
        hook(op, info)


def with_retries(fn: Callable[[], Any], *, retries: int = 3,
                 backoff_s: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Optional[Callable[[int, Exception], None]] = None,
                 ) -> Any:
    """Run ``fn`` with bounded retry-with-exponential-backoff on
    ``PoolAccessError``.  Transient pool faults (the kind a real fabric
    shrugs off with a replayed transaction) are absorbed here; a fault
    that persists past ``retries`` attempts re-raises for the failure
    monitor to confirm.  ``sleep`` is injectable so tests never block."""
    attempt = 0
    while True:
        try:
            return fn()
        except PoolAccessError as exc:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            if backoff_s > 0.0:
                sleep(backoff_s * (2 ** (attempt - 1)))


class PoolBlockAllocator:
    """Fixed-size block allocator over a region of pool memory.

    ``capacity_bytes`` of emulated pool memory split into equal
    ``block_bytes`` blocks, handed out from a free list by pure index
    calculation (no metadata in the pool, in the spirit of the paper's
    allocator-free doorbell addressing).  Block payload I/O goes through
    the module fault shim (``check_fault``) with bounded
    retry-with-backoff, so injected pool faults surface where a real CXL
    load/store would fail.

    ``predict_write_s``/``predict_read_s`` price one block transfer with
    the pool cost model (per-copy software overhead + bytes over the
    pool server link), so cache-placement decisions can be costed
    against recompute before any byte moves.
    """

    def __init__(self, capacity_bytes: int, block_bytes: int,
                 cfg: Optional[CXLPoolConfig] = None, *,
                 retries: int = 3, backoff_s: float = 0.0,
                 sleep: Callable[[float], None] = lambda _s: None):
        if block_bytes <= 0:
            raise ValueError("block_bytes must be positive")
        self.block_bytes = int(block_bytes)
        self.num_blocks = int(capacity_bytes) // self.block_bytes
        if self.num_blocks <= 0:
            raise ValueError(
                f"pool capacity {capacity_bytes} holds no "
                f"{block_bytes}-byte block")
        self.cfg = cfg or CXL_POOL
        self.retries = retries
        self.backoff_s = backoff_s
        self.sleep = sleep
        self._mem = np.zeros(self.num_blocks * self.block_bytes,
                             dtype=np.uint8)
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        # Telemetry for tests / metrics export.
        self.writes = 0
        self.reads = 0
        self.retried = 0

    # -- addressing (pure index calculation) ------------------------------
    def offset(self, block: int) -> int:
        self._check(block)
        return block * self.block_bytes

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        """Allocate ``n`` blocks; raises ``MemoryError`` when the pool
        budget is exhausted (callers decide whether to evict or fail)."""
        if n > len(self._free):
            raise MemoryError(
                f"pool block budget exhausted: want {n}, "
                f"{len(self._free)}/{self.num_blocks} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            self._check(b)
            if b in self._free:
                raise ValueError(f"double free of pool block {b}")
            self._free.append(b)

    # -- payload I/O through the fault shim -------------------------------
    def write_block(self, block: int, data: bytes, *,
                    rank: int = 0) -> None:
        if len(data) > self.block_bytes:
            raise ValueError(
                f"payload {len(data)} bytes > block {self.block_bytes}")
        off = self.offset(block)

        def attempt() -> None:
            check_fault("kv_write", rank=rank, offset=off,
                        size=len(data))
            self._mem[off:off + len(data)] = np.frombuffer(
                data, dtype=np.uint8)

        def note(_attempt: int, _exc: Exception) -> None:
            self.retried += 1

        with_retries(attempt, retries=self.retries,
                     backoff_s=self.backoff_s, sleep=self.sleep,
                     on_retry=note)
        self.writes += 1

    def read_block(self, block: int, nbytes: Optional[int] = None, *,
                   rank: int = 0) -> bytes:
        nbytes = self.block_bytes if nbytes is None else int(nbytes)
        off = self.offset(block)

        def attempt() -> bytes:
            check_fault("kv_read", rank=rank, offset=off, size=nbytes)
            return bytes(self._mem[off:off + nbytes])

        def note(_attempt: int, _exc: Exception) -> None:
            self.retried += 1

        out = with_retries(attempt, retries=self.retries,
                           backoff_s=self.backoff_s, sleep=self.sleep,
                           on_retry=note)
        self.reads += 1
        return out

    # -- cost model -------------------------------------------------------
    def predict_write_s(self, nbytes: Optional[int] = None) -> float:
        """One block write: per-copy software overhead + bytes over the
        pool server link (same constants as the tuner's pool oracle)."""
        n = self.block_bytes if nbytes is None else int(nbytes)
        return self.cfg.memcpy_overhead + n / self.cfg.server_bw

    def predict_read_s(self, nbytes: Optional[int] = None) -> float:
        n = self.block_bytes if nbytes is None else int(nbytes)
        return (self.cfg.memcpy_overhead + n / self.cfg.server_bw
                + self.cfg.access_latency)

    def _check(self, block: int) -> None:
        if not 0 <= block < self.num_blocks:
            raise IndexError(
                f"pool block {block} out of range [0, {self.num_blocks})")


class PoolEmulator:
    """A byte-addressable emulation of the unified pool address space."""

    def __init__(self, layout: PoolLayout, num_doorbells: int):
        self.layout = layout
        total = layout.num_devices * layout.device_capacity
        self.pool = np.zeros(total, dtype=np.uint8)
        self.doorbells = DoorbellRegion(num_doorbells)
        # (offset, size) of every write, for overlap auditing.
        self.write_log: list[tuple[int, int, int]] = []  # (rank, off, size)

    def device_of(self, pool_offset: int) -> int:
        return pool_offset // self.layout.device_capacity

    def write(self, op: sched.TransferOp, src: np.ndarray) -> None:
        assert op.kind is sched.OpKind.WRITE
        check_fault("write", rank=op.rank, offset=op.pool_offset,
                    size=op.size)
        data = src[op.buf_offset:op.buf_offset + op.size]
        if self.device_of(op.pool_offset) != op.device:
            raise AssertionError(
                f"placement bug: offset {op.pool_offset} not on device "
                f"{op.device}")
        self.pool[op.pool_offset:op.pool_offset + op.size] = data
        self.write_log.append((op.rank, op.pool_offset, op.size))
        self.doorbells.ring(op.doorbell)

    def try_read(self, op: sched.TransferOp, dst: np.ndarray,
                 dtype: np.dtype) -> bool:
        """Attempt the read; returns False if the doorbell is still STALE."""
        assert op.kind is sched.OpKind.READ
        check_fault("read", rank=op.rank, offset=op.pool_offset,
                    size=op.size)
        if not self.doorbells.is_ready(op.doorbell):
            return False
        chunk = self.pool[op.pool_offset:op.pool_offset + op.size]
        view = dst[op.buf_offset:op.buf_offset + op.size]
        if op.reduce:
            acc = view.view(dtype)
            acc += chunk.view(dtype)
        else:
            view[:] = chunk
        return True

    def audit_writes(self) -> None:
        """Assert no two writes overlapped in the pool address space."""
        spans = sorted((off, off + size, rank)
                       for rank, off, size in self.write_log)
        for (s0, e0, r0), (s1, e1, r1) in zip(spans, spans[1:]):
            if s1 < e0:
                raise AssertionError(
                    f"overlapping pool writes: rank {r0} [{s0},{e0}) vs "
                    f"rank {r1} [{s1},{e1})")


def _recv_nbytes(s: sched.Schedule, rank: int) -> int:
    p, n, nr = s.primitive, s.msg_bytes, s.nranks
    if p in ("broadcast", "scatter", "all_reduce", "all_to_all"):
        return n
    if p == "reduce":
        return n  # only meaningful at root
    if p in ("gather", "all_gather"):
        return n * nr
    if p == "reduce_scatter":
        return n // nr
    raise ValueError(p)


def _init_recv(s: sched.Schedule, rank: int, send: np.ndarray,
               recv: np.ndarray) -> None:
    """Local (non-pool) data movement: own contributions."""
    p, n, nr = s.primitive, s.msg_bytes, s.nranks
    seg = n // nr if p in ("reduce_scatter", "all_to_all") else None
    if p == "broadcast" and rank == s.root:
        recv[:] = send[:n]
    elif p == "scatter" and rank == s.root:
        recv[:] = send[rank * n:(rank + 1) * n]
    elif p == "gather" and rank == s.root:
        recv[rank * n:(rank + 1) * n] = send[:n]
    elif p == "reduce" and rank == s.root:
        recv[:] = send[:n]
    elif p == "all_gather":
        recv[rank * n:(rank + 1) * n] = send[:n]
    elif p == "all_reduce":
        recv[:] = send[:n]
    elif p == "reduce_scatter":
        recv[:] = send[rank * seg:(rank + 1) * seg]
    elif p == "all_to_all":
        recv[rank * seg:(rank + 1) * seg] = send[rank * seg:(rank + 1) * seg]


def execute(s: sched.Schedule, send_buffers: np.ndarray,
            dtype: np.dtype = np.dtype(np.float32),
            audit: bool = True) -> np.ndarray:
    """Run the schedule.  ``send_buffers`` is ``(nranks, send_bytes)`` uint8;
    returns ``(nranks, recv_bytes)`` uint8 (ragged sizes zero-padded is not
    needed - all recvs of a primitive share one size)."""
    if send_buffers.dtype != np.uint8:
        raise TypeError("send_buffers must be a uint8 byte view")
    if send_buffers.shape[0] != s.nranks:
        raise ValueError("need one send buffer per rank")

    emu = PoolEmulator(s.layout, s.num_doorbells)
    recv_bytes = _recv_nbytes(s, 0)
    recv = np.zeros((s.nranks, recv_bytes), dtype=np.uint8)
    for r in range(s.nranks):
        _init_recv(s, r, send_buffers[r], recv[r])

    # Index cursors instead of list.pop(0): the emulator used to be
    # quadratic in op count, which dominated large-schedule test time.
    wq = {r: tuple(s.writes[r]) for r in range(s.nranks)}
    rq = {r: tuple(s.reads[r]) for r in range(s.nranks)}
    wi = [0] * s.nranks
    ri = [0] * s.nranks
    # Round-robin one op per stream per iteration: models the write/read
    # stream concurrency of Sec. 4.4.
    stall_rounds = 0
    while any(wi[r] < len(wq[r]) for r in range(s.nranks)) or \
            any(ri[r] < len(rq[r]) for r in range(s.nranks)):
        progressed = False
        for r in range(s.nranks):
            if wi[r] < len(wq[r]):
                emu.write(wq[r][wi[r]], send_buffers[r])
                wi[r] += 1
                progressed = True
        for r in range(s.nranks):
            if ri[r] < len(rq[r]) and \
                    emu.try_read(rq[r][ri[r]], recv[r], dtype):
                ri[r] += 1
                progressed = True
        if not progressed:
            stall_rounds += 1
            if stall_rounds > 2:
                pending = {r: rq[r][ri[r]].data_key
                           for r in range(s.nranks) if ri[r] < len(rq[r])}
                raise RuntimeError(f"doorbell deadlock; waiting on {pending}")
        else:
            stall_rounds = 0
    if audit:
        emu.audit_writes()
    return recv


def run_collective(primitive: str, inputs: np.ndarray, *, root: int = 0,
                   num_devices: int = 6,
                   device_capacity: int = 4 * 1024**2,
                   slicing_factor: int = 4) -> np.ndarray:
    """Convenience wrapper: ``inputs`` is ``(nranks, elems)`` of any numeric
    dtype (for scatter, the root row holds ``nranks*elems``; other rows are
    ignored).  Returns the per-rank results as a 2-D array of the input
    dtype."""
    inputs = np.asarray(inputs)
    nranks = inputs.shape[0]
    itemsize = inputs.dtype.itemsize
    if primitive == "scatter":
        msg_bytes = (inputs.shape[1] // nranks) * itemsize
        send_bytes = inputs.shape[1] * itemsize
    else:
        msg_bytes = inputs.shape[1] * itemsize
        send_bytes = msg_bytes
    s = sched.build(primitive, nranks, msg_bytes, num_devices=num_devices,
                    device_capacity=device_capacity,
                    slicing_factor=slicing_factor, root=root,
                    granularity=itemsize)
    send = np.ascontiguousarray(inputs).view(np.uint8).reshape(
        nranks, send_bytes)
    out = execute(s, send, dtype=inputs.dtype)
    return out.view(inputs.dtype)


# --------------------------------------------------------------------- #
# the shared host pool of the cxl backend
# --------------------------------------------------------------------- #

DEFAULT_PARTITION_BYTES = 256 * MiB   # one rank's window per round
MAX_CHUNKS = 64                       # doorbells per producer
_PAGE = 4096
_CHUNK_ALIGN = 256


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def split_window(lo: int, hi: int, n_chunks: int) -> list:
    """The slicing factor on the pool: byte range [lo, hi) of one round
    cut into at most ``n_chunks`` chunks (256-byte aligned, the last one
    ragged), each with its own doorbell, so a consumer retrieves chunk k
    while the producer still writes chunk k+1."""
    if hi <= lo:
        return []
    n = max(1, min(int(n_chunks), MAX_CHUNKS))
    step = _round_up(-(-(hi - lo) // n), _CHUNK_ALIGN)
    return [(a, min(hi, a + step)) for a in range(lo, hi, step)]


def create_backing(nbytes: int) -> tuple:
    """Anonymous shared memory for a pool of ``nbytes`` (``memfd``: not
    bounded by the size of ``/dev/shm``).  Returns (path, fd): every
    process of this host maps ``path``; the creator keeps ``fd`` open
    until the ranks are done and then closes it."""
    fd = os.memfd_create("repro-cxl-pool")
    os.ftruncate(fd, nbytes)
    return f"/proc/{os.getpid()}/fd/{fd}", fd


class SharedPool:
    """One rank's handle on the shared host pool.

    Layout: ``nranks * MAX_CHUNKS`` doorbell words, ``nranks`` done
    words (one cache line each, page-rounded), then ``nranks`` data
    partitions of ``partition_bytes``.  A collective is one
    :meth:`exchange`: every rank may publish a byte buffer and retrieve
    byte ranges of the others'.  A buffer larger than the partition
    streams through it in rounds; each round is one epoch on every rank
    (all ranks issue the same collectives in the same order, so their
    epochs agree).  Every wait has a deadline and raises
    :class:`PoolAccessError`, so a lost rank fails instead of hanging.
    """

    def __init__(self, path: str, nranks: int, rank: int,
                 partition_bytes: int, device, *,
                 timeout_s: float = 600.0, poll_s: float = 50e-6):
        if not 0 <= rank < nranks:
            raise ValueError(f"rank {rank} out of range [0, {nranks})")
        self.nranks, self.rank = nranks, rank
        self.partition_bytes = _round_up(int(partition_bytes), _PAGE)
        self.device = torch.device(device)
        self.timeout_s, self.poll_s = timeout_s, poll_s
        self.words_bytes = self.words_region_bytes(nranks)
        total = self.total_bytes(nranks, partition_bytes)
        self.buf = torch.from_file(path, shared=True, size=total,
                                   dtype=torch.uint8)
        self._registered = False
        if self.device.type == "cuda":
            # portable (flag 1): pinned for every context of the process
            err = torch.cuda.cudart().cudaHostRegister(
                self.buf.data_ptr(), total, 1)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of the {total}-byte "
                                   f"pool failed: cudaError {int(err)}")
            self._registered = True
        mem = self.buf.numpy()
        n_bells = nranks * MAX_CHUNKS
        self.doorbells = EpochWords(mem, n_bells)
        self.done = EpochWords(mem[n_bells * DOORBELL_BYTES:], nranks)
        self.epoch = 0
        # telemetry: bytes this rank copied into / out of the pool
        self.bytes_published = 0
        self.bytes_retrieved = 0
        self.rounds = 0

    @staticmethod
    def words_region_bytes(nranks: int) -> int:
        return _round_up((nranks * MAX_CHUNKS + nranks) * DOORBELL_BYTES,
                         _PAGE)

    @classmethod
    def total_bytes(cls, nranks: int, partition_bytes: int) -> int:
        return cls.words_region_bytes(nranks) \
            + nranks * _round_up(int(partition_bytes), _PAGE)

    def partition(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s data partition (a uint8 view of the pool)."""
        off = self.words_bytes + rank * self.partition_bytes
        return self.buf[off:off + self.partition_bytes]

    def close(self) -> None:
        if self._registered:
            torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr())
            self._registered = False

    # -- one collective -------------------------------------------------

    def exchange(self, send: Optional[torch.Tensor], nbytes: int,
                 wants: Sequence[tuple], n_chunks: int,
                 skip: Optional[tuple] = None) -> None:
        """Publish ``send`` (a flat uint8 tensor of ``nbytes``, or None
        when this rank publishes nothing) and retrieve ``wants``: tuples
        (src rank, byte offset in src's buffer, flat uint8 destination),
        each destination filled with ``dst.numel()`` bytes from there.
        ``nbytes`` is the size of every producer's buffer (the same on
        all ranks); ``skip`` is a byte range of ``send`` nobody reads,
        left unpublished.  Returns once every wanted byte has landed."""
        cuda = self.device.type == "cuda"
        window = self.partition_bytes
        for lo in range(0, max(nbytes, 1), window):
            hi = min(nbytes, lo + window)
            self.epoch += 1
            chunks = split_window(lo, hi, n_chunks)
            if send is not None:
                self._wait_done(self.epoch - 1)
                self._publish(send, lo, chunks, skip, cuda)
            self._retrieve(wants, lo, chunks, cuda)
            self.done.ring(self.rank, self.epoch)
            self.rounds += 1

    def _deadline_passed(self, t_end: float, what: str) -> None:
        if time.monotonic() > t_end:
            raise PoolAccessError(
                f"rank {self.rank}: {what} not reached within "
                f"{self.timeout_s:.0f}s (epoch {self.epoch})")

    def _wait_done(self, epoch: int) -> None:
        """A producer may overwrite its partition only once every
        consumer has finished the previous round."""
        t_end = time.monotonic() + self.timeout_s
        for c in range(self.nranks):
            if c == self.rank:
                continue
            while self.done.read(c) < epoch:
                self._deadline_passed(t_end, f"done word of rank {c}")
                time.sleep(self.poll_s)

    def _publish(self, send, lo, chunks, skip, cuda) -> None:
        part = self.partition(self.rank)
        base = self.words_bytes + self.rank * self.partition_bytes
        events = []
        for a, b in chunks:
            for u, v in _minus((a, b), skip):
                check_fault("write", rank=self.rank, offset=base + u - lo,
                            size=v - u)
                part[u - lo:v - lo].copy_(send[u:v], non_blocking=cuda)
                self.bytes_published += v - u
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                events.append(ev)
        for ci in range(len(chunks)):
            if cuda:
                # ring only once the chunk's copy has landed in the pool
                events[ci].synchronize()
            self.doorbells.ring(self.rank * MAX_CHUNKS + ci, self.epoch)

    def _retrieve(self, wants, lo, chunks, cuda) -> None:
        pending = []
        for src, src_lo, dst in wants:
            src_hi = src_lo + dst.numel()
            for ci, (a, b) in enumerate(chunks):
                u, v = max(a, src_lo), min(b, src_hi)
                if u < v:
                    pending.append((src, ci, u, v, dst, src_lo))
        # the paper's read rotation: start from (rank + 1) % nranks
        pending.sort(key=lambda t: ((t[0] - self.rank - 1) % self.nranks,
                                    t[1]))
        copied = bool(pending)
        t_end = time.monotonic() + self.timeout_s
        while pending:
            rest = []
            for item in pending:
                src, ci, u, v, dst, src_lo = item
                if self.doorbells.read(src * MAX_CHUNKS + ci) < self.epoch:
                    rest.append(item)
                    continue
                base = self.words_bytes + src * self.partition_bytes
                check_fault("read", rank=self.rank, src=src,
                            offset=base + u - lo, size=v - u)
                dst[u - src_lo:v - src_lo].copy_(
                    self.partition(src)[u - lo:v - lo], non_blocking=cuda)
                self.bytes_retrieved += v - u
            if len(rest) == len(pending):
                self._deadline_passed(t_end, f"doorbell of rank "
                                             f"{rest[0][0]} chunk "
                                             f"{rest[0][1]}")
                time.sleep(self.poll_s)
            pending = rest
        if cuda and copied:
            # done may be rung only once the retrieved bytes have landed
            torch.cuda.current_stream(self.device).synchronize()


def _minus(span: tuple, skip: Optional[tuple]) -> list:
    """``span`` minus the ``skip`` range, as 0-2 non-empty ranges."""
    a, b = span
    if skip is None or skip[1] <= a or skip[0] >= b:
        return [(a, b)]
    return [(u, v) for u, v in ((a, skip[0]), (skip[1], b)) if u < v]
