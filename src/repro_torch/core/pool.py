"""Pool fault shim and the fixed-size block allocator of the pool tier.

Ported from ``repro.core.pool`` (framework-free): the fault hook that
every emulated pool access consults, bounded retry-with-backoff, and
:class:`PoolBlockAllocator`, which the serving KV tier
(``repro_torch.serving.kvcache``) stores evicted and prefix-shared cache
pages in.  ``PoolEmulator``, ``execute`` and ``run_collective`` (the
collective schedule emulation) come with the pool-machinery slice.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.hw import CXL_POOL, CXLPoolConfig


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
