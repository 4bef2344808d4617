"""Doorbell synchronization (paper Sec. 4.5, Fig. 8, Listing 3).

Each data chunk has a dedicated semaphore ("doorbell") living in the pool.
Only the chunk's *owner* (producer) may update it: STALE -> READY after the
write completes, followed by an explicit flush so other sockets observe the
change.  Consumers spin: read doorbell; if STALE, invalidate the cached line
and re-read after a short sleep.

Doorbell *addresses* are derived by pure index calculation against a
pre-allocated doorbell region (no allocator, no metadata) - that is the
paper's "lightweight, index-calculation-based" locking mechanism.

This module provides the host-side (Python) state machine used by the
functional pool emulation and the event-driven simulator, and
:class:`EpochWords`, the same index-addressed words living in a shared
host buffer, which the ``cxl`` backend's :class:`core.pool.SharedPool`
rings across processes; :class:`HeartbeatRegion` keeps its liveness
words there too, so every rank process reads every rank's liveness.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

DOORBELL_BYTES = 64  # one cache line per doorbell


class DoorbellState(enum.IntEnum):
    STALE = 0
    READY = 1


@dataclasses.dataclass
class DoorbellRegion:
    """Pre-allocated doorbell buffer at the base of the pool address space.

    ``capacity`` is the number of doorbell entries.  The region occupies
    ``capacity * DOORBELL_BYTES`` bytes (= ``DB_offset`` in Eq. 3).
    """

    capacity: int
    _states: list[int] = dataclasses.field(default_factory=list)
    # Telemetry for tests / the simulator.
    rings: int = 0
    polls: int = 0
    flushes: int = 0

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError("doorbell capacity must be positive")
        self._states = [DoorbellState.STALE] * self.capacity

    @property
    def region_bytes(self) -> int:
        return self.capacity * DOORBELL_BYTES

    def address(self, index: int) -> int:
        """Index-calculated doorbell address (no metadata lookup)."""
        self._check(index)
        return index * DOORBELL_BYTES

    def ring(self, index: int) -> None:
        """Producer: mark READY and flush (Listing 3 lines 5-7)."""
        self._check(index)
        self._states[index] = DoorbellState.READY
        self.rings += 1
        self.flushes += 1  # explicit flush for cross-socket visibility

    def is_ready(self, index: int) -> bool:
        """Consumer poll: invalidate + re-read (Listing 3 lines 9-13)."""
        self._check(index)
        self.polls += 1
        self.flushes += 1  # cache-line invalidation before the re-read
        return self._states[index] == DoorbellState.READY

    def reset(self, index: int) -> None:
        """Owner resets the doorbell for buffer reuse between collectives."""
        self._check(index)
        self._states[index] = DoorbellState.STALE

    def reset_all(self) -> None:
        for i in range(self.capacity):
            self._states[i] = DoorbellState.STALE

    def _check(self, index: int) -> None:
        if not 0 <= index < self.capacity:
            raise IndexError(
                f"doorbell index {index} out of range [0, {self.capacity})")


@dataclasses.dataclass
class RefcountRegion:
    """Shared-ownership words in pool memory, doorbell-style.

    The pooled KV prefix cache (``repro_torch.serving.kvcache``) needs a
    cross-engine reference count per pooled entry: how many engines
    currently hold the entry's blocks live.  Each count is a single
    word at the index-calculated address ``i * DOORBELL_BYTES`` in a
    dedicated region after the doorbells - the same allocator-free
    addressing as ``DoorbellRegion``, and the same store+flush /
    invalidate+re-read discipline (every update flushes so other
    sockets observe it; every read invalidates first).

    Updates route through the pool fault shim
    (``core.pool.check_fault``) so injected pool faults surface exactly
    where the real pool store would fail.  A refcount word is only
    meaningful once the entry's *commit* doorbell rang: publishers
    write payload blocks, set the count, then ring - readers that poll
    a STALE doorbell never trust the count.
    """

    capacity: int
    _counts: list[int] = dataclasses.field(default_factory=list)
    # Telemetry, doorbell-style.
    updates: int = 0
    polls: int = 0
    flushes: int = 0

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError("refcount capacity must be positive")
        self._counts = [0] * self.capacity

    @property
    def region_bytes(self) -> int:
        return self.capacity * DOORBELL_BYTES

    def address(self, index: int) -> int:
        """Index-calculated refcount word address."""
        self._check(index)
        return index * DOORBELL_BYTES

    def acquire(self, index: int, rank: int = 0) -> int:
        """Increment and flush; returns the new count."""
        return self._update(index, +1, rank)

    def release(self, index: int, rank: int = 0) -> int:
        """Decrement and flush; returns the new count (>= 0 enforced:
        a double release is a protocol bug, not a no-op)."""
        if self._counts[index] <= 0:
            raise ValueError(
                f"refcount word {index} released below zero")
        return self._update(index, -1, rank)

    def read(self, index: int) -> int:
        """Invalidate + re-read one count word."""
        self._check(index)
        self.polls += 1
        self.flushes += 1
        return self._counts[index]

    def reset(self, index: int) -> None:
        """Owner resets the word when the entry's blocks are reclaimed."""
        self._check(index)
        self._counts[index] = 0

    def _update(self, index: int, delta: int, rank: int) -> int:
        self._check(index)
        from repro_torch.core import pool as _pool  # late: pool imports us
        _pool.check_fault("refcount", rank=rank, index=index,
                          offset=self.address(index))
        self._counts[index] += delta
        self.updates += 1
        self.flushes += 1
        return self._counts[index]

    def _check(self, index: int) -> None:
        if not 0 <= index < self.capacity:
            raise IndexError(
                f"refcount index {index} out of range "
                f"[0, {self.capacity})")


class HeartbeatRegion:
    """Per-rank liveness words in pool memory, reusing the doorbell
    protocol.

    Rank ``r``'s heartbeat is a single word at the index-calculated
    address ``r * DOORBELL_BYTES`` in a dedicated region after the
    doorbells — same allocator-free addressing as ``DoorbellRegion``.
    A live rank overwrites its word with the current step index once
    per step and flushes (a producer "ring"); the failure monitor polls
    every word (invalidate + re-read, a consumer poll) and treats a
    word that has stopped advancing as a missing rank.

    The words are :class:`EpochWords` over ``mem`` (``region_bytes`` of
    uint8): a buffer every rank process maps, so each rank beats its
    own word and reads all of them, or, when ``mem`` is None, a zeroed
    buffer of the region's own.  A word holds the step plus one, so
    fresh memory reads as never pulsed (-1).

    Pulses route through the pool fault hook (``core.pool.check_fault``)
    so injected rank deaths and pool faults surface exactly where a
    real pool store would fail: a dead rank's pulse raises
    ``PoolAccessError`` and its word goes stale on its own.
    """

    def __init__(self, nranks: int, mem: np.ndarray | None = None):
        if nranks <= 0:
            raise ValueError("heartbeat region needs at least one rank")
        self.nranks = nranks
        if mem is None:
            mem = np.zeros(self.region_bytes_for(nranks), dtype=np.uint8)
        self._words = EpochWords(mem, nranks)
        # Telemetry, doorbell-style.
        self.pulses = 0
        self.polls = 0
        self.flushes = 0

    @staticmethod
    def region_bytes_for(nranks: int) -> int:
        return nranks * DOORBELL_BYTES

    @property
    def region_bytes(self) -> int:
        return self.region_bytes_for(self.nranks)

    def address(self, rank: int) -> int:
        """Index-calculated heartbeat address for ``rank``."""
        self._check(rank)
        return rank * DOORBELL_BYTES

    def pulse(self, rank: int, step: int) -> None:
        """Rank ``rank`` publishes liveness for ``step`` (store + flush).

        Raises ``PoolAccessError`` if a fault hook decides this rank's
        pool store fails (rank death, transient pool fault)."""
        self._check(rank)
        from repro_torch.core import pool as _pool  # late: pool imports us
        _pool.check_fault("heartbeat", rank=rank, step=step,
                          offset=self.address(rank))
        self._words.ring(rank, int(step) + 1)
        self.pulses += 1
        self.flushes += 1

    def read(self, rank: int) -> int:
        """Monitor poll: invalidate + re-read one liveness word."""
        self._check(rank)
        self.polls += 1
        self.flushes += 1
        return self._words.read(rank) - 1

    def read_all(self) -> tuple[int, ...]:
        return tuple(self.read(r) for r in range(self.nranks))

    def stale_ranks(self, step: int, timeout_steps: int) -> list[int]:
        """Ranks whose word is more than ``timeout_steps`` behind
        ``step`` (or never pulsed)."""
        return [r for r in range(self.nranks)
                if step - self.read(r) > timeout_steps]

    def _check(self, rank: int) -> None:
        if not 0 <= rank < self.nranks:
            raise IndexError(
                f"heartbeat rank {rank} out of range [0, {self.nranks})")


class EpochWords:
    """Index-addressed int64 words in shared pool memory, one per
    ``DOORBELL_BYTES`` cache line, holding an epoch (a per-call sequence
    number) rather than a READY flag: the same words serve every call,
    so a consumer waits for "the word reached my epoch", and a word left
    over from an earlier call can never read as ready.

    ``mem`` is a uint8 numpy view of the shared buffer (every process
    maps the same bytes).  Only the owner of a word stores to it; an
    aligned 8-byte store is atomic on the host, so readers see the old
    or the new epoch, never a torn one.
    """

    def __init__(self, mem: np.ndarray, capacity: int):
        if capacity <= 0:
            raise ValueError("epoch word capacity must be positive")
        nbytes = capacity * DOORBELL_BYTES
        if mem.dtype != np.uint8 or mem.nbytes < nbytes:
            raise ValueError(f"need {nbytes} bytes of uint8 pool memory "
                             f"for {capacity} words")
        self.capacity = capacity
        self._words = mem[:nbytes].view(np.int64)

    def ring(self, index: int, epoch: int) -> None:
        """Owner: publish ``epoch`` in word ``index``."""
        self._check(index)
        self._words[index * (DOORBELL_BYTES // 8)] = epoch

    def read(self, index: int) -> int:
        """Any rank: the epoch word ``index`` holds now."""
        self._check(index)
        return int(self._words[index * (DOORBELL_BYTES // 8)])

    def _check(self, index: int) -> None:
        if not 0 <= index < self.capacity:
            raise IndexError(
                f"word index {index} out of range [0, {self.capacity})")
