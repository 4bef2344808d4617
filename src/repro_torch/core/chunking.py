"""Fine-grained data chunking (paper Sec. 4.4).

A buffer is split into ``slicing_factor`` chunks, each with its own doorbell,
so a producer's publication of chunk *k* overlaps consumers' retrieval of
chunk *k-1*.  The sensitivity study (Fig. 11) finds 4-8 chunks best; a single
chunk serializes producer and consumer and is worst.

Copied unchanged from ``repro.core.chunking`` (framework-free).
"""
from __future__ import annotations

import dataclasses

DEFAULT_SLICING_FACTOR = 4
# Below this size further slicing only adds cudaMemcpy/doorbell overhead
# (paper Sec. 5.2, ReduceScatter discussion of the small-message regime).
MIN_CHUNK_BYTES = 64 * 1024


@dataclasses.dataclass(frozen=True)
class Chunk:
    index: int        # chunk index within the buffer [0, n_chunks)
    offset: int       # byte offset within the buffer
    size: int         # bytes


def effective_chunks(total_bytes: int, slicing_factor: int) -> int:
    """Clamp the slicing factor so chunks never shrink below
    ``MIN_CHUNK_BYTES`` (avoids the overhead-dominated regime)."""
    if total_bytes <= 0:
        return 1
    max_useful = max(1, total_bytes // MIN_CHUNK_BYTES)
    return max(1, min(slicing_factor, max_useful))


def split(total_bytes: int, slicing_factor: int, clamp: bool = True,
          granularity: int = 1) -> list[Chunk]:
    """Split ``total_bytes`` into chunks.  The last chunk absorbs the
    remainder so sizes always sum exactly to ``total_bytes``.  All chunk
    boundaries are aligned to ``granularity`` bytes (e.g. the element size
    when the buffer is a typed array)."""
    if total_bytes % granularity:
        raise ValueError(
            f"total_bytes {total_bytes} not a multiple of granularity "
            f"{granularity}")
    n = effective_chunks(total_bytes, slicing_factor) if clamp else max(
        1, slicing_factor)
    base = (total_bytes // n) // granularity * granularity
    if base == 0:
        n, base = 1, total_bytes
    chunks = []
    offset = 0
    for i in range(n):
        size = base if i < n - 1 else total_bytes - offset
        chunks.append(Chunk(index=i, offset=offset, size=size))
        offset += size
    return chunks
