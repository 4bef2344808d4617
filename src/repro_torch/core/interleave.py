"""Software interleaving across CXL devices (paper Sec. 4.3, Eq. 1-4).

The pool has no hardware cache-line interleaving, so CXL-CCL places data
explicitly.  Two placement policies:

* ``RoundRobin`` (type 1, ``1->N`` / ``N->1`` collectives): the root's data
  blocks are striped round-robin across ALL devices (Eq. 1-3) so readers can
  pull from distinct devices in parallel.
* ``RankPartitioned`` (type 2, ``N->N`` collectives): each rank owns a
  mutually-exclusive device range, ``device_per_rank = ND / nranks`` (Eq. 4),
  eliminating concurrent writes to the same device; readers rotate their
  start offset ``(rank_id + 1) % nranks`` away from the writers.

All functions are pure integer math so the same code serves the functional
pool emulation and the event-driven simulator.  Copied unchanged from
``repro.core.interleave`` (framework-free).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

PlacementKind = Literal["round_robin", "rank_partitioned"]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Resolved location of one data block inside the pool."""

    device_index: int      # which CXL device
    device_block_id: int   # logical block index within that device
    device_location: int   # byte offset within the unified pool address space
    doorbell_index: int    # index of this block's doorbell entry


@dataclasses.dataclass(frozen=True)
class PoolLayout:
    """Static layout parameters shared by all ranks of a communicator."""

    num_devices: int               # ND
    device_capacity: int           # DS (bytes)
    doorbell_region: int           # DB_offset: bytes reserved for doorbells
    block_size: int                # bytes per data block (chunk)

    def __post_init__(self) -> None:
        if self.num_devices <= 0:
            raise ValueError("num_devices must be positive")
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        if self.doorbell_region < 0:
            raise ValueError("doorbell_region must be non-negative")
        per_dev = self.device_capacity - self.doorbell_region
        if per_dev <= 0:
            raise ValueError("doorbell region exceeds device capacity")

    @property
    def blocks_per_device(self) -> int:
        return (self.device_capacity - self.doorbell_region) // self.block_size


def round_robin(layout: PoolLayout, data_id: int) -> Placement:
    """Eq. 1-3: stripe block ``data_id`` round-robin across all devices."""
    nd = layout.num_devices
    device_index = data_id % nd                     # Eq. 1
    device_block_id = data_id // nd                 # Eq. 2
    if device_block_id >= layout.blocks_per_device:
        raise ValueError(
            f"data_id {data_id} overflows device {device_index} "
            f"({layout.blocks_per_device} blocks per device)")
    device_location = (                             # Eq. 3
        layout.doorbell_region
        + device_block_id * layout.block_size
        + device_index * layout.device_capacity)
    return Placement(device_index, device_block_id, device_location,
                     doorbell_index=data_id)


def rank_partitioned(layout: PoolLayout, rank_id: int, nranks: int,
                     data_id: int) -> Placement:
    """Eq. 4: confine rank ``rank_id`` to its own mutually-exclusive devices.

    ``data_id`` here indexes blocks *within the rank's own send buffer*; the
    doorbell index is globally unique per (rank, block).
    """
    nd = layout.num_devices
    if nranks <= 0:
        raise ValueError("nranks must be positive")
    device_per_rank = max(1, nd // nranks)          # Eq. 4
    first_device = (rank_id * device_per_rank) % nd
    device_index = (first_device + data_id % device_per_rank) % nd
    # When nranks > ND, several ranks share a device; give each sharer a
    # disjoint block stripe so writes never collide (still pure index math).
    num_sharers = -(-nranks * device_per_rank // nd)   # ceil
    share_slot = (rank_id * device_per_rank) // nd
    device_block_id = (data_id // device_per_rank) * num_sharers + share_slot
    if device_block_id >= layout.blocks_per_device:
        raise ValueError(
            f"data_id {data_id} overflows rank {rank_id} partition")
    device_location = (
        layout.doorbell_region
        + device_block_id * layout.block_size
        + device_index * layout.device_capacity)
    # Doorbell slot: disjoint per-rank stripe, compacted by the schedule
    # builder which knows the static writes-per-rank bound.
    doorbell_index = data_id
    return Placement(device_index, device_block_id, device_location,
                     doorbell_index=doorbell_index)


def publish_order(rank_id: int, nranks: int) -> list[int]:
    """Deterministic publication order (Sec. 4.3): start from
    ``(rank_id + 1) % nranks`` then continue round-robin.  Used both for the
    write phase (segment destinations) and the read phase (producer order) so
    concurrent ranks fan out across distinct devices."""
    return [(rank_id + 1 + i) % nranks for i in range(nranks)]
