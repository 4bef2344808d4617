"""Event-driven performance simulator for pool-mediated collectives.

Reproduces the paper's evaluation methodology: the authors themselves use an
emulator for the scalability study (Sec. 5.1, "Scalability test"), with the
same two modeling assumptions we implement here:

* concurrent requests targeting the same CXL device share its bandwidth
  uniformly (Observation 2) - realized as max-min fair water-filling over
  per-(device, direction) and per-(server, direction) capacity constraints;
* requests to different devices are independent.

On top of that we model the constants measured in Sec. 3 (Fig. 3, Table 1):
20 GB/s per device and per server direction (single GPU DMA engine per
direction, Observation 1), 658 ns pool access latency, per-cudaMemcpyAsync
software overhead, doorbell flush + poll cost, and degraded per-direction
throughput when a device serves reads and writes simultaneously.

Execution model: each rank runs a writeStream and a readStream (Sec. 4.4).
Streams issue their ops in order; a read op additionally blocks until its
chunk's doorbell has been rung by the producer's completed write.  The
optional global phase barrier reproduces the non-overlapped baselines
(CXL-CCL-Naive / the strawman of Fig. 7).

Copied unchanged from ``repro.core.simulator`` (framework-free).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import schedule as sched
from repro_torch.core.hw import CXL_POOL, CXLPoolConfig


@dataclasses.dataclass
class SimOptions:
    pool: CXLPoolConfig = CXL_POOL
    phase_barrier: bool = False     # global write->read barrier (no overlap)
    track_timeline: bool = False


@dataclasses.dataclass
class SimResult:
    total_time: float                       # seconds, max over ranks
    rank_finish: dict[int, float]
    bytes_moved: int
    num_ops: int
    timeline: Optional[list] = None

    @property
    def algbw(self) -> float:
        """bytes moved through the pool / total time."""
        return self.bytes_moved / self.total_time if self.total_time else 0.0


class _Xfer:
    __slots__ = ("op", "remaining", "rate", "active", "done", "start",
                 "finish", "ready_time")

    def __init__(self, op: sched.TransferOp):
        self.op = op
        self.remaining = float(op.size)
        self.rate = 0.0
        self.active = False
        self.done = False
        self.start = None
        self.finish = None
        self.ready_time = None  # earliest legal activation time


def _allocate_rates(active: list[_Xfer], pool: CXLPoolConfig) -> None:
    """Max-min fair allocation subject to device and server caps."""
    if not active:
        return
    # Constraint keys: ('dev', device, dir) and ('srv', rank, dir).
    members: dict[tuple, list[_Xfer]] = {}
    dirs_per_device: dict[int, set[str]] = {}
    for t in active:
        d = "w" if t.op.kind is sched.OpKind.WRITE else "r"
        members.setdefault(("dev", t.op.device, d), []).append(t)
        members.setdefault(("srv", t.op.rank, d), []).append(t)
        dirs_per_device.setdefault(t.op.device, set()).add(d)

    caps: dict[tuple, float] = {}
    for key in members:
        kind = key[0]
        if kind == "dev":
            dev = key[1]
            eff = pool.bidir_efficiency if len(
                dirs_per_device[dev]) == 2 else 1.0
            caps[key] = pool.device_bw * eff
        else:
            caps[key] = pool.server_bw

    unfrozen = set(id(t) for t in active)
    by_id = {id(t): t for t in active}
    while unfrozen:
        # Most-constrained bottleneck first (water-filling).
        best_share, best_key = math.inf, None
        for key, mem in members.items():
            live = [t for t in mem if id(t) in unfrozen]
            if not live:
                continue
            share = caps[key] / len(live)
            if share < best_share:
                best_share, best_key = share, key
        if best_key is None:
            break
        for t in list(members[best_key]):
            if id(t) in unfrozen:
                t.rate = best_share
                unfrozen.discard(id(t))
                # charge this rate against the transfer's other constraints
                d = "w" if t.op.kind is sched.OpKind.WRITE else "r"
                for key in (("dev", t.op.device, d), ("srv", t.op.rank, d)):
                    if key != best_key:
                        caps[key] = max(0.0, caps[key] - best_share)


def simulate(s: sched.Schedule, options: SimOptions | None = None
             ) -> SimResult:
    opt = options or SimOptions()
    pool = opt.pool

    xfers: list[_Xfer] = []
    streams: dict[tuple, list[_Xfer]] = {}   # (rank, 'W'|'R') -> queue
    for r in range(s.nranks):
        wq = [_Xfer(op) for op in s.writes[r]]
        rq = [_Xfer(op) for op in s.reads[r]]
        streams[(r, "W")] = wq
        streams[(r, "R")] = rq
        xfers.extend(wq)
        xfers.extend(rq)
    if not xfers:
        return SimResult(0.0, {r: 0.0 for r in range(s.nranks)}, 0, 0)

    doorbell_ready: dict[tuple, float] = {}   # data_key -> time
    stream_free: dict[tuple, float] = {k: 0.0 for k in streams}
    stream_busy: dict[tuple, bool] = {k: False for k in streams}
    writes_pending = sum(len(s.writes[r]) for r in range(s.nranks))
    # for phase_barrier mode; trivially satisfied when there are no writes
    barrier_time: Optional[float] = 0.0 if writes_pending == 0 else None

    now = 0.0
    timeline: list = [] if opt.track_timeline else None
    active: list[_Xfer] = []

    def head_ready_time(key: tuple) -> Optional[float]:
        """Earliest time the stream head may become active, or None."""
        q = streams[key]
        if not q or stream_busy[key]:
            return None
        t = q[0]
        base = stream_free[key]
        if t.op.kind is sched.OpKind.READ:
            if opt.phase_barrier:
                if barrier_time is None:
                    return None
                base = max(base, barrier_time)
            db = doorbell_ready.get(t.op.data_key)
            if db is None:
                return None  # doorbell not rung yet
            # Poll quantization: the consumer sleeps between polls
            # (Listing 3), so it observes READY one poll interval late on
            # average; plus the cache-line invalidate + re-read.
            base = max(base, db + pool.poll_interval)
        # Issue overhead occupies the stream before the DMA engages.
        return base + pool.memcpy_overhead

    # Event loop.
    guard = 0
    while True:
        guard += 1
        if guard > 1_000_000:
            raise RuntimeError("simulator event-loop runaway")
        # Activate any eligible stream heads.
        changed = False
        for key, q in streams.items():
            while q:
                rt = head_ready_time(key)
                if rt is None or rt > now:
                    break
                t = q.pop(0)
                t.active = True
                t.start = now
                t.ready_time = rt
                stream_busy[key] = True
                active.append(t)
                changed = True
                break  # only one active op per stream
        if changed or active:
            _allocate_rates(active, pool)

        if not active:
            # Jump to the next activation time.
            nexts = [head_ready_time(k) for k in streams]
            nexts = [t for t in nexts if t is not None]
            if not nexts:
                if any(streams.values()):
                    stuck = {k: streams[k][0].op.data_key
                             for k in streams if streams[k]}
                    raise RuntimeError(
                        f"simulator deadlock; blocked streams: {stuck}")
                break  # all queues drained
            now = min(nexts)
            continue

        # Next completion among active transfers vs. next activation.
        dt_complete = min(t.remaining / t.rate if t.rate > 0 else math.inf
                          for t in active)
        candidates = [now + dt_complete]
        for k in streams:
            rt = head_ready_time(k)
            if rt is not None and rt > now:
                candidates.append(rt)
        t_next = min(candidates)
        dt = t_next - now
        for t in active:
            t.remaining -= t.rate * dt
        now = t_next

        # Retire completed transfers.  Sub-byte residue counts as done
        # (repeated rate*dt subtraction leaves float dust on GB transfers).
        still = []
        for t in active:
            if t.remaining <= 1e-3:
                t.done = True
                t.finish = now
                key = (t.op.rank,
                       "W" if t.op.kind is sched.OpKind.WRITE else "R")
                stream_free[key] = now
                stream_busy[key] = False
                if t.op.kind is sched.OpKind.WRITE:
                    doorbell_ready[t.op.data_key] = (
                        now + pool.doorbell_latency)
                    writes_pending -= 1
                    if writes_pending == 0:
                        barrier_time = now + pool.doorbell_latency
                if timeline is not None:
                    timeline.append((t.op.rank, t.op.kind.value,
                                     t.op.data_key, t.start, now))
            else:
                still.append(t)
        active = still

    rank_finish = {r: 0.0 for r in range(s.nranks)}
    total_bytes = 0
    for t in xfers:
        if t.finish is not None:
            rank_finish[t.op.rank] = max(rank_finish[t.op.rank], t.finish)
        total_bytes += t.op.size
    return SimResult(total_time=max(rank_finish.values(), default=0.0),
                     rank_finish=rank_finish, bytes_moved=total_bytes,
                     num_ops=len(xfers), timeline=timeline)


# ---------------------------------------------------------------------------
# CXL-CCL implementation variants (Sec. 5.1 "Baseline")
# ---------------------------------------------------------------------------

def run_variant(variant: str, primitive: str, nranks: int, msg_bytes: int,
                *, num_devices: int = 6,
                device_capacity: int = 128 * 1024**3,
                slicing_factor: int = 4, root: int = 0,
                pool: CXLPoolConfig = CXL_POOL) -> SimResult:
    """Simulate one of the paper's three implementations.

    * ``all``       - interleaving + fine-grained chunking + overlap
    * ``aggregate`` - interleaving at data-block granularity, no overlap
    * ``naive``     - sequential pool allocation, no interleave, no overlap

    ``msg_bytes`` is padded up to a multiple of ``nranks`` for the
    segmented primitives (timing-negligible, mirrors NCCL's own padding).
    """
    if primitive in ("reduce_scatter", "all_to_all") and \
            msg_bytes % nranks:
        msg_bytes += nranks - msg_bytes % nranks
    if variant == "all":
        s = sched.build(primitive, nranks, msg_bytes,
                        num_devices=num_devices,
                        device_capacity=device_capacity,
                        slicing_factor=slicing_factor, root=root)
        return simulate(s, SimOptions(pool=pool))
    if variant == "aggregate":
        s = sched.build(primitive, nranks, msg_bytes,
                        num_devices=num_devices,
                        device_capacity=device_capacity,
                        slicing_factor=1, root=root)
        return simulate(s, SimOptions(pool=pool, phase_barrier=True))
    if variant == "naive":
        s = sched.build(primitive, nranks, msg_bytes,
                        num_devices=num_devices,
                        device_capacity=device_capacity,
                        slicing_factor=1, root=root, placement="naive")
        return simulate(s, SimOptions(pool=pool, phase_barrier=True))
    raise ValueError(f"unknown variant {variant!r}")
