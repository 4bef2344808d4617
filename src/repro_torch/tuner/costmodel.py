"""Unified cost oracle for the tuner.

One function predicts the completion time of any (backend, primitive,
nranks, msg_bytes, knobs) point:

* ``ring`` - the calibrated NCCL-over-InfiniBand alpha-beta model
  (``core.ibmodel``); slicing factor and allreduce mode don't apply
  (NCCL picks its own chunking).
* ``cxl``  - the event-driven pool simulator (``core.simulator``) run on
  the fully-overlapped schedule ("all" variant).  ``two_phase``
  AllReduce is costed as its actual composition: reduce_scatter(S)
  followed by all_gather(S/n), matching what ``mesh_collectives``
  executes; ``faithful`` is the paper's single-phase schedule.

Overlap-aware costing prices a collective against the compute window it
is scheduled behind (the double-buffered FSDP prefetch): the exposed
time is ``max(0, comm - overlappable_compute)``, with the overlappable
window itself bounded by roofline residency
(``roofline_compute_time``).  The sweep can minimize exposed rather
than in-isolation time, which lets ``auto`` trade wire bytes for
overlap (e.g. keep a cheaper-to-issue backend whose extra wire time is
hidden anyway).

Simulator runs are memoized - the sweep revisits (primitive, size,
nranks) many times across slicing factors and the two-phase composition
reuses the N->N runs.

Ported from ``repro.tuner.costmodel``: the same oracles, with the
roofline (``roofline_compute_time``, ``fused_window``) priced on the
H100 SXM by default.  ``peak_flops``/``hbm_bw`` stay arguments, so a
caller can price with other constants (the parity tests pass the
reference's and get its numbers); a topology's ``ici`` level brings its
own ``ICIConfig``.
"""
from __future__ import annotations

import functools
import math

from repro_torch.core import ibmodel, simulator
from repro_torch.core.hw import (CXL_POOL, H100_SXM, INFINIBAND,
                                 CXLPoolConfig, ICIConfig, InfiniBandConfig)
from repro_torch.core.topology import Level


@functools.lru_cache(maxsize=65536)
def _sim_time(primitive: str, nranks: int, msg_bytes: int,
              slicing_factor: int, pool: CXLPoolConfig) -> float:
    return simulator.run_variant(
        "all", primitive, nranks, msg_bytes,
        slicing_factor=slicing_factor, pool=pool).total_time


def predict_time(backend: str, primitive: str, nranks: int, msg_bytes: int,
                 *, slicing_factor: int = 4,
                 allreduce_mode: str = "two_phase",
                 pool: CXLPoolConfig = CXL_POOL,
                 ib: InfiniBandConfig = INFINIBAND) -> float:
    """Predicted completion time (seconds) under the offline cost model."""
    if nranks <= 1:
        return 0.0
    if backend == "ring":
        return ibmodel.estimate(primitive, nranks, msg_bytes, ib).time
    if backend == "cxl":
        if primitive == "all_reduce" and allreduce_mode == "two_phase":
            rs = _sim_time("reduce_scatter", nranks, msg_bytes,
                           slicing_factor, pool)
            ag = _sim_time("all_gather", nranks,
                           max(1, msg_bytes // nranks),
                           slicing_factor, pool)
            return rs + ag
        return _sim_time(primitive, nranks, msg_bytes, slicing_factor,
                         pool)
    raise ValueError(f"unknown backend {backend!r}")


def ici_time(primitive: str, nranks: int, msg_bytes: int,
             ici: ICIConfig) -> float:
    """Ring alpha-beta estimate for an intra-node ICI level.  The ring
    step structure is fabric-agnostic, so this reuses the calibrated IB
    formulas with the ICI link constants (no copy-RDMA pipeline, so the
    per-message overhead is the hop issue cost)."""
    shim = InfiniBandConfig(link_bw=ici.link_bw,
                            efficiency=ici.efficiency,
                            message_overhead=ici.message_overhead,
                            latency=ici.latency)
    return ibmodel.estimate(primitive, nranks, msg_bytes, shim).time


def predict_level_time(level: Level, primitive: str, nranks: int,
                       msg_bytes: int, *, backend: str = "ring",
                       slicing_factor: int = 4,
                       allreduce_mode: str = "two_phase") -> float:
    """Predicted completion time of one collective on one topology
    level, priced against that level's own fabric config:

    * ``cxl`` level - ``backend='cxl'`` runs the pool simulator with the
      level's ``CXLPoolConfig``; ``backend='ring'`` is the alternative
      transport (NCCL over the level's IB config), which is what the
      tuner compares the pool against;
    * ``ib`` level - ring over the level's ``InfiniBandConfig`` (the
      pool schedule does not exist where there is no pool);
    * ``ici`` level - ring over the level's ``ICIConfig``.

    Returns ``inf`` for a backend the fabric cannot execute, so sweeps
    can enumerate candidates uniformly.
    """
    if nranks <= 1:
        return 0.0
    if backend not in ("ring", "cxl"):
        raise ValueError(f"unknown backend {backend!r}")
    if level.fabric == "cxl":
        if backend == "ring":
            return ibmodel.estimate(primitive, nranks, msg_bytes,
                                    level.ib_cfg).time
        return predict_time("cxl", primitive, nranks, msg_bytes,
                            slicing_factor=slicing_factor,
                            allreduce_mode=allreduce_mode,
                            pool=level.pool_cfg, ib=level.ib_cfg)
    if backend != "ring":
        return math.inf
    if level.fabric == "ib":
        return ibmodel.estimate(primitive, nranks, msg_bytes,
                                level.ib_cfg).time
    return ici_time(primitive, nranks, msg_bytes, level.ici_cfg)


def predict_p2p_time(backend: str, msg_bytes: int, *,
                     slicing_factor: int = 1,
                     pool: CXLPoolConfig = CXL_POOL,
                     ib: InfiniBandConfig = INFINIBAND) -> float:
    """Predicted completion time of one point-to-point hop
    (``Communicator.send``: the full payload moves exactly one ring
    hop).  The collective oracles don't apply - a p2p is not a ring
    program, it is one producer/consumer pair:

    * ``cxl`` - the pool handoff of ``core/doorbell.py``: the producer
      writes the payload (bounded by the slower of the device and
      server caps), rings the doorbell (flush + cross-socket
      visibility), the consumer invalidates/polls and reads it back
      out.  Chunking by the slicing factor pipelines the consumer read
      behind the producer write - each extra chunk costs another
      doorbell ring + poll, so the sweep's argmin over factors finds
      the paper-style chunking sweet spot.
    * ``ring`` - one direct alpha-beta NIC transfer (no copy-RDMA
      chain to pipeline against, so chunking only adds per-message
      overhead).
    """
    s = max(0, int(msg_bytes))
    if s == 0:
        return 0.0
    f = max(1, int(slicing_factor))
    if backend == "cxl":
        bw = min(pool.device_bw, pool.server_bw)
        chunk = s / f
        # producer writes stream; the consumer's read of chunk k
        # overlaps the write of k+1, exposing only the last chunk's
        # read; every chunk pays its own doorbell ring + poll.
        return (pool.memcpy_overhead + s / bw + chunk / bw
                + f * (pool.doorbell_latency + pool.poll_interval)
                + pool.access_latency)
    if backend == "ring":
        return (ib.latency + f * ib.message_overhead
                + s / ib.effective_bw)
    raise ValueError(f"unknown backend {backend!r}")


def predict_level_p2p_time(level: Level, msg_bytes: int, *,
                           backend: str = "ring",
                           slicing_factor: int = 1) -> float:
    """One p2p hop priced against a topology level's own fabric config
    (the p2p analog of ``predict_level_time``):

    * ``cxl`` level - ``backend='cxl'`` is the pool write + doorbell
      commit with the level's ``CXLPoolConfig``; ``backend='ring'`` is
      the alternative transport over the level's IB config;
    * ``ib`` / ``ici`` level - ring only (the pool handoff does not
      exist off the pool); returns ``inf`` for ``cxl`` so sweeps can
      enumerate candidates uniformly.
    """
    if backend not in ("ring", "cxl"):
        raise ValueError(f"unknown backend {backend!r}")
    if level.fabric == "cxl":
        return predict_p2p_time(backend, msg_bytes,
                                slicing_factor=slicing_factor,
                                pool=level.pool_cfg, ib=level.ib_cfg)
    if backend != "ring":
        return math.inf
    if level.fabric == "ib":
        return predict_p2p_time("ring", msg_bytes,
                                slicing_factor=slicing_factor,
                                ib=level.ib_cfg)
    ici = level.ici_cfg
    shim = InfiniBandConfig(link_bw=ici.link_bw,
                            efficiency=ici.efficiency,
                            message_overhead=ici.message_overhead,
                            latency=ici.latency)
    return predict_p2p_time("ring", msg_bytes,
                            slicing_factor=slicing_factor, ib=shim)


def roofline_compute_time(flops: float, hbm_bytes: float = 0.0, *,
                          peak_flops: float = H100_SXM.peak_flops_bf16,
                          hbm_bw: float = H100_SXM.hbm_bw) -> float:
    """Roofline residency of a compute region: the window a collective
    can hide behind is bounded by whichever resource the region
    saturates (tensor cores or HBM), not by wall-clock guesses."""
    if flops < 0 or hbm_bytes < 0:
        raise ValueError("flops/bytes must be non-negative")
    return max(flops / peak_flops, hbm_bytes / hbm_bw)


def epilogue_flops(primitive: str, msg_bytes: int) -> float:
    """FLOPs of the epilogue/prologue compute a fused collective kernel
    folds into the transfer (``kernels.fused_collectives``), per
    message byte: ~2 flops per f32 element covers both shipped fusions
    (rmsnorm: square + multiply-add per element; AdamW: a handful of
    FMAs per element - same order).  A primitive with no fused kernel
    contributes nothing."""
    if primitive not in ("reduce_scatter", "all_gather"):
        return 0.0
    return 2.0 * (max(0, int(msg_bytes)) / 4.0)


def fused_window(primitive: str, msg_bytes: int, base_window: float, *,
                 peak_flops: float = H100_SXM.peak_flops_bf16,
                 hbm_bw: float = H100_SXM.hbm_bw) -> float:
    """The overlap window of a *fused* candidate: the unfused window
    plus the roofline residency of the epilogue the fusion absorbs into
    the transfer.  Fusing also deletes the epilogue's HBM round-trip on
    the collective's payload (the unfused composition writes the
    reduced segment and reads it straight back: 2x msg_bytes), so that
    traffic counts toward the hidden window too.  Returns
    ``base_window`` unchanged for primitives with no fused kernel."""
    fl = epilogue_flops(primitive, msg_bytes)
    if fl <= 0.0:
        return max(0.0, base_window)
    extra = roofline_compute_time(fl, 2.0 * max(0, int(msg_bytes)),
                                  peak_flops=peak_flops, hbm_bw=hbm_bw)
    return max(0.0, base_window) + extra


def predict_exposed_time(backend: str, primitive: str, nranks: int,
                         msg_bytes: int, *,
                         overlappable_compute: float = 0.0,
                         slicing_factor: int = 4,
                         allreduce_mode: str = "two_phase",
                         pool: CXLPoolConfig = CXL_POOL,
                         ib: InfiniBandConfig = INFINIBAND) -> float:
    """Exposed (non-hidden) time of a collective scheduled behind
    ``overlappable_compute`` seconds of independent compute:
    ``max(0, comm - overlappable_compute)``."""
    t = predict_time(backend, primitive, nranks, msg_bytes,
                     slicing_factor=slicing_factor,
                     allreduce_mode=allreduce_mode, pool=pool, ib=ib)
    return max(0.0, t - max(0.0, overlappable_compute))


def cache_clear() -> None:
    _sim_time.cache_clear()
