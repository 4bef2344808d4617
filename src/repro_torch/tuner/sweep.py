"""Offline tuning sweep: grid -> Plan.

For every (primitive, msg_bytes, nranks) cell the sweep costs a fixed
``ring`` candidate plus every (slicing_factor, allreduce_mode) ``cxl``
candidate, and records the argmin as the plan entry.  The best
*fixed-knob* alternative (ring, or cxl at the Communicator defaults) is
stored alongside, so benchmarks can report regret: by construction the
chosen time is never worse than that baseline as long as the grid
contains the default slicing factor.

With a ``core.topology.Topology`` the sweep runs once per level: cells
are keyed by (level index, fabric fingerprint), priced against that
level's own fabric oracle, and the candidate set shrinks to what the
fabric can execute (the pool schedule only exists on ``cxl`` levels).

``overlap_compute`` turns the sweep overlap-aware: every candidate
(including the fixed baselines, so the regret guarantee survives) is
priced by its *exposed* time ``max(0, comm - overlappable_compute)``
instead of its in-isolation time, where the overlappable window is
either a constant (seconds) or a per-cell callable
``(primitive, msg_bytes, nranks) -> seconds`` (typically a roofline
residency of the layer compute the collective is prefetched behind).
Cells tuned this way carry ``overlap=True`` + the hidden wire time, and
``Communicator(backend='auto')`` books their bytes as overlap-hidden in
the ledger.

Primitives with fused collective+compute kernels (reduce_scatter,
all_gather - see ``kernels.fused_collectives``) additionally sweep a
``fused`` variant of every transport candidate: the fused variant's
window is widened by the roofline residency of the epilogue it absorbs
(``costmodel.fused_window``), so fusion competes in the same argmin as
backend and slicing factor.  The fixed-knob baselines stay unfused, so
regret keeps meaning "vs what a knob-free run would do".

Plans are format v6: alongside the eight collectives the sweep tunes
``p2p`` cells for the pipeline stage handoff (``Communicator.send``) -
the pool write + doorbell commit vs the direct NIC/ICI hop, priced by
``costmodel.predict_p2p_time`` (the collective oracles don't apply to
a single producer/consumer pair), with the slicing factor pipelining
the consumer read behind the producer write on the pool.

Ported from ``repro.tuner.sweep``.  The fused variants' epilogue
roofline is the H100's by default; ``generate_plan(peak_flops=,
hbm_bw=)`` prices it with other constants (with the reference's, the
plan JSON is the reference's byte for byte).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Optional, Union

from repro_torch.core.chunking import DEFAULT_SLICING_FACTOR
from repro_torch.core.hw import (CXL_POOL, H100_SXM, INFINIBAND, MiB,
                                 CXLPoolConfig, InfiniBandConfig)
from repro_torch.core.schedule import PRIMITIVES
from repro_torch.core.topology import Topology
from repro_torch.tuner import costmodel
from repro_torch.tuner.plan import Choice, Plan, hardware_fingerprint

# The Communicator's default slicing factor (``core.mesh_collectives.
# DEFAULT_CHUNKS``, the reference's ``mc.DEFAULT_CHUNKS``), taken from
# ``core.chunking`` so that tuning imports no torch.
DEFAULT_CHUNKS = DEFAULT_SLICING_FACTOR


@dataclasses.dataclass(frozen=True)
class TuneGrid:
    primitives: tuple = PRIMITIVES
    sizes: tuple = tuple(m * MiB for m in (1, 4, 16, 64, 256, 1024, 4096))
    nranks: tuple = (2, 3, 4, 6, 8, 12)
    slicing_factors: tuple = (1, 2, 4, 8, 16)
    allreduce_modes: tuple = ("two_phase", "faithful")

    @property
    def cells(self) -> int:
        return len(self.primitives) * len(self.sizes) * len(self.nranks)


DEFAULT_GRID = TuneGrid()

# Grid for the lazy ``ensure_default_plan`` path and CI smoke runs:
# coarse knobs, same coverage shape, seconds not minutes.
SMOKE_GRID = TuneGrid(sizes=tuple(m * MiB for m in (1, 16, 256)),
                      nranks=(2, 3), slicing_factors=(1, 4))


def _candidates(primitive: str, grid: TuneGrid, backends=("ring", "cxl")):
    """Yield (backend, slicing_factor, allreduce_mode, fused) tuples.
    Primitives with a fused collective+compute kernel
    (``kernels.fused_collectives``: reduce_scatter epilogues, the
    all_gather-consuming matmul) get a fused variant of every
    transport candidate; the fused variant's window is widened by the
    epilogue roofline in ``_tune_cell``."""
    fusable = primitive in ("reduce_scatter", "all_gather")
    if "ring" in backends:
        yield ("ring", DEFAULT_CHUNKS, "two_phase", False)
        if fusable:
            yield ("ring", DEFAULT_CHUNKS, "two_phase", True)
    if "cxl" not in backends:
        return
    modes = grid.allreduce_modes if primitive == "all_reduce" \
        else ("two_phase",)
    for f, m in itertools.product(grid.slicing_factors, modes):
        yield ("cxl", f, m, False)
        if fusable:
            yield ("cxl", f, m, True)


def _p2p_candidates(grid: TuneGrid, backends=("ring", "cxl")):
    """Yield (backend, slicing_factor, allreduce_mode, fused) tuples
    for the point-to-point handoff.  Ring is one NIC/ICI transfer
    (chunking only adds per-message overhead, so factor 1); cxl sweeps
    the slicing factors - each chunk pipelines the consumer read behind
    the producer write at the cost of a doorbell ring + poll."""
    if "ring" in backends:
        yield ("ring", 1, "two_phase", False)
    if "cxl" not in backends:
        return
    for f in grid.slicing_factors:
        yield ("cxl", f, "two_phase", False)


OverlapCompute = Union[float, Callable[[str, int, int], float], None]


def _tune_cell(prim: str, n: int, size: int, window: float,
               candidates, cost_fn, *,
               peak_flops: float = H100_SXM.peak_flops_bf16,
               hbm_bw: float = H100_SXM.hbm_bw) -> Choice:
    """Argmin over candidates under the (possibly overlap-windowed)
    objective; the best *fixed-knob* alternative rides along so
    benchmarks can report regret."""
    best: Optional[Choice] = None
    fixed_best = math.inf
    for cand in candidates:
        backend, factor, mode = cand[:3]
        fz = bool(cand[3]) if len(cand) > 3 else False
        t_wire = cost_fn(backend, prim, n, size, factor, mode)
        # objective: exposed time under the overlap window (== t_wire
        # when no window); the window applies to every candidate, fixed
        # baselines included, so the never-slower-than-fixed guarantee
        # is preserved.  A fused candidate's window additionally folds
        # in the epilogue roofline it absorbs into the transfer; the
        # fixed baselines stay unfused so regret is measured against
        # what a knob-free run would do.
        w = costmodel.fused_window(prim, size, window,
                                   peak_flops=peak_flops,
                                   hbm_bw=hbm_bw) if fz else window
        t = max(0.0, t_wire - w)
        if not fz and (backend == "ring" or (factor == DEFAULT_CHUNKS
                                             and mode == "two_phase")):
            fixed_best = min(fixed_best, t)
        if best is None or t < best.predicted_time:
            best = Choice(backend=backend, slicing_factor=factor,
                          allreduce_mode=mode, predicted_time=t,
                          overlap=w > 0.0,
                          hidden_time=min(t_wire, w), fused=fz)
    return dataclasses.replace(best, baseline_time=fixed_best)


def _window(overlap_compute: OverlapCompute, prim: str, size: int,
            n: int) -> float:
    if callable(overlap_compute):
        return max(0.0, overlap_compute(prim, size, n))
    return max(0.0, float(overlap_compute or 0.0))


def _level_nranks(grid: TuneGrid, topology: Topology, i: int) -> tuple:
    """The rank counts to sweep for level ``i``: the grid's, plus the
    sizes a shaped level actually runs at - its distinct group sizes
    (within-group schedules) and, when the *next* level is grouped,
    its group count (the sub-root exchange rides this level)."""
    extra = set()
    lv = topology.levels[i]
    if lv.shape is not None:
        extra |= set(lv.shape)
        if lv.grouped:
            extra.add(len(lv.shape))
    if i + 1 < len(topology.levels) and topology.levels[i + 1].grouped:
        extra.add(len(topology.levels[i + 1].shape))
    return tuple(sorted(set(grid.nranks) | {n for n in extra if n >= 2}))


def generate_plan(grid: TuneGrid = DEFAULT_GRID, *,
                  pool: CXLPoolConfig = CXL_POOL,
                  ib: InfiniBandConfig = INFINIBAND,
                  topology: Optional[Topology] = None,
                  overlap_compute: OverlapCompute = None,
                  progress: Optional[Callable[[str], None]] = None,
                  peak_flops: float = H100_SXM.peak_flops_bf16,
                  hbm_bw: float = H100_SXM.hbm_bw) -> Plan:
    """Sweep the grid into a Plan.

    Without a topology every cell is priced against the single global
    (pool, ib) pair - the flat two-backend regime.  With a topology the
    sweep runs once per level: each cell is keyed by
    (level index, fabric fingerprint) and priced against that level's
    own fabric config (``costmodel.predict_level_time``), with the
    candidate set restricted to the backends the fabric can execute.
    Shaped levels extend their swept rank counts with the sizes they
    actually run at (distinct group sizes; the group count lands on
    the parent level, which carries the sub-root exchange), so ragged
    lookups resolve exactly instead of falling to the nearest tuned
    nranks.  The topology is embedded in the plan metadata and its
    fingerprint becomes the plan fingerprint, so ``tune -> train``
    round-trips through one JSON file.  ``peak_flops``/``hbm_bw`` price
    the fused variants' epilogue roofline (the H100's by default).
    """
    roof = dict(peak_flops=peak_flops, hbm_bw=hbm_bw)
    overlap_meta = ("per-cell" if callable(overlap_compute)
                    else float(overlap_compute or 0.0))
    if topology is None:
        plan = Plan(fingerprint=hardware_fingerprint(pool, ib),
                    meta={"grid": dataclasses.asdict(grid),
                          "overlap_compute_s": overlap_meta})

        def cost(backend, prim, n, size, factor, mode):
            return costmodel.predict_time(
                backend, prim, n, size, slicing_factor=factor,
                allreduce_mode=mode, pool=pool, ib=ib)

        for prim in grid.primitives:
            for n in grid.nranks:
                for size in grid.sizes:
                    w = _window(overlap_compute, prim, size, n)
                    plan.add(prim, size, n, _tune_cell(
                        prim, n, size, w, _candidates(prim, grid), cost,
                        **roof))
                if progress:
                    progress(f"tuned {prim} nranks={n}")

        def p2p_cost(backend, prim, n, size, factor, mode):
            return costmodel.predict_p2p_time(
                backend, size, slicing_factor=factor, pool=pool, ib=ib)

        for n in grid.nranks:
            for size in grid.sizes:
                w = _window(overlap_compute, "p2p", size, n)
                plan.add("p2p", size, n, _tune_cell(
                    "p2p", n, size, w, _p2p_candidates(grid), p2p_cost,
                    **roof))
            if progress:
                progress(f"tuned p2p nranks={n}")
        return plan

    plan = Plan(fingerprint=topology.fingerprint(),
                meta={"grid": dataclasses.asdict(grid),
                      "overlap_compute_s": overlap_meta,
                      "topology": topology.to_json()})
    for i, level in enumerate(topology.levels):
        lkey = topology.level_key(level.axis)
        level_nranks = _level_nranks(grid, topology, i)

        def cost(backend, prim, n, size, factor, mode, _lv=level):
            return costmodel.predict_level_time(
                _lv, prim, n, size, backend=backend,
                slicing_factor=factor, allreduce_mode=mode)

        for prim in grid.primitives:
            for n in level_nranks:
                for size in grid.sizes:
                    w = _window(overlap_compute, prim, size, n)
                    plan.add(prim, size, n, _tune_cell(
                        prim, n, size, w,
                        _candidates(prim, grid, level.backends()), cost,
                        **roof), level=lkey)
                if progress:
                    progress(f"tuned {prim} nranks={n} "
                             f"level={level.axis}/{level.fabric}")

        def p2p_cost(backend, prim, n, size, factor, mode, _lv=level):
            return costmodel.predict_level_p2p_time(
                _lv, size, backend=backend, slicing_factor=factor)

        for n in level_nranks:
            for size in grid.sizes:
                w = _window(overlap_compute, "p2p", size, n)
                plan.add("p2p", size, n, _tune_cell(
                    "p2p", n, size, w,
                    _p2p_candidates(grid, level.backends()), p2p_cost,
                    **roof), level=lkey)
            if progress:
                progress(f"tuned p2p nranks={n} "
                         f"level={level.axis}/{level.fabric}")
    return plan


def overlap_windows_from_dryrun(records: list, *,
                                peak_flops: float = H100_SXM.peak_flops_bf16,
                                hbm_bw: float = H100_SXM.hbm_bw
                                ) -> Callable[[str, int, int], float]:
    """Derive per-cell overlap windows from dry-run roofline records
    (ROADMAP overlap follow-up: replace the constant window).

    Each dry-run record carries the compiled step's FLOPs / HBM bytes
    (``cost_analysis``) and the trace-time ledger (per-primitive wire
    bytes and true launch counts).  The roofline residency of the step
    is apportioned to primitives by their wire-byte share and divided
    by that primitive's launch count: the result is the average compute
    window one launch of that primitive can hide behind.  Returns a
    ``(primitive, msg_bytes, nranks) -> seconds`` callable for
    ``generate_plan(overlap_compute=...)``.  Records of either
    package's dry-run work (the port's ``cost`` holds the trace's FLOPs
    and aten-op bytes), priced at ``peak_flops``/``hbm_bw`` (the H100's
    by default).
    """
    tot_window: dict = {}
    tot_n: dict = {}
    for rec in records:
        if rec.get("status") != "ok":
            continue
        cost = rec.get("cost") or {}
        led = rec.get("ledger") or {}
        compute = costmodel.roofline_compute_time(
            float(cost.get("flops", 0.0)),
            float(cost.get("bytes accessed", 0.0)),
            peak_flops=peak_flops, hbm_bw=hbm_bw)
        wire = led.get("wire_bytes") or {}
        calls = led.get("collective_calls") or {}
        total_bytes = sum(wire.values())
        if compute <= 0.0 or total_bytes <= 0.0:
            continue
        for prim, b in wire.items():
            n_calls = max(1.0, float(calls.get(prim, 1.0)))
            w = compute * (b / total_bytes) / n_calls
            tot_window[prim] = tot_window.get(prim, 0.0) + w
            tot_n[prim] = tot_n.get(prim, 0) + 1
    windows = {p: tot_window[p] / tot_n[p] for p in tot_window}

    def window(primitive: str, msg_bytes: int, nranks: int) -> float:
        return windows.get(primitive, 0.0)

    window.per_primitive = windows  # introspectable for reports/tests
    return window
