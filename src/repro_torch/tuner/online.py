"""Online re-tuning: measured-cost feedback into the plan.

The offline plans (``tuner.sweep``) are priced entirely by oracles -
the pool simulator, the IB alpha-beta model, the ICI ring model - so a
miscalibrated oracle silently drives ``backend='auto'`` to the wrong
choice forever.  This module closes the loop:

1. **Observe**: measured per-collective wall times arrive either as
   ledger-tagged timing samples (``core.ledger.record_timing`` /
   ``ledger.timed`` around an eagerly dispatched collective) or as
   measured *step* times apportioned over the step's trace-time
   ``auto_choices`` audit by predicted-time share
   (``OnlineTuner.observe_step`` - the ROADMAP's "feed measured step
   times back into the plan"), or - the preferred path - as
   per-collective samples (``core.api.TimedCommunicator`` around every
   eager call, or ``obs.profile``'s emulator) booked through the same
   ledger capture.  Samples
   aggregate per plan cell key ``(primitive, size bucket,
   nranks[, level])`` *and* per candidate ``(backend, slicing_factor,
   allreduce_mode)`` as an exponentially-weighted moving average,
   weighted by the sample's true per-step trip count (``calls``, the
   ledger's ambient ``scale()`` stamp).  A sample whose knobs are
   unknown (``None``) aggregates under an explicit ``?`` pseudo-
   candidate - never into a real candidate's mean - except for
   ``ring``, whose single candidate ignores the knobs by construction.

2. **Refresh**: ``OnlineTuner.refresh`` re-resolves every cell of the
   base plan: each candidate is priced by its measured EWMA once the
   cell has ``min_samples`` samples for it, and by the offline oracle
   otherwise.  The argmin becomes the new cell choice, with the
   measured feedback persisted in the plan (format v4:
   ``measured_us``/``sample_count``/``ewma_alpha``), so a saved
   refreshed plan warm-starts the next run's tuner.

   Oracle-priced candidates are additionally corrected by learned
   **calibration scales**: every measurement also folds the ratio
   measured/oracle into a sample-weighted mean keyed ``(backend,
   level, primitive)``, and unmeasured candidates are priced
   ``oracle * scale`` once the scale has ``min_samples`` of support.  Measurements thereby correct
   the oracle *everywhere* that backend runs that primitive on that
   level - not just at measured cells.  (The primitive stays in the
   key so one pathological broadcast measurement cannot reprice
   all_reduce cells; the per-(backend, level) aggregate is still
   persisted/reported for fabric-drift detection, ``obs.health``.)
   Scales ride in plan ``meta["calibration"]`` and warm-start the next
   run's tuner alongside the measured cells.

3. **Hot-swap**: ``refresh_and_activate`` publishes the refreshed plan
   through the epoch-versioned active-plan registry
   (``tuner.runtime.set_active_plan``).  ``Communicator`` resolution
   happens per call against the registry, so the next call picks the
   new plan up (the port resolves at every call: nothing to re-trace);
   ``choices_changed`` says whether the resolution actually moved.

Convergence mechanics: a 4x-optimistic pool oracle makes ``auto`` pick
``cxl`` where ``ring`` truly wins.  The wrongly-chosen backend is what
gets executed, so it is what gets *measured*; once its measured EWMA
overrides the oracle, the argmin compares (bad) measured cxl against
(oracle) ring and flips.  The newly chosen backend then gets measured
in turn and either confirms or flips back - the same
explore-by-exploitation loop Meta's 100k+-GPU collective tuning runs
with continuously refreshed cost tables.

Framework-free copy of ``repro.tuner.online``: the same plans, samples
and arithmetic give the same refreshed plan JSON.  One difference: a
surviving fused verdict is repriced with the epilogue roofline
``peak_flops`` / ``hbm_bw`` (the H100's by default, as the port's sweep
tunes; pass the reference's constants to get its numbers).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from repro_torch.core.chunking import DEFAULT_SLICING_FACTOR
from repro_torch.core.hw import (CXL_POOL, H100_SXM, INFINIBAND,
                                 CXLPoolConfig, InfiniBandConfig)
from repro_torch.tuner import costmodel
from repro_torch.tuner.plan import Choice, Plan, size_bucket
from repro_torch.tuner.sweep import (DEFAULT_GRID, TuneGrid, _candidates,
                                     _p2p_candidates)

DEFAULT_ALPHA = 0.3         # EWMA smoothing factor
DEFAULT_MIN_SAMPLES = 3     # samples before measured overrides oracle
DEFAULT_RETUNE_INTERVAL = 10
UNKNOWN = "?"               # pseudo-knob for samples with unknown knobs
_LKEY_RE = re.compile(r"\d+:[0-9a-f]+")   # "<idx>:<fabric fp>"


def cell_key(primitive: str, msg_bytes: int, nranks: int,
             level: Optional[str] = None) -> tuple:
    """The plan-cell identity a measurement aggregates into - exactly
    the key ``Plan.add`` builds."""
    key = (primitive, size_bucket(max(1, int(msg_bytes))), int(nranks))
    return key + (level,) if level is not None else key


@dataclasses.dataclass
class CellStats:
    """EWMA of measured wall time for one (cell, candidate).

    ``weight`` is the sample's true per-step launch count (the
    ledger's ``calls`` stamp): a sample that stands for ``w`` launches
    of a scanned region moves the EWMA as if observed ``w`` times
    (``alpha_eff = 1 - (1-alpha)^w``) and advances the sample count by
    ``w``."""

    ewma_seconds: float = 0.0
    samples: float = 0.0

    def update(self, seconds: float, alpha: float,
               weight: float = 1.0) -> None:
        w = max(0.0, float(weight))
        if w == 0.0:
            return
        if self.samples == 0:
            self.ewma_seconds = seconds
        else:
            a = 1.0 - (1.0 - alpha) ** w
            self.ewma_seconds = (a * seconds
                                 + (1.0 - a) * self.ewma_seconds)
        self.samples += w


@dataclasses.dataclass
class CalStats:
    """Sample-weighted mean of the measured/oracle time ratio for one
    (backend, level, primitive) - the learned calibration scale that
    corrects oracle-priced candidates everywhere, not just at measured
    cells.  A *mean*, not an EWMA, deliberately: the ratio varies
    across the cells that feed one key (the oracle's error is not
    uniform in size/nranks), and an EWMA would slosh toward whichever
    cell folded last, repricing unmeasured candidates differently at
    every retune boundary and reopening settled cells.  The mean is
    the stationary estimate; *drift* (real hardware change) is the
    health monitor's job (``obs.health``), and per-cell truth always
    wins anyway once the cell's own measured EWMA overrides."""

    scale: float = 1.0
    samples: float = 0.0

    def update(self, ratio: float, weight: float = 1.0) -> None:
        w = max(0.0, float(weight))
        if w == 0.0 or ratio <= 0.0:
            return
        tot = self.samples + w
        self.scale = (self.scale * self.samples + float(ratio) * w) / tot
        self.samples = tot


def _grid_from_meta(meta: dict) -> TuneGrid:
    g = meta.get("grid")
    if not g:
        return DEFAULT_GRID
    return TuneGrid(
        primitives=tuple(g.get("primitives", DEFAULT_GRID.primitives)),
        sizes=tuple(g.get("sizes", DEFAULT_GRID.sizes)),
        nranks=tuple(g.get("nranks", DEFAULT_GRID.nranks)),
        slicing_factors=tuple(g.get("slicing_factors",
                                    DEFAULT_GRID.slicing_factors)),
        allreduce_modes=tuple(g.get("allreduce_modes",
                                    DEFAULT_GRID.allreduce_modes)))


class OnlineTuner:
    """Accumulates measured collective times and folds them back into
    a plan.  One instance per training/serving run; the base plan's
    persisted ``measured_us`` cells warm-start the EWMAs, so a
    ``tune -> train --plan-out -> train`` chain keeps learning.

    ``pool``/``ib`` are the *oracle* configs unmeasured candidates are
    priced with at refresh time - deliberately the same (possibly
    miscalibrated) oracle the base plan was tuned with: measurements
    are the only source of truth the online layer adds.

    Two recovery knobs, both off by default (a converged tuner with
    default knobs refreshes to the identical plan, bit for bit):

    * ``decay`` relaxes every measured EWMA toward the calibration-
      corrected oracle at each refresh (and shrinks its effective
      sample count), so a fabric that measured slow *while degraded*
      does not carry that verdict forever - stale evidence fades and
      the oracle regains its vote.
    * ``explore_eps`` is epsilon-greedy exploration at refresh: with
      probability eps per measured cell, the refreshed plan runs a
      non-winning candidate instead of the argmin, so the recovered
      fabric gets re-measured at all (pure exploitation never
      re-executes a loser, hence never notices it recovered).
    """

    def __init__(self, plan: Plan, *, alpha: float = DEFAULT_ALPHA,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 retune_interval: int = DEFAULT_RETUNE_INTERVAL,
                 calibration_min_samples: Optional[int] = None,
                 decay: float = 0.0, explore_eps: float = 0.0,
                 explore_seed: int = 0,
                 pool: CXLPoolConfig = CXL_POOL,
                 ib: InfiniBandConfig = INFINIBAND,
                 peak_flops: float = H100_SXM.peak_flops_bf16,
                 hbm_bw: float = H100_SXM.hbm_bw):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"ewma alpha must be in (0, 1], got {alpha}")
        if retune_interval < 1:
            raise ValueError("retune_interval must be >= 1")
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        if not 0.0 <= explore_eps < 1.0:
            raise ValueError(
                f"explore_eps must be in [0, 1), got {explore_eps}")
        self.plan = plan
        self.alpha = float(alpha)
        self.min_samples = max(1, int(min_samples))
        # Generalizing a correction across every cell of a (backend,
        # level, primitive) takes more evidence than overriding one
        # measured cell, so the calibration floor never drops below 2.
        self.cal_min_samples = max(2, self.min_samples) \
            if calibration_min_samples is None \
            else max(1, int(calibration_min_samples))
        self.retune_interval = int(retune_interval)
        self.decay = float(decay)
        self.explore_eps = float(explore_eps)
        self._explore_rng = np.random.default_rng(explore_seed)
        self.explored: list = []    # (refresh_count, key, candidate)
        self.pool = pool
        self.ib = ib
        self.roofline = dict(peak_flops=peak_flops, hbm_bw=hbm_bw)
        self.grid = _grid_from_meta(plan.meta)
        # The plan's embedded topology, else the process-wide active
        # one: a *flat* plan driven under `--topology` still audits
        # level tags by axis name, and feedback keyed by an unmappable
        # axis name would land in cells runtime lookup never queries.
        self.topology = plan.topology()
        if self.topology is None:
            from repro_torch.core.topology import get_active_topology
            self.topology = get_active_topology()
        # level key "idx:fp" -> Level, and axis name -> level key, so
        # observations may tag either spelling
        self._levels = {}
        self._axis_lkey = {}
        if self.topology is not None:
            for lv in self.topology.levels:
                lkey = self.topology.level_key(lv.axis)
                self._levels[lkey] = lv
                self._axis_lkey[lv.axis] = lkey
        # Overlap objective of the base plan: a constant window is
        # reconstructable from the meta and re-applied at refresh so
        # re-resolution competes under the same exposed-time objective
        # the sweep used; per-cell (dry-run-derived) windows are not
        # serialized, so unmeasured cells then keep their offline
        # choice instead of being re-argmin'd under the wrong
        # objective.
        w = plan.meta.get("overlap_compute_s", 0.0)
        self.overlap_window = float(w) if not isinstance(w, str) else 0.0
        self.window_unknown = isinstance(w, str)     # "per-cell"
        # (cell key, (backend, factor, mode)) -> CellStats
        self.stats: dict = {}
        # (backend, level key or None, primitive) -> CalStats
        self.calibration: dict = {}
        self.refresh_count = 0
        for key, ch in plan.entries.items():
            if ch.sample_count > 0 and ch.measured_us > 0.0:
                cand = (ch.backend, ch.slicing_factor, ch.allreduce_mode)
                self.stats[(key, cand)] = CellStats(
                    ewma_seconds=ch.measured_us * 1e-6,
                    samples=float(ch.sample_count))
        # persisted calibration scales warm-start the ratio EWMAs, so a
        # tune -> train --plan-out -> train chain keeps its corrected
        # oracle across processes
        for e in (plan.meta.get("calibration") or {}).get("scales", []):
            self.calibration[(e["backend"], e.get("level"),
                              e["primitive"])] = CalStats(
                scale=float(e["scale"]), samples=float(e["samples"]))

    # -- observation ------------------------------------------------------

    def _lkey(self, level: Optional[str]) -> Optional[str]:
        if level is None:
            return None
        if level in self._axis_lkey:       # topology axis name
            return self._axis_lkey[level]
        if level in self._levels:          # already a level key
            return level
        if _LKEY_RE.fullmatch(level):
            # a raw "<idx>:<fabric fp>" key from a persisted record
            # whose topology this tuner does not know: keep it verbatim
            return level
        # an axis name with no topology in scope: cells keyed by it
        # would be unreachable at lookup time - aggregate level-
        # agnostically instead of silently dropping the sample
        return None

    @staticmethod
    def _cand(backend: str, slicing_factor, allreduce_mode) -> tuple:
        """Normalize the executed candidate.  ``ring`` has exactly one
        candidate (NCCL picks its own chunking), so unknown knobs are
        unambiguous there; for ``cxl`` an unknown knob keys an explicit
        ``?`` pseudo-candidate that never matches a real one - it can
        not contaminate a tuned cell's mean."""
        if backend == "ring":
            return (backend, DEFAULT_SLICING_FACTOR, "two_phase")
        if slicing_factor is None or allreduce_mode is None:
            return (backend, UNKNOWN, UNKNOWN)
        return (backend, int(slicing_factor), allreduce_mode)

    def observe(self, primitive: str, msg_bytes: int, nranks: int,
                backend: str, seconds: float, *,
                slicing_factor: "int | None" = 4,
                allreduce_mode: "str | None" = "two_phase",
                level: Optional[str] = None,
                calls: float = 1.0) -> None:
        """Fold one measured wall-time sample into the per-cell EWMA
        (weighted by ``calls``, its true per-step trip count) and the
        per-(backend, level, primitive) calibration-ratio EWMA.
        ``level`` accepts either the topology axis name (what the
        ledger tags) or the plan's ``"<idx>:<fabric fp>"`` level key."""
        if nranks <= 1 or seconds < 0.0:
            return
        lkey = self._lkey(level)
        key = cell_key(primitive, msg_bytes, nranks, lkey)
        cand = self._cand(backend, slicing_factor, allreduce_mode)
        st = self.stats.setdefault((key, cand), CellStats())
        st.update(float(seconds), self.alpha, weight=calls)
        if UNKNOWN in cand:
            return        # cannot price an unknown candidate's oracle
        oracle = self._oracle_at(primitive, int(msg_bytes), int(nranks),
                                 lkey, *cand)
        if oracle > 1e-12:
            cs = self.calibration.setdefault(
                (backend, lkey, primitive), CalStats())
            cs.update(float(seconds) / oracle, weight=calls)

    def observe_timings(self, timings: list) -> int:
        """Consume ledger timing samples (``snapshot()["timings"]`` or
        a persisted copy).  Returns the number of samples folded in."""
        n = 0
        for t in timings:
            self.observe(t["primitive"], t["msg_bytes"], t["nranks"],
                         t["backend"], t["seconds"],
                         slicing_factor=t.get("slicing_factor"),
                         allreduce_mode=t.get("allreduce_mode"),
                         level=t.get("level"),
                         calls=t.get("calls", 1.0))
            n += 1
        return n

    def observe_step(self, step_seconds: float, choices: list) -> int:
        """Apportion one measured step wall time over the step's
        trace-time ``auto_choices`` audit by predicted-time share.

        Each audited choice carries the oracle's ``predicted_time`` and
        its true per-step launch count ``calls``; the step's measured
        time is split across cells proportionally to
        ``predicted_time * calls`` and divided back by ``calls`` to
        yield a per-launch sample (assuming a communication-dominated
        step).

        Scope of this signal: one scalar per step can only rescale the
        oracle's per-cell predictions by a common factor - it corrects
        *overall* drift (e.g. every collective running 2x slower than
        modeled, from fabric contention) and detects that the plan's
        predictions no longer match reality, but it cannot re-rank
        candidates *within* a cell, because each cell's apportioned
        sample inherits the oracle's own relative weights.  Correcting
        a non-uniformly mis-calibrated oracle (the pool model wrong,
        the IB model right) requires per-collective samples:
        ``ledger.record_timing`` / ``ledger.timed`` around eagerly
        dispatched collectives, or folded offline from profiler traces
        via ``tune --measurements`` - the path ``benchmarks/retune.py``
        demonstrates converging."""
        total = sum(max(0.0, c.get("predicted_time", 0.0))
                    * max(1.0, c.get("calls", 1.0)) for c in choices)
        if step_seconds <= 0.0 or total <= 0.0:
            return 0
        n = 0
        for c in choices:
            pred = max(0.0, c.get("predicted_time", 0.0))
            calls = max(1.0, c.get("calls", 1.0))
            if pred <= 0.0:
                continue
            per_launch = step_seconds * (pred * calls / total) / calls
            self.observe(c["primitive"], c["msg_bytes"], c["nranks"],
                         c["backend"], per_launch,
                         slicing_factor=c.get("slicing_factor", 4),
                         allreduce_mode=c.get("allreduce_mode",
                                              "two_phase"),
                         level=c.get("level"), calls=calls)
            n += 1
        return n

    # -- repricing --------------------------------------------------------

    def _oracle_at(self, primitive: str, msg_bytes: int, nranks: int,
                   lkey: Optional[str], backend: str, factor: int,
                   mode: str) -> float:
        """Oracle time at the *actual* message size (not the bucket
        floor), for calibration ratios."""
        if primitive == "p2p":
            # point-to-point cells price through the dedicated p2p
            # oracles (the collective models key EFFICIENCY/ALPHA by
            # primitive and don't know the stage handoff)
            if lkey is not None and lkey in self._levels:
                return costmodel.predict_level_p2p_time(
                    self._levels[lkey], msg_bytes, backend=backend,
                    slicing_factor=factor)
            return costmodel.predict_p2p_time(
                backend, msg_bytes, slicing_factor=factor,
                pool=self.pool, ib=self.ib)
        if lkey is not None and lkey in self._levels:
            return costmodel.predict_level_time(
                self._levels[lkey], primitive, nranks, msg_bytes,
                backend=backend, slicing_factor=factor,
                allreduce_mode=mode)
        return costmodel.predict_time(
            backend, primitive, nranks, msg_bytes,
            slicing_factor=factor, allreduce_mode=mode,
            pool=self.pool, ib=self.ib)

    def _oracle_time(self, key: tuple, backend: str, factor: int,
                     mode: str) -> float:
        lkey = key[3] if len(key) == 4 else None
        return self._oracle_at(key[0], 1 << key[1], key[2], lkey,
                               backend, factor, mode)

    def cal_scale(self, backend: str, lkey: Optional[str],
                  primitive: str) -> float:
        """The learned measured/oracle correction applied to
        oracle-priced candidates (1.0 until ``cal_min_samples`` ratio
        samples landed for the (backend, level, primitive))."""
        cs = self.calibration.get((backend, lkey, primitive))
        if cs is not None and cs.samples >= self.cal_min_samples:
            return cs.scale
        return 1.0

    def cost(self, key: tuple, backend: str, factor: int,
             mode: str) -> tuple:
        """(cost seconds, stats or None) of one candidate for one cell:
        the measured EWMA once ``min_samples`` samples landed for that
        exact candidate, the calibration-corrected offline oracle
        otherwise - windowed by the base plan's constant overlap
        objective, so oracle-priced candidates compete on the same
        exposed-time terms the sweep tuned with (measured wall times
        are already exposure)."""
        st = self.stats.get((key, (backend, factor, mode)))
        if st is not None and st.samples >= self.min_samples:
            return st.ewma_seconds, st
        lkey = key[3] if len(key) == 4 else None
        t = self._oracle_time(key, backend, factor, mode) \
            * self.cal_scale(backend, lkey, key[0])
        return max(0.0, t - self.overlap_window), st

    def _decay_stats(self) -> None:
        """Relax every measured EWMA toward the calibration-corrected
        oracle and shrink its effective sample count by ``decay``.

        Run once per refresh.  Evidence gathered under a fault ages
        out two ways: the EWMA value itself drifts back to what the
        (calibrated) oracle says the candidate should cost, and the
        shrinking sample count eventually drops below ``min_samples``,
        at which point pricing falls back to the oracle entirely.
        Fresh measurements re-anchor both - a candidate that is
        *still* slow keeps getting re-measured slow by exploration, so
        only stale verdicts fade."""
        if self.decay <= 0.0:
            return
        for (key, cand), st in self.stats.items():
            if st.samples <= 0.0:
                continue
            if UNKNOWN not in cand:
                lkey = key[3] if len(key) == 4 else None
                target = self._oracle_time(key, *cand) \
                    * self.cal_scale(cand[0], lkey, key[0])
                st.ewma_seconds += self.decay * (target
                                                 - st.ewma_seconds)
            st.samples *= (1.0 - self.decay)
        # The calibration ratios fade with the per-cell evidence: a
        # scale learned under a since-healed fault would otherwise
        # reprice the oracle with the stale slowdown forever (and the
        # EWMA decay above would converge to it rather than escape
        # it).  Scale relaxes toward 1.0, support shrinks until it
        # drops below cal_min_samples and the raw oracle votes again.
        for cs in self.calibration.values():
            if cs.samples <= 0.0:
                continue
            cs.scale += self.decay * (1.0 - cs.scale)
            cs.samples *= (1.0 - self.decay)

    def _measured_keys(self) -> set:
        """Cell keys with at least one *real* candidate past
        min_samples (unknown-knob pseudo-candidates don't count: they
        can never price a refresh)."""
        return {k for (k, c), st in self.stats.items()
                if st.samples >= self.min_samples and UNKNOWN not in c}

    def refresh(self) -> Plan:
        """Re-resolve every cell of the base plan - plus every cell the
        workload was actually *measured* at - under measured-over-
        oracle costing; returns a new format-v4 plan (the base plan is
        untouched).

        Growing cells at the observed size buckets matters: the tuned
        grid rarely matches the workload's message sizes exactly, and
        runtime lookup falls back to the nearest tuned bucket.  Once a
        measured cell exists at the workload's own bucket, lookup
        resolves it exactly and the measured cost - not a neighboring
        bucket's oracle guess - drives the choice."""
        self.refresh_count += 1
        self._decay_stats()
        explored_before = len(self.explored)
        meta = dict(self.plan.meta)
        measured_cells = sum(
            1 for (key, cand), st in self.stats.items()
            if st.samples >= self.min_samples)
        meta["online"] = {"ewma_alpha": self.alpha,
                          "min_samples": self.min_samples,
                          "refresh_count": self.refresh_count,
                          "measured_candidates": measured_cells}
        if self.decay > 0.0 or self.explore_eps > 0.0:
            meta["online"]["decay"] = self.decay
            meta["online"]["explore_eps"] = self.explore_eps
        if self.calibration:
            meta["calibration"] = self.calibration_export()
        out = Plan(fingerprint=self.plan.fingerprint, meta=meta)
        measured_keys = self._measured_keys()
        keys = set(self.plan.entries)
        keys.update(key for key, _cand in self.stats)
        for key in sorted(keys, key=lambda k: (k[0], k[1], k[2],
                                               k[3] if len(k) == 4
                                               else "")):
            lkey = key[3] if len(key) == 4 else None
            base_ch = self.plan.entries.get(key)
            if base_ch is None:
                # measured-only cell: inherit baseline/overlap context
                # from the nearest tuned cell (what lookup served the
                # workload from before this cell existed)
                base_ch = self.plan.lookup(key[0], 1 << key[1], key[2],
                                           level=lkey)
            if base_ch is None:      # untuned primitive: ring context
                base_ch = Choice(backend="ring")
            if self.window_unknown and key not in measured_keys:
                # tuned under per-cell overlap windows this tuner
                # cannot reconstruct: without measurements there is no
                # basis to overturn the offline choice
                out.entries[key] = base_ch
                continue
            level = self._levels.get(lkey) if lkey is not None else None
            backends = level.backends() if level is not None \
                else ("ring", "cxl")
            best = None
            best_cost = None
            best_st = None
            priced = {}
            # p2p cells compete over the handoff candidate set (ring
            # is a single hop: factor 1, no fused variants), matching
            # what the offline sweep resolved them against
            cands = _p2p_candidates(self.grid, backends) \
                if key[0] == "p2p" else \
                _candidates(key[0], self.grid, backends)
            for cand in cands:
                if len(cand) > 3 and cand[3]:
                    # fused variants have no measured channel (the
                    # ledger times the collective, not the fused
                    # kernel), so the online refresh compares the
                    # transport candidates only and carries the
                    # offline fusion verdict through unchanged below
                    continue
                backend, factor, mode = cand[:3]
                t, st = self.cost(key, backend, factor, mode)
                priced[(backend, factor, mode)] = (t, st)
                if best_cost is None or t < best_cost:
                    best = (backend, factor, mode)
                    best_cost = t
                    best_st = st
            # epsilon-greedy: a measured cell occasionally runs a
            # non-winning candidate so losers get re-measured (the
            # only way the tuner can notice a fabric recovered)
            if (self.explore_eps > 0.0 and key in measured_keys
                    and len(priced) > 1
                    and self._explore_rng.random() < self.explore_eps):
                others = sorted(c for c in priced if c != best)
                best = others[int(self._explore_rng.integers(
                    len(others)))]
                best_cost, best_st = priced[best]
                self.explored.append((self.refresh_count, key, best))
            # unchanged choices keep their overlap pricing; a flipped
            # cell re-derives it from the constant window (zero when
            # the base plan was tuned in isolation)
            same = best == (base_ch.backend, base_ch.slicing_factor,
                            base_ch.allreduce_mode)
            wire = self._oracle_time(key, *best) \
                * self.cal_scale(best[0], lkey, key[0])
            # a surviving fused verdict keeps the sweep's objective: its
            # window folds in the epilogue roofline, so repricing under
            # the bare constant window would drift predicted_time on
            # every refresh even when nothing changed
            win = costmodel.fused_window(key[0], 1 << key[1],
                                         self.overlap_window,
                                         **self.roofline) \
                if (same and base_ch.fused) else self.overlap_window
            out.entries[key] = Choice(
                backend=best[0], slicing_factor=best[1],
                allreduce_mode=best[2],
                predicted_time=max(0.0, wire - win),
                baseline_time=base_ch.baseline_time,
                overlap=(base_ch.overlap if same
                         else self.overlap_window > 0.0),
                hidden_time=(base_ch.hidden_time if same
                             else min(wire, self.overlap_window)),
                measured_us=(best_st.ewma_seconds * 1e6
                             if best_st is not None else 0.0),
                sample_count=(int(round(best_st.samples))
                              if best_st is not None else 0),
                ewma_alpha=self.alpha if best_st is not None else 0.0,
                # the offline fusion verdict survives a refresh as long
                # as the transport choice does; a flipped cell reverts
                # to unfused until the next offline sweep re-prices it
                fused=(base_ch.fused if same else False))
        if len(self.explored) > explored_before:
            meta["online"]["explored_cells"] = (len(self.explored)
                                                - explored_before)
        return out

    # -- calibration + regret readouts ------------------------------------

    def calibration_export(self) -> dict:
        """The learned calibration table, as persisted in plan
        ``meta["calibration"]``: the full per-(backend, level,
        primitive) ``scales`` (what pricing uses and what warm-starts
        the next run), plus the per-(backend, level) aggregate
        ``levels`` - the fabric-level drift signal ``obs.health``
        consumes (sample-weighted mean of the primitive scales)."""
        scales = [{"backend": b, "level": lk, "primitive": p,
                   "scale": cs.scale, "samples": cs.samples}
                  for (b, lk, p), cs in sorted(
                      self.calibration.items(),
                      key=lambda kv: (kv[0][0], kv[0][1] or "",
                                      kv[0][2]))]
        agg: dict = {}
        for (b, lk, _p), cs in self.calibration.items():
            tot = agg.setdefault((b, lk), [0.0, 0.0])
            tot[0] += cs.scale * cs.samples
            tot[1] += cs.samples
        levels = [{"backend": b, "level": lk,
                   "scale": (s / n if n > 0.0 else 1.0), "samples": n}
                  for (b, lk), (s, n) in sorted(
                      agg.items(), key=lambda kv: (kv[0][0],
                                                   kv[0][1] or ""))]
        return {"scales": scales, "levels": levels}

    def measured_regret(self) -> float:
        """Per-launch regret (seconds) the measurements can prove: for
        every cell whose *current* choice is measured, the gap between
        its EWMA and the best measured candidate's EWMA.  Zero when
        every measured cell already runs its measured-fastest
        candidate - the plan-cell regret gauge ``obs.metrics``
        exports."""
        best: dict = {}
        for (key, cand), st in self.stats.items():
            if UNKNOWN in cand or st.samples < self.min_samples:
                continue
            cur = best.get(key)
            if cur is None or st.ewma_seconds < cur:
                best[key] = st.ewma_seconds
        regret = 0.0
        for key, best_s in best.items():
            ch = self.plan.entries.get(key)
            if ch is None:
                continue
            st = self.stats.get(
                (key, (ch.backend, ch.slicing_factor,
                       ch.allreduce_mode)))
            if st is not None and st.samples >= self.min_samples:
                regret += max(0.0, st.ewma_seconds - best_s)
        return regret

    # -- hot-swap ---------------------------------------------------------

    def refresh_and_activate(self) -> Plan:
        """Refresh + publish through the epoch-versioned registry.  The
        refreshed plan also becomes this tuner's base, so subsequent
        refreshes re-resolve from the latest measured state."""
        from repro_torch.tuner import runtime
        plan = self.refresh()
        self.plan = plan
        runtime.set_active_plan(plan)
        return plan

    def maybe_retune(self, step_index: int) -> Optional[Plan]:
        """Hot-swap hook for step loops: refresh + activate every
        ``retune_interval`` steps (at the *end* of the interval's last
        step).  Returns the refreshed plan when one was published."""
        if (step_index + 1) % self.retune_interval != 0:
            return None
        return self.refresh_and_activate()


def choices_changed(old: Plan, new: Plan) -> bool:
    """Whether re-resolution actually moved any cell's concrete
    (backend, slicing_factor, allreduce_mode).  Launchers re-trace the
    step only when this is True - a refresh that merely updated the
    measured EWMAs does not invalidate the compiled step.

    A cell *grown* at a measured workload bucket counts as changed
    only when it resolves differently from what the old plan's
    nearest-bucket lookup served for that size - same resolution via a
    now-exact cell compiles to the same program."""
    def knobs(c: Optional[Choice]) -> Optional[tuple]:
        return None if c is None else (c.backend, c.slicing_factor,
                                       c.allreduce_mode)
    if set(old.entries) - set(new.entries):
        return True          # a cell disappeared: resolution may move
    for key, c in new.entries.items():
        prev = old.entries.get(key)
        if prev is None:     # grown cell: what did lookup serve here?
            prev = old.lookup(key[0], 1 << key[1], key[2],
                              level=key[3] if len(key) == 4 else None)
        if knobs(prev) != knobs(c):
            return True
    return False


def fold_measurements(plan: Plan, timings: list, *,
                      alpha: float = DEFAULT_ALPHA,
                      min_samples: int = DEFAULT_MIN_SAMPLES,
                      pool: CXLPoolConfig = CXL_POOL,
                      ib: InfiniBandConfig = INFINIBAND,
                      peak_flops: float = H100_SXM.peak_flops_bf16,
                      hbm_bw: float = H100_SXM.hbm_bw) -> Plan:
    """One-shot offline fold: ledger timing samples -> refreshed v4
    plan (what ``launch/tune.py --measurements`` uses)."""
    ot = OnlineTuner(plan, alpha=alpha, min_samples=min_samples,
                     pool=pool, ib=ib, peak_flops=peak_flops,
                     hbm_bw=hbm_bw)
    ot.observe_timings(timings)
    return ot.refresh()
