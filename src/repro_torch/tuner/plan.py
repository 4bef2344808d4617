"""Autotuning plan: per-(primitive, size-bucket, nranks[, level]) choice.

A ``Plan`` is the persisted product of an offline sweep through the
cost oracles (``core.simulator`` for the pool backend, ``core.ibmodel``
for the NCCL-over-IB baseline, the ICI alpha-beta model for intra-node
rings).  Each entry maps

    (primitive, floor(log2(msg_bytes)), nranks[, level])
        -> Choice(backend, slicing_factor, allreduce_mode, ...)

and ``Communicator(backend="auto")`` consults it at every collective
call.

Plans are keyed by a hardware fingerprint: for flat plans a hash of
``CXLPoolConfig`` + ``InfiniBandConfig``; for topology plans (format
v3) the ``Topology.fingerprint()`` - and every cell additionally
carries its level key ``"<level index>:<fabric fingerprint>"`` so a
cell tuned for the rack-scale pool never drives the cross-pod IB
level.  The topology itself rides in ``meta["topology"]`` so
``tune -> train`` round-trips through one JSON file.

Format v4 closes the loop on the offline oracles: cells additionally
carry ``measured_us``/``sample_count``/``ewma_alpha``, the
exponentially-weighted measured wall time that ``tuner.online`` folds
back into the plan from ledger-tagged timing samples.  A refreshed
plan's ``measured_us`` overrides the simulator prediction as the
cell's cost (``Choice.effective_time``) once enough samples landed.

Format v5 adds the ``fused`` knob: a cell tuned fused expects the
collective's epilogue/prologue compute to run inside a fused
kernel (``kernels.fused_collectives``), which the sweep prices by
folding the epilogue roofline into the cell's overlap window.

Format v6 adds point-to-point cells: ``("p2p", bucket, nranks, level)``
entries tune the pipeline stage handoff (``Communicator.send``) -
backend ``cxl`` is the pool write + doorbell commit, ``ring`` the
direct NIC/ICI hop - with the slicing factor pipelining the consumer
read behind the producer write on the pool.

Lookup is log2-bucketed with nearest-bucket fallback: an unseen message
size resolves to the closest tuned bucket (ties to the smaller), an
unseen rank count to the closest tuned nranks for that primitive, and
a level-keyed lookup falls back to the plan's level-agnostic cells when
the level is untuned.

Ported from ``repro.tuner.plan``: the same JSON format (v6, reading
v1-v6) and fingerprints, so plans cross between the two packages.
Differences: PyTorch resolves every collective call eagerly (the
reference resolves once per call site at trace time), so ``lookup``
memoises its answer per (primitive, bucket, nranks, level) until the
next ``add``; ``save_plan`` writes through a temporary file of its own
(the reference's fixed ``<path>.tmp`` lets two processes that save the
same plan at once rename each other's half-written file);
``Plan.placement`` raises until ``tuner/placement.py`` is ported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional

from repro_torch.core.hw import (CXL_POOL, INFINIBAND, CXLPoolConfig,
                                 InfiniBandConfig)
from repro_torch.core.topology import Topology

PLAN_VERSION = 6          # v6 adds point-to-point (pipeline) cells
_READABLE_VERSIONS = (1, 2, 3, 4, 5, 6)
# v1: flat cells only; v2: + per-cell overlap fields; v3: + level keys;
# v4: + measured_us/sample_count/ewma_alpha (online re-tuning feedback);
# v5: + fused (epilogue/prologue folded into a fused collective+compute
# kernel, kernels.fused_collectives);
# v6: + "p2p" point-to-point cells (pipeline stage handoff, tuned per
# (size bucket, level): cxl pool-write+doorbell vs direct ring hop).
# Older formats load forward (missing fields default); unknown formats
# raise PlanVersionError.


class PlanVersionError(ValueError):
    """A plan JSON uses a format version this build cannot read."""


def hardware_fingerprint(pool: CXLPoolConfig = CXL_POOL,
                         ib: InfiniBandConfig = INFINIBAND) -> str:
    blob = json.dumps({"pool": dataclasses.asdict(pool),
                       "ib": dataclasses.asdict(ib)}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def size_bucket(nbytes: int) -> int:
    """floor(log2(nbytes)); bucket 0 holds 1-byte messages."""
    n = int(nbytes)
    if n < 1:
        raise ValueError("message size must be >= 1 byte")
    return n.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class Choice:
    """The knobs the tuner picked for one (primitive, bucket, nranks)."""

    backend: str                       # 'ring' | 'cxl'
    slicing_factor: int = 4
    allreduce_mode: str = "two_phase"
    predicted_time: float = 0.0        # cost-model time of this choice
                                       # (exposed time when overlap-tuned)
    baseline_time: float = 0.0         # best fixed-knob alternative
    # Overlap-aware costing (ROADMAP "overlap-aware costing"): when the
    # cell was tuned against the compute it overlaps, ``overlap`` is True
    # and ``hidden_time`` is the wire time the roofline-residency model
    # expects compute to hide (exposed = wire - hidden).
    overlap: bool = False
    hidden_time: float = 0.0
    # Online re-tuning feedback (plan format v4): ``measured_us`` is
    # the exponentially-weighted mean (microseconds, smoothing factor
    # ``ewma_alpha``) of the ``sample_count`` ledger-tagged wall-time
    # measurements of the *chosen* candidate, persisted by
    # ``tuner.online.OnlineTuner.refresh`` (which re-resolves cells by
    # comparing its live per-candidate EWMAs against the oracle) so a
    # saved plan warm-starts the next run's tuner.  Zero-sample cells
    # are purely offline.
    measured_us: float = 0.0
    sample_count: int = 0
    ewma_alpha: float = 0.0
    # Fused collective+compute kernel (plan format v5): True when the
    # cell was priced with the collective's epilogue/prologue folded
    # into a fused kernel (``kernels.fused_collectives``) - the
    # epilogue roofline widens the overlap window, and the training
    # stack realizes the fusion via ``TrainConfig.fuse_kernels``.
    fused: bool = False

    def effective_time(self, min_samples: int = 1) -> float:
        """The cell's best per-launch cost estimate in seconds: the
        persisted measured EWMA once ``min_samples`` samples backed it,
        else the oracle prediction.  ``Communicator(backend='auto')``
        prices its audit entries with this, so step-time apportioning
        and dry-run deltas see measured reality on refined plans."""
        if self.sample_count >= max(1, min_samples) and \
                self.measured_us > 0.0:
            return self.measured_us * 1e-6
        return self.predicted_time


PlanKey = tuple  # (primitive, bucket, nranks) or (..., level)


@dataclasses.dataclass
class Plan:
    """The persisted product of a tuning sweep: a mapping from
    ``(primitive, log2-size bucket, nranks[, level key])`` to the
    :class:`Choice` the cost model picked, plus the hardware
    ``fingerprint`` it was tuned for and free-form ``meta`` (the grid,
    the embedded topology for per-level plans, the overlap objective,
    an optional placement report).  Build one with
    ``tuner.generate_plan``; persist with ``save_plan`` /
    ``load_plan``; serve it process-wide with
    ``tuner.activate_plan_file`` so ``Communicator(backend='auto')``
    resolves against it."""

    fingerprint: str
    entries: dict = dataclasses.field(default_factory=dict)  # key -> Choice
    meta: dict = dataclasses.field(default_factory=dict)
    # lookup answers by (primitive, bucket, nranks, level); cleared by add
    _lookups: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    def add(self, primitive: str, msg_bytes: int, nranks: int,
            choice: Choice, level: Optional[str] = None) -> None:
        key = (primitive, size_bucket(msg_bytes), nranks)
        if level is not None:
            key = key + (level,)
        self.entries[key] = choice
        self._lookups.clear()

    def matches(self, pool: CXLPoolConfig = CXL_POOL,
                ib: InfiniBandConfig = INFINIBAND) -> bool:
        return self.fingerprint == hardware_fingerprint(pool, ib)

    def topology(self) -> Optional[Topology]:
        """The Topology this plan was tuned for (None for flat plans)."""
        doc = self.meta.get("topology")
        return Topology.from_json(doc) if doc else None

    def placement(self):
        """The ranked ``tuner.placement.PlacementPlan`` embedded by
        ``launch/tune --placement-report`` (None when the plan was
        tuned without one).  Lives in ``meta`` so one JSON file carries
        sweep + topology + placement through ``tune -> train``."""
        doc = self.meta.get("placement")
        if not doc:
            return None
        from repro_torch.tuner.placement import PlacementPlan
        return PlacementPlan.from_json(doc)

    def calibration(self) -> dict:
        """The learned measured/oracle calibration table persisted by
        ``tuner.online.OnlineTuner.refresh`` (see
        ``calibration_export``): ``{"scales": [...], "levels": [...]}``
        with per-(backend, level, primitive) pricing scales and the
        per-(backend, level) aggregate that ``obs.health`` reads as a
        fabric-drift signal.  Empty dict when the plan carries no
        measurements.  Free-form ``meta`` keys load under every
        readable plan version, so no format bump is needed."""
        return dict(self.meta.get("calibration") or {})

    def levels(self) -> tuple:
        """Distinct level keys appearing in the plan's cells."""
        return tuple(sorted({k[3] for k in self.entries if len(k) == 4}))

    def lookup(self, primitive: str, msg_bytes: int, nranks: int,
               level: Optional[str] = None) -> Optional[Choice]:
        """Nearest-bucket plan lookup (None if the primitive is untuned).

        With ``level``, only cells tuned for that (level index, fabric
        fingerprint) match; when the level is untuned the lookup falls
        back to the plan's level-agnostic cells.  Answers are memoised
        until the next ``add``."""
        memo = (primitive, size_bucket(max(1, msg_bytes)), nranks, level)
        if memo not in self._lookups:
            self._lookups[memo] = self._lookup(primitive, msg_bytes,
                                               nranks, level)
        return self._lookups[memo]

    def _lookup(self, primitive: str, msg_bytes: int, nranks: int,
                level: Optional[str]) -> Optional[Choice]:
        keys = [k for k in self.entries
                if k[0] == primitive and len(k) == 4 and k[3] == level] \
            if level is not None else []
        if not keys:
            keys = [k for k in self.entries
                    if k[0] == primitive and len(k) == 3]
        if not keys:
            return None
        want_b = size_bucket(max(1, msg_bytes))
        # Nearest tuned nranks first (ties to the smaller) ...
        best_n = min({k[2] for k in keys},
                     key=lambda n: (abs(n - nranks), n))
        # ... then the nearest tuned bucket within that nranks.
        best_b = min({k[1] for k in keys if k[2] == best_n},
                     key=lambda b: (abs(b - want_b), b))
        for k in keys:
            if k[1] == best_b and k[2] == best_n:
                return self.entries[k]
        return None

    # -- serialization ----------------------------------------------------

    def to_json(self) -> dict:
        entries = []
        for k, c in sorted(self.entries.items(),
                           key=lambda kv: (kv[0][0], kv[0][1], kv[0][2],
                                           kv[0][3] if len(kv[0]) == 4
                                           else "")):
            doc = {"primitive": k[0], "bucket": k[1], "nranks": k[2],
                   **dataclasses.asdict(c)}
            if len(k) == 4:
                doc["level"] = k[3]
            entries.append(doc)
        return {
            "version": PLAN_VERSION,
            "fingerprint": self.fingerprint,
            "meta": self.meta,
            "entries": entries,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "Plan":
        version = doc.get("version")
        if version not in _READABLE_VERSIONS:
            raise PlanVersionError(
                f"unsupported plan format version {version!r}; this "
                f"build reads versions {_READABLE_VERSIONS} "
                f"(current: {PLAN_VERSION}) - re-run repro_torch.launch.tune "
                f"to regenerate the plan")
        plan = cls(fingerprint=doc["fingerprint"],
                   meta=dict(doc.get("meta", {})))
        for e in doc["entries"]:
            key = (e["primitive"], int(e["bucket"]), int(e["nranks"]))
            if e.get("level") is not None:   # v3 level-keyed cell
                key = key + (str(e["level"]),)
            plan.entries[key] = Choice(
                backend=e["backend"],
                slicing_factor=int(e["slicing_factor"]),
                allreduce_mode=e["allreduce_mode"],
                predicted_time=float(e["predicted_time"]),
                baseline_time=float(e["baseline_time"]),
                # v1 plans carry no overlap fields: cost-in-isolation
                overlap=bool(e.get("overlap", False)),
                hidden_time=float(e.get("hidden_time", 0.0)),
                # pre-v4 plans carry no measured feedback: offline-only
                measured_us=float(e.get("measured_us", 0.0)),
                sample_count=int(e.get("sample_count", 0)),
                ewma_alpha=float(e.get("ewma_alpha", 0.0)),
                # pre-v5 plans carry no fusion knob: unfused
                fused=bool(e.get("fused", False)))
        return plan


def save_plan(plan: Plan, path: str) -> None:
    """Write ``plan`` to ``path`` atomically: through a temporary file
    of this call's own in the same directory, renamed over ``path``, so
    a reader (or another process saving the same plan at once) never
    sees half a file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(plan.to_json(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_plan(path: str, *, pool: Optional[CXLPoolConfig] = None,
              ib: Optional[InfiniBandConfig] = None,
              topology: Optional[Topology] = None) -> Plan:
    """Load a plan; when ``pool``/``ib``/``topology`` are given, refuse a
    plan tuned for different hardware.  Topology plans carry their own
    per-level fabric configs, so the flat pool/ib check only applies to
    flat plans."""
    with open(path) as f:
        plan = Plan.from_json(json.load(f))
    plan_topo = plan.topology()
    if topology is not None:
        want = topology.fingerprint()
        if plan.fingerprint != want:
            raise ValueError(
                f"plan {path} was tuned for topology {plan.fingerprint}, "
                f"current topology fingerprints to {want}")
        return plan
    if plan_topo is not None:
        if plan.fingerprint != plan_topo.fingerprint():
            raise ValueError(
                f"plan {path} is corrupt: fingerprint "
                f"{plan.fingerprint} does not match its embedded "
                f"topology ({plan_topo.fingerprint()})")
        return plan
    if pool is not None or ib is not None:
        want = hardware_fingerprint(pool or CXL_POOL, ib or INFINIBAND)
        if plan.fingerprint != want:
            raise ValueError(
                f"plan {path} was tuned for hardware {plan.fingerprint}, "
                f"current config fingerprints to {want}")
    return plan
