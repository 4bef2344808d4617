"""The tuner's per-cell decision record.

Ported from ``repro.tuner.plan``: only the :class:`Choice` dataclass,
which the serving KV tier returns from its placement oracle.  Plans
(``Plan``, the v1-v6 load chain, ``--plan``) come with the
pool-machinery slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Choice:
    """The knobs the tuner picked for one (primitive, bucket, nranks)."""

    backend: str                       # 'ring' | 'cxl' | 'pool' | ...
    slicing_factor: int = 4
    allreduce_mode: str = "two_phase"
    predicted_time: float = 0.0        # cost-model time of this choice
                                       # (exposed time when overlap-tuned)
    baseline_time: float = 0.0         # best fixed-knob alternative
    # Overlap-aware costing: when the cell was tuned against the compute
    # it overlaps, ``overlap`` is True and ``hidden_time`` is the wire
    # time the roofline-residency model expects compute to hide.
    overlap: bool = False
    hidden_time: float = 0.0
    # Online re-tuning feedback (plan format v4): the EWMA of measured
    # wall time (microseconds) over ``sample_count`` samples.
    measured_us: float = 0.0
    sample_count: int = 0
    ewma_alpha: float = 0.0
    # Fused collective+compute kernel (plan format v5).
    fused: bool = False

    def effective_time(self, min_samples: int = 1) -> float:
        """The cell's best per-launch cost estimate in seconds: the
        persisted measured EWMA once ``min_samples`` samples backed it,
        else the oracle prediction."""
        if self.sample_count >= max(1, min_samples) and \
                self.measured_us > 0.0:
            return self.measured_us * 1e-6
        return self.predicted_time
