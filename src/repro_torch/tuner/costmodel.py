"""Roofline residency of a compute region, priced on the H100.

Ported from ``repro.tuner.costmodel``: only ``roofline_compute_time``,
which the serving KV tier prices recompute with.  The collective
oracles (pool simulator, InfiniBand alpha-beta model) come with the
pool-machinery slice.
"""
from __future__ import annotations

from repro_torch.core.hw import H100_SXM


def roofline_compute_time(flops: float, hbm_bytes: float = 0.0, *,
                          peak_flops: float = H100_SXM.peak_flops_bf16,
                          hbm_bw: float = H100_SXM.hbm_bw) -> float:
    """Roofline residency of a compute region: the window a collective
    can hide behind is bounded by whichever resource the region
    saturates (tensor cores or HBM), not by wall-clock guesses."""
    if flops < 0 or hbm_bytes < 0:
        raise ValueError("flops/bytes must be non-negative")
    return max(flops / peak_flops, hbm_bytes / hbm_bw)
