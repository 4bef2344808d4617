"""Hardware constants: the paper's CXL pool testbed (Sec. 5.1) and the
NVIDIA H100 that the port's roofline prices compute against.

The CXL-side numbers are taken directly from the paper's characterization
(Fig. 3, Table 1, Sec. 2.2): a TITAN-II CXL 2.0 switch fronting six Micron
CZ120 cards (PCIe/CXL Gen5 x8 each), three H100 nodes on Gen5 x16 links.
They are copied unchanged from ``repro.core.hw``.  The innermost fabric
level (``ici`` in topology specs, the name kept so specs and plans
interchange with the reference) gets NVLink-class constants of the H100
SXM instead of the reference's chip-to-chip links.
"""
from __future__ import annotations

import dataclasses

GiB = 1024**3
MiB = 1024**2
KiB = 1024


@dataclasses.dataclass(frozen=True)
class CXLPoolConfig:
    """The paper's shared memory pool (Sec. 2.2, 5.1, Fig. 3)."""

    num_devices: int = 6                 # Micron CZ120 cards
    device_capacity: int = 128 * GiB     # per card -> 768 GB pool
    # Fig. 3a: sustained bandwidth saturates ~20 GB/s for >=1 MB transfers,
    # limited by the card's Gen5 x8 link (Observation 1).
    device_bw: float = 20e9              # per direction, bytes/s
    # Observation 1: the GPU's single DMA engine per direction caps each
    # *server* at the same ~20 GB/s per direction even across devices.
    server_bw: float = 20e9              # per direction, bytes/s
    # When one device serves reads and writes simultaneously the effective
    # per-direction bandwidth degrades (Fig. 3b/3c show contention effects).
    bidir_efficiency: float = 0.75
    # Table 1: 64B pool access latency (MLC) = 658 ns vs 214 ns local DRAM.
    access_latency: float = 658e-9       # seconds
    dram_latency: float = 214e-9
    # Fig. 3a ramp: small transfers are latency/overhead bound.  We model a
    # fixed per-cudaMemcpyAsync software overhead; the paper attributes the
    # small-message losses (ReduceScatter/Scatter/AllToAll < ~64 MB) to
    # "software overheads such as cudaMemcpy invocation and synchronization".
    memcpy_overhead: float = 8e-6        # seconds per issued copy
    # Doorbell cost: flush + re-read across the switch (2 pool accesses) plus
    # a short poll sleep (Listing 3 sleeps between polls).
    doorbell_latency: float = 2 * 658e-9
    poll_interval: float = 1e-6
    switch_bw: float = 2e12              # 2 TB/s max switching bandwidth

    @property
    def pool_capacity(self) -> int:
        return self.num_devices * self.device_capacity


@dataclasses.dataclass(frozen=True)
class InfiniBandConfig:
    """200 Gb/s InfiniBand baseline (paper Sec. 5.1)."""

    link_bw: float = 200e9 / 8           # 25 GB/s line rate
    efficiency: float = 0.88             # protocol + copy-RDMA pipeline
    # Per-RDMA-message overhead: the copy-RDMA pipeline needs GPU<->CPU
    # synchronization at every stage (Sec. 4.1, Fig. 4).
    message_overhead: float = 6e-6
    latency: float = 2e-6                # end-to-end small-message latency

    @property
    def effective_bw(self) -> float:
        return self.link_bw * self.efficiency


@dataclasses.dataclass(frozen=True)
class ICIConfig:
    """Intra-node ring interconnect: the fabric of a topology's
    innermost ``ici`` level, where collectives ride GPU-to-GPU links and
    never touch the pool or the NIC (``core.topology``).

    Defaults are NVLink 4 of the H100 SXM (see ``ICI_VARIANT``): the
    data sheet's 900 GB/s per GPU counts both directions, so a ring
    direction gets 450 GB/s.  ``efficiency``, ``message_overhead`` and
    ``latency`` are modelling assumptions of this package, not data
    sheet figures and not measured.  The fields are the reference's, so
    topology JSON with ``ici`` overrides reads in both packages."""

    link_bw: float = 450e9               # bytes/s per direction
    efficiency: float = 0.80             # assumed share of line rate
    message_overhead: float = 2e-6       # assumed per-hop issue cost
    latency: float = 1e-6                # assumed hop latency

    @property
    def effective_bw(self) -> float:
        return self.link_bw * self.efficiency


# The part the ICIConfig defaults describe (NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 column: NVLink 900 GB/s).
ICI_VARIANT = "H100 SXM5 80GB, NVLink 4"


@dataclasses.dataclass(frozen=True)
class GPUConfig:
    """Roofline constants of one NVIDIA GPU (dense rates, no sparsity).

    ``variant`` names the part the numbers belong to: the rates differ
    between the SXM and PCIe H100, and assume the full power limit
    (700 W for the SXM part): a card set below it runs slower."""

    variant: str
    peak_flops_bf16: float               # tensor cores, FLOP/s
    peak_flops_tf32: float               # tensor cores, FLOP/s
    peak_flops_fp32: float               # CUDA cores (non-tensor), FLOP/s
    hbm_bw: float                        # bytes/s
    hbm_capacity: int                    # bytes


# NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB column.
H100_SXM = GPUConfig(variant="H100 SXM5 80GB",
                     peak_flops_bf16=989e12, peak_flops_tf32=495e12,
                     peak_flops_fp32=67e12, hbm_bw=3.35e12,
                     hbm_capacity=80 * 10**9)


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """Sec. 5.5: interconnect hardware cost."""

    ib_switch_cost: float = 16_000.0     # $ for a 200 Gbps IB switch
    cxl_switch_cost: float = 5_800.0     # $ for the CXL switch

    @property
    def cost_ratio(self) -> float:
        return self.ib_switch_cost / self.cxl_switch_cost  # 2.75x


CXL_POOL = CXLPoolConfig()
INFINIBAND = InfiniBandConfig()
ICI = ICIConfig()
COST = CostConfig()
