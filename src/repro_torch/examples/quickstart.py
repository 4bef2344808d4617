"""Quickstart: the CXL-CCL core in three acts.  Port of
``examples/quickstart.py``.

1. Run a collective through the functional pool emulation (the paper's
   Listing 2/3 data path, byte-for-byte).
2. Price the same collective with the calibrated performance simulator
   and compare against the NCCL-over-InfiniBand model (Fig. 9).
3. Run the deployable backend: 4 ranks (``launch.ranks.spawn``, one
   process each, sharing the card) AllReduce through the shared host pool
   under ``cxl`` (``chunked_reduce`` sums each pool segment's 4 sources),
   held to the numpy sum at rtol 1e-4.

Usage: PYTHONPATH=src python -m repro_torch.examples.quickstart \\
           [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ibmodel, pool, simulator
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import MiB
from repro_torch.examples import add_device, printer

N_RANKS = 4
PARTITION_BYTES = 1 << 20       # a rank's pool partition for part 3


def pool_emulation(say=print) -> np.ndarray:
    """Part 1: AllGather through the pool emulation, checked exact."""
    nranks = 3
    x = np.random.default_rng(0).standard_normal(
        (nranks, 6000)).astype(np.float32)
    out = pool.run_collective("all_gather", x)
    assert out.shape == (nranks, nranks * 6000)
    np.testing.assert_array_equal(out[0].reshape(nranks, -1), x)
    say("pool emulation: AllGather through the CXL pool is exact; "
        "no overlapping writes, no doorbell deadlocks")
    return out


def simulation(say=print) -> list:
    """Part 2: the simulator's AllGather against the IB model."""
    nranks = 3
    rows = []
    say(f"\n{'size':>8} {'CXL-All':>10} {'CXL-Naive':>10} "
        f"{'IB-200':>10} {'speedup':>8}")
    for size in (16 * MiB, 256 * MiB, 1024 * MiB):
        t_all = simulator.run_variant("all", "all_gather", nranks,
                                      size).total_time
        t_nai = simulator.run_variant("naive", "all_gather", nranks,
                                      size).total_time
        t_ib = ibmodel.estimate("all_gather", nranks, size).time
        rows.append({"bytes": size, "all": t_all, "naive": t_nai,
                     "ib": t_ib})
        say(f"{size // MiB:>6}MB {t_all * 1e3:>8.2f}ms "
            f"{t_nai * 1e3:>8.2f}ms {t_ib * 1e3:>8.2f}ms "
            f"{t_ib / t_all:>7.2f}x")
    return rows


def part3_input(n: int) -> np.ndarray:
    """The reference's (n * 8, 4) input, rows split over the ranks."""
    return np.random.default_rng(1).standard_normal(
        (n * 8, 4)).astype(np.float32)


def allreduce_rank(ctx, y: np.ndarray) -> dict:
    """One rank of part 3: its 8 rows of ``y`` AllReduced over an axis of
    every rank under ``cxl`` (slicing factor 4) through the world's pool
    (``ctx.pool``).  Returns the result and the ``chunked_reduce``
    launches this call made, by source count."""
    from repro_torch.core.api import Communicator
    from repro_torch.core.device import synchronize
    from repro_torch.kernels.chunked_reduce import chunked_reduce
    from repro_torch.launch.mesh import make_host_mesh

    n = ctx.nranks
    mesh = make_host_mesh((("x", n),), ctx)
    comm = Communicator(backend="cxl", slicing_factor=4, axes=mesh)
    x = torch.from_numpy(np.ascontiguousarray(
        y.reshape(n, -1, y.shape[-1])[ctx.rank])).to(ctx.device)
    before = dict(chunked_reduce.launches_by_n)
    out = comm.all_reduce(x, "x")
    synchronize(ctx.device)
    by_n = {k: v - before.get(k, 0)
            for k, v in chunked_reduce.launches_by_n.items()
            if v != before.get(k, 0)}
    return {"out": out.cpu().numpy(), "chunked_reduce_by_n": by_n}


def check_allreduce(per_rank: list, y: np.ndarray) -> None:
    """Every rank's result is the numpy sum of the ranks' rows."""
    n = len(per_rank)
    np.testing.assert_allclose(
        np.stack([r["out"] for r in per_rank]),
        np.tile(y.reshape(n, -1, y.shape[-1]).sum(0), (n, 1, 1)),
        rtol=1e-4)


def mesh_backend(device: str, say=print, nranks: int = N_RANKS) -> list:
    """Part 3 on ``nranks`` spawned ranks; returns their results."""
    from repro_torch.launch import ranks
    if device == "cuda":
        from repro_torch.kernels import build
        build.build_all(("chunked_reduce",))   # once, before the ranks
    y = part3_input(nranks)
    per_rank = ranks.spawn(allreduce_rank, nranks, (y,), device=device,
                           partition_bytes=PARTITION_BYTES, timeout_s=300)
    check_allreduce(per_rank, y)
    say(f"\nmesh backend: cxl-scheduled AllReduce exact on {nranks} "
        f"ranks ({device}) through the shared pool")
    return per_rank


def build_parser() -> argparse.ArgumentParser:
    return add_device(argparse.ArgumentParser())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    lines: list = []
    say = printer(lines)
    pool_emulation(say)
    rows = simulation(say)
    per_rank = mesh_backend(args.device, say)
    return {"lines": lines, "simulation": rows, "ranks": per_rank}


if __name__ == "__main__":
    main()
