"""The flat collectives across the ranks of one host: check and time.

Every flat primitive of the ``Communicator`` (``core.api``) runs on
``nranks`` processes (``launch.ranks``) under both backends, ``ring``
(the process group's own collectives) and ``cxl`` (the paper's schedules
on the shared host pool), and each rank's result is held to a numpy
oracle of the primitive's semantics.  Inputs are small integers in
float32, so every sum is exact and every comparison is bitwise.

  PYTHONPATH=src python -m repro_torch.launch.collectives --nranks 4 \\
      --sizes-mb 1,16,256 [--device cpu]

prints one line per (primitive, size, backend): the median wall time of
the call over ``--reps`` runs after one untimed warm-up call (the
slowest rank's median; ranks start each run together at a barrier and
the time ends once the result is on the device) and whether every
rank's result matched.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ledger
from repro_torch.core.api import Communicator
from repro_torch.core.device import synchronize
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_host_mesh

ROOT = 2          # not rank 0, so a wrong default root shows
# name -> (Communicator method, allreduce_mode)
PRIMITIVES = {
    "all_gather": ("all_gather", None),
    "reduce_scatter": ("reduce_scatter", None),
    "all_reduce_faithful": ("all_reduce", "faithful"),
    "all_reduce_two_phase": ("all_reduce", "two_phase"),
    "all_to_all": ("all_to_all", None),
    "broadcast": ("broadcast", None),
    "reduce": ("reduce", None),
    "gather": ("gather", None),
    "scatter": ("scatter", None),
    "p2p": ("send", None),
}
ROOTED = ("broadcast", "reduce", "gather", "scatter")
COLS = 1024                     # columns of a bench input (f32)


def communicator(ctx: ranks.RankContext, backend: str, name: str,
                 slicing_factor: int = 4, plan=None) -> Communicator:
    """This rank's Communicator for primitive ``name`` (its AllReduce
    mode; under ``auto`` the ``plan`` decides the knobs)."""
    mode = PRIMITIVES[name][1] or "two_phase"
    mesh = make_host_mesh(ctx.nranks, ctx.rank,
                          None if backend == "ring" else ctx.pool)
    return Communicator(backend=backend, slicing_factor=slicing_factor,
                        allreduce_mode=mode, axes=mesh, plan=plan)


def call(comm: Communicator, name: str, x: torch.Tensor,
         root: int = ROOT) -> torch.Tensor:
    method = getattr(comm, PRIMITIVES[name][0])
    if name in ROOTED:
        return method(x, "data", root=root % comm.axis_size("data"))
    return method(x, "data")


def oracle(name: str, xs: Sequence[np.ndarray], rank: int,
           root: int = ROOT) -> np.ndarray:
    """What rank ``rank`` must return, from every rank's input."""
    n = len(xs)
    root %= n
    seg = xs[0].shape[0] // n if xs[0].ndim else 0

    def part(x, i):
        return x[i * seg:(i + 1) * seg]

    if name in ("all_gather", "gather"):
        full = np.concatenate(xs)
        return full if name == "all_gather" or rank == root \
            else np.zeros_like(full)
    total = np.sum(np.stack(xs), axis=0, dtype=np.float32)
    if name == "reduce_scatter":
        return part(total, rank)
    if name.startswith("all_reduce"):
        return total
    if name == "reduce":
        return total if rank == root else np.zeros_like(total)
    if name == "all_to_all":
        return np.concatenate([part(xs[p], rank) for p in range(n)])
    if name == "broadcast":
        return xs[root]
    if name == "scatter":
        return part(xs[root], rank)
    if name == "p2p":
        return xs[(rank - 1) % n]
    raise ValueError(f"unknown primitive {name!r}")


def bench_input(rank: int, rows: int, device) -> torch.Tensor:
    """Rank ``rank``'s (rows, COLS) input: small integers, exact sums."""
    i = torch.arange(rows * COLS, device=device, dtype=torch.int64)
    return ((i * 7 + rank * 13) % 17 - 8).to(torch.float32) \
        .reshape(rows, COLS)


def bench_input_numpy(rank: int, rows: int) -> np.ndarray:
    i = np.arange(rows * COLS, dtype=np.int64)
    return ((i * 7 + rank * 13) % 17 - 8).astype(np.float32) \
        .reshape(rows, COLS)


def rank_cases(ctx: ranks.RankContext, cases: Sequence[dict]) -> list:
    """Run each case once on this rank: ``cases`` are dicts with
    ``name``, ``backend``, ``slicing_factor``, ``x`` (every rank's numpy
    input) and, under ``auto``, ``plan``.  Returns [(this rank's output
    as numpy, the ledger's wire bytes of the call)]."""
    out = []
    for c in cases:
        comm = communicator(ctx, c["backend"], c["name"],
                            c.get("slicing_factor", 4), c.get("plan"))
        x = torch.as_tensor(c["x"][ctx.rank]).to(ctx.device)
        ledger.reset()
        y = call(comm, c["name"], x)
        out.append((y.cpu().numpy(), ledger.snapshot()["wire_bytes"]))
    return out


def rank_bench(ctx: ranks.RankContext, sizes_mb: Sequence[int],
               reps: int, names: Sequence[str]) -> list:
    """Median wall time of each (primitive, size, backend) on this rank
    over ``reps`` timed calls after an untimed one, and whether the
    untimed call's result matched the oracle."""
    import torch.distributed as dist
    rows_of = {mb: mb * (1 << 20) // (4 * COLS) for mb in sizes_mb}
    out = []
    for mb in sizes_mb:
        rows = rows_of[mb]
        x = bench_input(ctx.rank, rows, ctx.device)
        xs = None
        for name in names:
            for backend in ("ring", "cxl"):
                comm = communicator(ctx, backend, name)
                times, ok = [], None
                for i in range(reps + 1):     # call 0 warms up, untimed
                    dist.barrier()
                    synchronize(ctx.device)
                    t0 = time.perf_counter()
                    y = call(comm, name, x)
                    synchronize(ctx.device)
                    if i > 0:
                        times.append(time.perf_counter() - t0)
                    else:
                        if xs is None:
                            xs = [bench_input_numpy(r, rows)
                                  for r in range(ctx.nranks)]
                        ok = bool(np.array_equal(
                            y.cpu().numpy(), oracle(name, xs, ctx.rank)))
                    del y
                out.append({"primitive": name, "mb": mb, "backend": backend,
                            "median_s": float(np.median(times)), "ok": ok})
        del x, xs
    return out


def bench(nranks: int = 4, sizes_mb: Sequence[int] = (1, 16, 256),
          reps: int = 5, device: str = "cuda",
          names: Sequence[str] = tuple(PRIMITIVES),
          timeout_s: float = 600.0) -> list:
    """Every rank's :func:`rank_bench`, merged: per (primitive, size,
    backend) the slowest rank's median and whether all ranks matched."""
    per_rank = ranks.spawn(rank_bench, nranks,
                           (tuple(sizes_mb), reps, tuple(names)),
                           device=device,
                           partition_bytes=max(sizes_mb) << 20,
                           timeout_s=timeout_s)
    rows = []
    for i, row in enumerate(per_rank[0]):
        recs = [r[i] for r in per_rank]
        rows.append(dict(row, median_s=max(r["median_s"] for r in recs),
                         ok=all(r["ok"] for r in recs)))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nranks", type=int, default=4)
    ap.add_argument("--sizes-mb", default="1,16,256")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = bench(args.nranks, [int(s) for s in args.sizes_mb.split(",")],
                 args.reps, args.device)
    for r in rows:
        print(json.dumps(r), flush=True)
    if not all(r["ok"] for r in rows):
        raise SystemExit("a collective disagreed with its oracle")
    return rows


if __name__ == "__main__":
    main()
