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

  PYTHONPATH=src python -m repro_torch.launch.collectives --nranks 4 \\
      --multi-pod --topology pod:cxl,data:ici --sizes-mb 1,16,256

times the primitives of a hierarchical axis instead: each of
``TUPLE_PRIMITIVES`` over the tuple ``("pod", "data")`` = (2, N/2),
decomposed against the topology (default ``pod:cxl,data:ici``), and the
same primitive over the flat axis of all N ranks, under ``cxl``,
``auto`` (each on a plan tuned here: per level for the tuple, for N
ranks for the flat axis) and, at 16 MB a rank and below, ``ring``.
Each result is held to the oracle and the tuple's to the flat one's,
bitwise; each line also carries the ledger's wire bytes by level.
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
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.topology import Topology, parse_topology
from repro_torch.launch import ranks
from repro_torch.launch.mesh import level_groups, make_host_mesh, mesh_shape

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
# the primitives a hierarchical axis takes (all_to_all and the p2p shift
# stay single-axis), and their root: not in rank 0's inner group
TUPLE_PRIMITIVES = tuple(n for n in PRIMITIVES
                         if n not in ("all_to_all", "p2p"))
TUPLE_ROOT = 3
TUPLE_AXIS = ("pod", "data")
DEFAULT_TOPOLOGY = "pod:cxl,data:ici"


def communicator(ctx: ranks.RankContext, backend: str, name: str,
                 slicing_factor: int = 4, plan=None,
                 shape: Optional[Sequence[tuple]] = None,
                 topology: Optional[Topology] = None) -> Communicator:
    """This rank's Communicator for primitive ``name`` (its AllReduce
    mode; under ``auto`` the ``plan`` decides the knobs) on the mesh of
    ``shape`` (``launch.mesh``; default: the flat mesh of all the
    ranks), with ``topology`` as its ``topology`` field (a grouped level
    of it also groups its mesh axis)."""
    mode = PRIMITIVES[name][1] or "two_phase"
    mesh = make_host_mesh(shape or mesh_shape(ctx.nranks), ctx,
                          pools=backend != "ring", topology=topology)
    return Communicator(backend=backend, slicing_factor=slicing_factor,
                        allreduce_mode=mode, axes=mesh, plan=plan,
                        topology=topology)


def call(comm: Communicator, name: str, x: torch.Tensor,
         root: int = ROOT, axis="data") -> torch.Tensor:
    method = getattr(comm, PRIMITIVES[name][0])
    if name in ROOTED:
        return method(x, axis, root=root % comm.axis_size(axis))
    return method(x, axis)


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
    input) and, under ``auto``, ``plan``; optionally ``shape`` (the
    mesh), ``axis`` (a name or a tuple of names; default ``"data"``),
    ``topology``, ``root``, ``dtype`` (the input's, from f32) and
    ``then`` (a second primitive applied to the first's output over the
    same axis, e.g. reduce_scatter then all_gather).  Returns [(this
    rank's output as f32 numpy, the ledger's wire bytes of the call)],
    or with ``ledger=True`` in a case the whole ``ledger.snapshot()`` in
    place of the wire bytes."""
    out = []
    for c in cases:
        comm = communicator(ctx, c["backend"], c["name"],
                            c.get("slicing_factor", 4), c.get("plan"),
                            c.get("shape"), c.get("topology"))
        x = torch.as_tensor(c["x"][ctx.rank]).to(
            ctx.device, getattr(torch, c.get("dtype", "float32")))
        ledger.reset()
        y = call(comm, c["name"], x, c.get("root", ROOT),
                 c.get("axis", "data"))
        if c.get("then"):
            y = call(comm, c["then"], y, c.get("root", ROOT),
                     c.get("axis", "data"))
        snap = ledger.snapshot()
        out.append((y.float().cpu().numpy(),
                    snap if c.get("ledger") else snap["wire_bytes"]))
    return out


def rank_bench(ctx: ranks.RankContext, sizes_mb: Sequence[int],
               reps: int, names: Sequence[str],
               ring_max_mb: Optional[int] = None) -> list:
    """Median wall time of each (primitive, size, backend) on this rank
    over ``reps`` timed calls after an untimed one, and whether the
    untimed call's result matched the oracle; ``ring`` only at sizes up
    to ``ring_max_mb`` (default: every size)."""
    import torch.distributed as dist
    rows_of = {mb: mb * (1 << 20) // (4 * COLS) for mb in sizes_mb}
    out = []
    for mb in sizes_mb:
        rows = rows_of[mb]
        x = bench_input(ctx.rank, rows, ctx.device)
        xs = None
        ring = ring_max_mb is None or mb <= ring_max_mb
        for name in names:
            for backend in ("ring", "cxl") if ring else ("cxl",):
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
          timeout_s: float = 600.0,
          ring_max_mb: Optional[int] = None) -> list:
    """Every rank's :func:`rank_bench`, merged: per (primitive, size,
    backend) the slowest rank's median and whether all ranks matched;
    ``ring`` (gloo, staged through the host) only up to ``ring_max_mb``
    MB a rank (default: every size)."""
    per_rank = ranks.spawn(rank_bench, nranks,
                           (tuple(sizes_mb), reps, tuple(names),
                            ring_max_mb),
                           device=device,
                           partition_bytes=max(sizes_mb) << 20,
                           timeout_s=timeout_s)
    return _merge_rows(per_rank)


def tuple_backends(mb: int) -> tuple:
    """The backends the tuple bench runs at ``mb`` MB a rank: ring (gloo,
    staged through the host) only up to 16 MB."""
    return ("cxl", "auto") + (("ring",) if mb <= 16 else ())


def rank_bench_tuple(ctx: ranks.RankContext, sizes_mb: Sequence[int],
                     reps: int, names: Sequence[str], topology: Topology,
                     plans: dict) -> list:
    """Each (primitive, size, backend) over the flat axis of all the
    ranks and over ``TUPLE_AXIS`` on this rank: the median wall time of
    ``reps`` timed calls after an untimed one, whether the untimed
    call's result matched the oracle, whether the tuple's equalled the
    flat one's, and the untimed call's wire bytes by level.  ``plans``:
    ``{"flat": plan, "tuple": plan}`` for ``auto``."""
    import torch.distributed as dist
    out = []
    for mb in sizes_mb:
        rows = mb * (1 << 20) // (4 * COLS)
        x = bench_input(ctx.rank, rows, ctx.device)
        xs = [bench_input_numpy(r, rows) for r in range(ctx.nranks)]
        for name in names:
            want = oracle(name, xs, ctx.rank, TUPLE_ROOT)
            for backend in tuple_backends(mb):
                flat_y = None
                for kind in ("flat", "tuple"):
                    hier = kind == "tuple"
                    comm = communicator(
                        ctx, backend, name,
                        plan=plans[kind] if backend == "auto" else None,
                        shape=mesh_shape(ctx.nranks, 1, hier),
                        topology=topology if hier else None)
                    axis = TUPLE_AXIS if hier else "data"
                    times, rec = [], {}
                    for i in range(reps + 1):   # call 0 warms up, untimed
                        dist.barrier()
                        synchronize(ctx.device)
                        ledger.reset()
                        t0 = time.perf_counter()
                        y = call(comm, name, x, TUPLE_ROOT, axis)
                        synchronize(ctx.device)
                        if i > 0:
                            times.append(time.perf_counter() - t0)
                            continue
                        snap = ledger.snapshot()
                        rec = {"ok": bool(np.array_equal(y.cpu().numpy(),
                                                         want)),
                               "level_wire_bytes": snap["level_wire_bytes"],
                               "wire_bytes": snap["wire_bytes"]}
                        if hier:
                            rec["equal_flat"] = bool(torch.equal(y, flat_y))
                        else:
                            flat_y = y
                    out.append({"primitive": name, "mb": mb,
                                "backend": backend, "axis": kind,
                                "median_s": float(np.median(times)), **rec})
                    del y
                del flat_y
            del want
        del x, xs
    return out


def _tuple_plans(nranks: int, sizes_mb: Sequence[int],
                 topology: Topology) -> dict:
    """The plans ``auto`` resolves against in the tuple bench, tuned here
    for its sizes: the flat axis's, and the tuple's per level of
    ``topology``."""
    from repro_torch import tuner
    sizes = tuple(mb << 20 for mb in sizes_mb)
    return {"flat": tuner.generate_plan(tuner.TuneGrid(
                nranks=(nranks,), sizes=sizes)),
            "tuple": tuner.generate_plan(tuner.TuneGrid(
                nranks=tuple(sorted({2, nranks // 2})), sizes=sizes),
                topology=topology)}


def bench_tuple(nranks: int = 4, sizes_mb: Sequence[int] = (1, 16, 256),
                reps: int = 3, device: str = "cuda",
                names: Sequence[str] = TUPLE_PRIMITIVES,
                topology: Optional[Topology] = None,
                timeout_s: float = 600.0) -> list:
    """Every rank's :func:`rank_bench_tuple`, merged as :func:`bench`
    merges; ``auto`` resolves against plans tuned here for these sizes
    (the tuple's per level of ``topology``)."""
    topology = topology or parse_topology(DEFAULT_TOPOLOGY)
    plans = _tuple_plans(nranks, sizes_mb, topology)
    shape = mesh_shape(nranks, 1, True)
    per_rank = ranks.spawn(rank_bench_tuple, nranks,
                           (tuple(sizes_mb), reps, tuple(names), topology,
                            plans),
                           device=device, partition_bytes=max(sizes_mb) << 20,
                           groups=level_groups(shape), timeout_s=timeout_s)
    return _merge_rows(per_rank)


def rank_bench_all(ctx: ranks.RankContext, flat_args: tuple,
                   tuple_args: tuple) -> tuple:
    """:func:`rank_bench` then :func:`rank_bench_tuple` on this rank."""
    return rank_bench(ctx, *flat_args), rank_bench_tuple(ctx, *tuple_args)


def bench_all(nranks: int = 4, sizes_mb: Sequence[int] = (1, 16, 256),
              tuple_sizes_mb: Sequence[int] = (1, 16), reps: int = 3,
              device: str = "cuda", ring_max_mb: Optional[int] = None,
              topology: Optional[Topology] = None,
              names: Sequence[str] = tuple(PRIMITIVES),
              tuple_names: Sequence[str] = TUPLE_PRIMITIVES,
              timeout_s: float = 600.0) -> tuple:
    """:func:`bench` and :func:`bench_tuple` on ONE spawn of the ranks
    (each rank maps the flat pool and the level groups' pools, at the
    larger partition): (flat rows, tuple rows), merged as each merges."""
    topology = topology or parse_topology(DEFAULT_TOPOLOGY)
    plans = _tuple_plans(nranks, tuple_sizes_mb, topology)
    per_rank = ranks.spawn(
        rank_bench_all, nranks,
        ((tuple(sizes_mb), reps, tuple(names), ring_max_mb),
         (tuple(tuple_sizes_mb), reps, tuple(tuple_names), topology,
          plans)),
        device=device,
        partition_bytes=max(tuple(sizes_mb) + tuple(tuple_sizes_mb)) << 20,
        groups=level_groups(mesh_shape(nranks, 1, True)),
        timeout_s=timeout_s)
    return (_merge_rows([r[0] for r in per_rank]),
            _merge_rows([r[1] for r in per_rank]))


def _merge_rows(per_rank: list) -> list:
    """Every rank's rows -> one a cell: the slowest rank's median,
    whether all ranks matched the oracle (and, for a tuple row, the flat
    axis)."""
    rows = []
    for i, row in enumerate(per_rank[0]):
        recs = [r[i] for r in per_rank]
        merged = dict(row, median_s=max(r["median_s"] for r in recs),
                      ok=all(r["ok"] for r in recs))
        if "equal_flat" in row:
            merged["equal_flat"] = all(r["equal_flat"] for r in recs)
        rows.append(merged)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nranks", type=int, default=4)
    ap.add_argument("--sizes-mb", default="1,16,256")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multi-pod", action="store_true",
                    help="time the primitives over (pod, data) = "
                         "(2, N/2) beside the flat axis")
    ap.add_argument("--topology", default=None,
                    help=f"with --multi-pod: the 'axis:fabric,...' spec "
                         f"or JSON file the tuple decomposes against "
                         f"(default {DEFAULT_TOPOLOGY})")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes_mb.split(",")]
    if args.multi_pod:
        resolve_device(args.device)        # raises without a card
        mesh_shape(args.nranks, 1, True)   # odd N raises
        rows = bench_tuple(args.nranks, sizes, args.reps, args.device,
                           topology=parse_topology(args.topology)
                           if args.topology else None)
        for r in rows:
            print(json.dumps(r), flush=True)
        if not all(r["ok"] and r.get("equal_flat", True) for r in rows):
            raise SystemExit("a collective disagreed with its oracle or "
                             "with the flat axis")
        return rows
    rows = bench(args.nranks, sizes, args.reps, args.device)
    for r in rows:
        print(json.dumps(r), flush=True)
    if not all(r["ok"] for r in rows):
        raise SystemExit("a collective disagreed with its oracle")
    return rows


if __name__ == "__main__":
    main()
