"""Elastic reconfiguration of a data-parallel loop: a run loses a rank,
re-plans, and the survivors continue from the pool on a smaller spawn.

Port of the reference's ``check_survivor_reconfig``
(``tests/_mesh_runner.py``), at 4 -> 3 ranks of one host:

  PYTHONPATH=src python -m repro_torch.launch.survivor [--device cpu]

1. A spawn of 4 ranks runs the reference's step - ``all_reduce`` of
   ``x * p``, ``reduce_scatter``, ``all_gather``, ``p -= 0.1 * ...`` of
   a replicated ``(ROWS, 4)`` parameter, each rank its own ``(ROWS, 4)``
   rows of ``x`` - under ``cxl`` over ``pod:cxl,data:cxl:2+2`` (the data
   axis grouped 2+2).  ``rank_death@2:rank=3`` is injected
   (``resilience.FaultPlan`` over ``RANK_OPS``), every rank snapshots
   ``p`` into its partition of the pool store every 2 steps, and each
   rank's ``FailureMonitor`` (heartbeats every rank maps, pool errors
   summed over the ranks) and ``ResilienceController`` confirm the
   death, on every rank at the same step, and re-plan the data level to
   ``2+1``.
2. A spawn of the 3 survivors, under the survivor topology, maps the
   same pool store (it outlived the first spawn), restores the newest
   step every partition committed, and runs 3 steps with
   ``backend="auto"`` on the recovery plan (the ragged 2+1 schedules:
   within-group at the data level, the sub-root exchange at the pod
   level), then 3 steps of a flat 3-rank ``cxl`` run from the same
   state and inputs.

``ROWS`` is 84, not the reference's 56: the parameter's rows split over
4 ranks before the fault and 3 after it.  ``run`` returns both spawns'
records; ``check`` holds them to the reference's assertions (the
ragged run equal to the flat one at rtol 1e-4, atol 1e-6; ledger bytes
at ``data/cxl`` and ``pod/cxl``, pod's fewer; the auto audit at
``("data", 2)`` and ``("pod", 2)``; steps lost at most 8).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import ledger
from repro_torch.core.api import Communicator
from repro_torch.core.pool import PoolAccessError, create_backing
from repro_torch.core.topology import (Topology, parse_topology,
                                       set_active_topology)
from repro_torch.kernels.chunked_reduce import chunked_reduce
from repro_torch.launch import ranks
from repro_torch.launch.mesh import level_groups, make_host_mesh, mesh_shape
from repro_torch.resilience import (RANK_OPS, FailureMonitor, FaultPlan,
                                    ResilienceController)
from repro_torch.training.checkpoint import PoolRegion
from repro_torch.tuner import runtime as tuner_runtime
from repro_torch.tuner.plan import Plan

NRANKS = 4
ROWS = 84
TOPOLOGY = "pod:cxl,data:cxl:2+2"
FAULT = "rank_death@2:rank=3"
FAULT_STEP = 2
SNAPSHOT_EVERY = 2
MAX_STEPS = 12
RESUME_STEPS = 3
SEED = 31
STORE_BYTES = 1 << 20
PARTITION_BYTES = 1 << 20


def inputs(seed: int = SEED) -> dict:
    """The run's numpy state and inputs, from one detached stream in
    the reference's draw order: ``p``, then one ``(n * ROWS, 4)`` batch
    a step of the first spawn, then ``RESUME_STEPS`` of the survivors'
    (drawn for all ``MAX_STEPS``, so the resume's inputs do not depend
    on when the death is confirmed)."""
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal((ROWS, 4)).astype(np.float32) * 1e-3)
    xs = [rng.standard_normal((NRANKS * ROWS, 4)).astype(np.float32)
          for _ in range(MAX_STEPS)]
    resume = [rng.standard_normal(((NRANKS - 1) * ROWS, 4))
              .astype(np.float32) for _ in range(RESUME_STEPS)]
    return {"p": p, "xs": xs, "resume": resume}


def _step(comm: Communicator, p: torch.Tensor, x: torch.Tensor,
          axis: str = "data") -> torch.Tensor:
    """The reference's step (``make_step``): one AllReduce, one
    ReduceScatter and one AllGather over ``axis``."""
    g = comm.all_reduce(x * p, axis)
    piece = comm.reduce_scatter(g, axis)
    return p - 0.1 * comm.all_gather(piece, axis)


def _rows(x: np.ndarray, rank: int, dev) -> torch.Tensor:
    return torch.as_tensor(x[rank * ROWS:(rank + 1) * ROWS], device=dev)


def _gather(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _until_confirmed(ctx: ranks.RankContext, path: str, data: dict) -> dict:
    """Spawn 1, on every rank: the 4-rank loop until the controller
    returns a recovery plan."""
    dev = ctx.device
    topo = parse_topology(TOPOLOGY)
    set_active_topology(topo)
    shape = mesh_shape(ctx.nranks)
    comm = Communicator(backend="cxl", axes=make_host_mesh(
        shape, ctx, topology=topo), topology=topo)
    region = PoolRegion(path, ctx.nranks, ctx.rank, STORE_BYTES, dev)
    tuner_runtime.clear_rank_liveness()
    mon = FailureMonitor(ctx.nranks, heartbeats=region.heartbeats)
    ctl = ResilienceController(mon, topology=topo, log=lambda *_: None)
    fp = FaultPlan.parse(FAULT, ops=RANK_OPS)
    p = torch.as_tensor(data["p"], device=dev)
    out: dict = {"steps": []}
    chunked_reduce.launches, chunked_reduce.launches_by_n = 0, {}
    rp = None
    with fp:
        for i in range(MAX_STEPS):
            fp.begin_step(i)
            p = _step(comm, p, _rows(data["xs"][i], ctx.rank, dev))
            rec: dict = {}
            if i % SNAPSHOT_EVERY == 0:
                try:
                    rec["snapshot"] = region.store.snapshot(i, {"p": p})
                except PoolAccessError as e:   # past the retries
                    mon.record_pool_error(i)
                    rec["snapshot_error"] = str(e)
            rec["pulse"] = mon.pulse(ctx.rank, i)
            got = _gather(mon.pool_errors_step)
            mon.pool_errors_step = sum(got)
            rec["pool_errors"] = got
            rp = ctl.step(i, pulse=False)
            rec["verdicts"] = [[f.kind, f.rank, f.step]
                               for f in mon.failures if f.step == i]
            out["steps"].append(rec)
            if rp is not None:
                break
    region.close()
    if rp is None:
        raise RuntimeError("rank death never confirmed")
    out.update(
        launches=chunked_reduce.launches,
        launches_by_n=dict(chunked_reduce.launches_by_n),
        confirm_step=i, reason=rp.reason,
        topology=rp.topology.to_json(),
        plan=rp.plan.to_json(), p_confirm=p.cpu().numpy(),
        committed=[region.store.committed(r) for r in range(ctx.nranks)],
        common=region.store.common_latest(),
        steps_lost=ctl.steps_lost(FAULT_STEP, i,
                                  region.store.common_latest()))
    tuner_runtime.clear_rank_liveness()
    set_active_topology(None)
    return out


def _resume(ctx: ranks.RankContext, path: str, data: dict,
            survivor: dict, plan: dict) -> dict:
    """Spawn 2, on every survivor: restore from the pool store, then the
    ragged auto run under the recovery plan and the flat cxl run."""
    dev = ctx.device
    region = PoolRegion(path, NRANKS, ctx.rank, STORE_BYTES, dev)
    step = region.store.common_latest()
    restored, _ = region.store.restore(
        {"p": torch.zeros(ROWS, 4, device=dev)}, step=step)
    p0 = restored["p"]
    region.close()
    topo = Topology.from_json(survivor)
    shape = mesh_shape(ctx.nranks)
    set_active_topology(topo)
    tuner_runtime.set_active_plan(Plan.from_json(plan))
    ragged = Communicator(backend="auto", axes=make_host_mesh(
        shape, ctx, topology=topo))
    ledger.reset()
    chunked_reduce.launches, chunked_reduce.launches_by_n = 0, {}
    p = p0
    for x in data["resume"]:
        p = _step(ragged, p, _rows(x, ctx.rank, dev))
    snap = ledger.snapshot()
    launches = (chunked_reduce.launches,
                dict(chunked_reduce.launches_by_n))
    set_active_topology(None)
    tuner_runtime.clear_active_plan()
    flat = Communicator(backend="cxl", axes=make_host_mesh(shape, ctx))
    q = p0
    for x in data["resume"]:
        q = _step(flat, q, _rows(x, ctx.rank, dev))
    return {"restored_step": step, "p0": p0.cpu().numpy(),
            "launches": launches[0], "launches_by_n": launches[1],
            "ragged": p.cpu().numpy(), "flat": q.cpu().numpy(),
            "level_wire_bytes": snap["level_wire_bytes"],
            "audit": [{k: c[k] for k in ("primitive", "level", "nranks",
                                         "backend", "msg_bytes")}
                      for c in snap["auto_choices"]],
            "fallbacks": len(snap["fallbacks"])}


def run(device: str, seed: int = SEED) -> dict:
    """Both spawns on ``device``, the pool store a region this process
    makes and both spawns map.  Returns each rank's records and the
    wall seconds of each spawn."""
    data = inputs(seed)
    total = PoolRegion.total_bytes(NRANKS, STORE_BYTES)
    path, fd = create_backing(total)
    try:
        topo = parse_topology(TOPOLOGY)
        t0 = time.perf_counter()
        first = ranks.spawn(
            _until_confirmed, NRANKS, (path, data), device=device,
            partition_bytes=PARTITION_BYTES,
            groups=level_groups(mesh_shape(NRANKS), topo), timeout_s=120.0)
        t1 = time.perf_counter()
        survivor = first[0]["topology"]
        n = NRANKS - 1
        second = ranks.spawn(
            _resume, n, (path, data, survivor, first[0]["plan"]),
            device=device, partition_bytes=PARTITION_BYTES,
            groups=level_groups(mesh_shape(n),
                                Topology.from_json(survivor)),
            timeout_s=120.0)
        t2 = time.perf_counter()
    finally:
        os.close(fd)
    return {"inputs": data, "first": first, "second": second,
            "first_s": t1 - t0, "second_s": t2 - t1}


def check(res: dict) -> dict:
    """The reference's assertions, on every rank; returns the summary
    the launcher prints."""
    first, second = res["first"], res["second"]
    keys = ("confirm_step", "reason", "topology", "committed", "common",
            "steps_lost")
    for r in first[1:]:
        for k in keys:
            if r[k] != first[0][k]:
                raise AssertionError(f"ranks disagree on {k}: {r[k]} vs "
                                     f"{first[0][k]}")
    f0 = first[0]
    if any([s["verdicts"] for s in r["steps"]]
           != [s["verdicts"] for s in f0["steps"]] for r in first):
        raise AssertionError("ranks reached different verdicts")
    shape = Topology.from_json(f0["topology"]).level_for("data").shape
    if shape != (2, 1):
        raise AssertionError(f"survivor data level {shape}, wants (2, 1)")
    if f0["steps_lost"] > 8:
        raise AssertionError(f"{f0['steps_lost']} steps lost")
    for r in second:
        np.testing.assert_allclose(r["ragged"], r["flat"], rtol=1e-4,
                                   atol=1e-6)
        lvl = {k: sum(v.values()) for k, v in r["level_wire_bytes"].items()}
        if set(lvl) != {"data/cxl", "pod/cxl"} or \
                not lvl["pod/cxl"] < lvl["data/cxl"]:
            raise AssertionError(f"ledger bytes by level {lvl}")
        ns = {(a["level"], a["nranks"]) for a in r["audit"]}
        if not {("data", 2), ("pod", 2)} <= ns:
            raise AssertionError(f"auto audit cells {ns}")
        if r["restored_step"] != f0["common"]:
            raise AssertionError("restored another step than the common one")
    lvl = {k: sum(v.values())
           for k, v in second[0]["level_wire_bytes"].items()}
    return {"confirm_step": f0["confirm_step"], "reason": f0["reason"],
            "committed": f0["committed"], "restored_step": f0["common"],
            "steps_lost": f0["steps_lost"], "level_wire_bytes": lvl,
            "max_abs_diff": max(float(np.max(np.abs(r["ragged"] - r["flat"])))
                                for r in second),
            "chunked_reduce": {"first": [r["launches_by_n"] for r in first],
                               "ragged": [r["launches_by_n"]
                                          for r in second]},
            "first_s": res["first_s"], "second_s": res["second_s"]}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.core.device import resolve_device
    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    summary = check(run(resolve_device(args.device).type))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
