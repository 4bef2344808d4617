"""Hierarchical-topology workflow: define a multi-fabric cluster, tune
a per-level plan, and watch the Communicator decompose collectives
against it - all offline.  Port of ``examples/topology_workflow.py``:
the reference traces its AllReduce with ``jax.eval_shape`` over an
``AbstractMesh``; here rank 0 of the (2, 2, 2) mesh runs it on meta
tensors over ``launch.mesh.make_meta_mesh`` (no process group, no pool,
nothing moves), which books the same ledger.

Run:
  PYTHONPATH=src python -m repro_torch.examples.topology_workflow \\
      --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch import tuner
from repro_torch.core import ledger
from repro_torch.core.api import Communicator
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import MiB, CXLPoolConfig, InfiniBandConfig
from repro_torch.core.topology import Level, Topology
from repro_torch.examples import add_device, printer
from repro_torch.launch.mesh import make_meta_mesh

MESH = (("pod", 2), ("node", 2), ("gpu", 2))
ALLREDUCE_BYTES = 16 * MiB          # the global array; 1/8 a rank


def topology() -> Topology:
    """2 pods x 2 nodes x 2 gpus: IB across pods, a rack-scale CXL pool
    within a pod, the chip ring within a node."""
    return Topology(levels=(
        Level("pod", "ib", ib=InfiniBandConfig(link_bw=12.5e9)),
        Level("node", "cxl", pool=CXLPoolConfig(device_bw=18e9)),
        Level("gpu", "ici"),
    ))


def traced_allreduce(plan, topo: Topology) -> dict:
    """The hierarchical 16 MiB AllReduce over (pod, node, gpu) under
    ``auto`` on ``plan``, traced by rank 0 on the meta device; returns
    the ledger's snapshot."""
    axes = tuple(name for name, _ in MESH)
    n = math.prod(size for _, size in MESH)
    comm = Communicator(backend="auto", plan=plan,
                        axes=make_meta_mesh(MESH, topology=topo))
    ledger.reset()
    comm.all_reduce(torch.empty((ALLREDUCE_BYTES // 4 // n, 1),
                                device="meta"), axes)
    return ledger.snapshot()


def build_parser() -> argparse.ArgumentParser:
    return add_device(argparse.ArgumentParser())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    lines: list = []
    say = printer(lines)
    topo = topology()
    say(f"topology fingerprint: {topo.fingerprint()}")

    # offline: tune every level against its own fabric oracle
    grid = tuner.TuneGrid(sizes=tuple(m * MiB for m in (1, 16, 64)),
                          nranks=(2,), slicing_factors=(1, 4))
    plan = tuner.generate_plan(grid, topology=topo)
    path = os.path.join(tempfile.mkdtemp(), "plan.json")
    tuner.save_plan(plan, path)
    say(f"tuned {len(plan.entries)} level-keyed cells -> {path}")

    # online: one flag's worth of setup - the plan carries the topology
    plan = tuner.load_plan(path, topology=topo)
    snap = traced_allreduce(plan, topo)
    level_bytes = {k: sum(v.values())
                   for k, v in snap["level_wire_bytes"].items()}
    say("per-level wire bytes (hierarchical AllReduce, 16 MiB):")
    say(json.dumps(level_bytes, indent=1))
    say("per-level choices:")
    for ch in snap["auto_choices"]:
        say(f"  {ch['primitive']:<15} level={ch['level']:<5} "
            f"fabric={ch['fabric']:<4} -> {ch['backend']}")
    return {"lines": lines, "plan_path": path, "plan_entries":
            len(plan.entries), "level_wire_bytes": level_bytes,
            "auto_choices": snap["auto_choices"]}


if __name__ == "__main__":
    main()
