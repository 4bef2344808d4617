"""The tune -> train/serve workflow on one machine.  Port of
``examples/autotune_workflow.py``.

1. Sweep the offline cost model into a persisted Plan (what
   ``python -m repro_torch.launch.tune`` does).
2. Inspect a few of the plan's decisions.
3. Train with ``backend='auto'``: every collective in the step resolves
   against the plan at its call, and the ledger audits each choice.  The
   step runs in this process on a 1-rank (data, model) mesh, as the
   reference's on ``jax.make_mesh((1, 1), ("data", "model"))``.

Usage:
  PYTHONPATH=src python -m repro_torch.examples.autotune_workflow \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch import tuner
from repro_torch.configs import get_config
from repro_torch.core import ledger
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import MiB
from repro_torch.core.mesh_collectives import AxisGroup
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.examples import add_device, printer
from repro_torch.models import model, sharding
from repro_torch.optim import adamw_init
from repro_torch.training.train_loop import (TrainConfig, batch_to_device,
                                             leaf_params,
                                             make_sharded_train_step)

ARCH = "llama3.2-1b"                 # at smoke size
LOOKUPS = tuple((prim, size) for prim in ("all_gather", "all_reduce",
                                          "broadcast")
                for size in (1 * MiB, 256 * MiB))


def tune(say=print) -> tuple:
    """Parts 1 and 2: the smoke grid's plan, saved; the six lookups at
    3 ranks.  Returns (plan, its path, the lookups' choices)."""
    plan = tuner.generate_plan(tuner.SMOKE_GRID)
    path = os.path.join(tempfile.mkdtemp(), "plan.json")
    tuner.save_plan(plan, path)
    say(f"tuned {len(plan.entries)} cells -> {path} "
        f"(fingerprint {plan.fingerprint})")
    looked = []
    for prim, size in LOOKUPS:
        c = plan.lookup(prim, size, 3)
        looked.append(c)
        say(f"  {prim:12s} {size // MiB:>4d}MiB @3 ranks -> "
            f"{c.backend:4s} factor={c.slicing_factor} "
            f"({c.predicted_time * 1e3:.2f}ms, best fixed "
            f"{c.baseline_time * 1e3:.2f}ms)")
    return plan, path, looked


def auto_step(params, plan_path: str, device) -> tuple:
    """Part 3's step: one ``backend='auto'`` step of ``params`` (the
    smoke model's GLOBAL params on ``device``, not updated) on a 1-rank
    (data, model) mesh, batch 2 x 16 from ``SyntheticTokens``' seed 0.
    Returns (loss, the ledger's ``auto_choices``)."""
    dev = resolve_device(device)
    cfg = get_config(ARCH, smoke=True)
    tcfg = TrainConfig(backend="auto", plan_path=plan_path, clip_norm=None,
                       total_steps=2, warmup=0)
    mesh = {name: AxisGroup(name, 0, 1) for name in ("data", "model")}
    ledger.reset()
    step, pspecs, pc = make_sharded_train_step(cfg, tcfg, mesh)
    local = leaf_params(sharding.shard_params(params, pspecs, pc.dp_axis,
                                              0, 1))
    batch = batch_to_device(next(iter(SyntheticTokens(cfg, batch=2,
                                                      seq=16))), dev)
    _, _, metrics = step(local, adamw_init(local), batch)
    return float(metrics["loss"]), ledger.snapshot()["auto_choices"]


def build_parser() -> argparse.ArgumentParser:
    return add_device(argparse.ArgumentParser())


def run(params, device, say=print) -> dict:
    """The three parts on ``params`` (the smoke model's GLOBAL params at
    tp 1 on ``device``)."""
    plan, path, looked = tune(say)
    loss, audit = auto_step(params, path, device)
    say(f"auto-backend step ok, loss {loss:.4f}")
    say(f"ledger audited {len(audit)} auto decisions, e.g.:")
    for a in audit[:4]:
        say(f"  {a['primitive']:14s} {a['msg_bytes']:>9d}B "
            f"n={a['nranks']} -> {a['backend']}")
    return {"plan": plan, "plan_path": path, "lookups": looked,
            "loss": loss, "auto_choices": audit}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(ARCH, smoke=True)
    params = model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lines: list = []
    return {"lines": lines, **run(params, dev, printer(lines))}


if __name__ == "__main__":
    main()
