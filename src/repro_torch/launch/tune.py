"""Offline autotuning CLI: sweep the cost model, persist a Plan.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.tune --out plan.json
  PYTHONPATH=src python -m repro_torch.launch.tune --smoke   # coarse, fast
  PYTHONPATH=src python -m repro_torch.launch.tune --nranks 4 \\
      --sizes-mib 1 4 16 64 256 --out plan.json
  PYTHONPATH=src python -m repro_torch.launch.tune \\
      --topology "pod:ib,node:cxl,gpu:ici" --out plan.json
  PYTHONPATH=src python -m repro_torch.launch.tune --nranks 4 \\
      --topology pod:cxl,node:cxl:3+1 --placement-report llama3.2-1b \\
      --placement-axes data=4,model=1 --out plan.json
  PYTHONPATH=src python -m repro_torch.launch.tune --nranks 2 \\
      --topology data:cxl,model:cxl --measurements refined.timings.json \\
      --out plan.json                                    # v4 fold

Port of ``repro.launch.tune``.  The sweep prices the fused cells'
epilogue with the H100 roofline, so a plan tuned here makes the
reference's choices with other ``predicted_time`` on fused cells; the
format and the fingerprint are the reference's, and plans cross between
the two packages.  Without ``--out`` the plan lands in this package's
plan cache (``repro_torch.tuner.default_plan_path``), where
``backend='auto'`` finds it.  Feed the saved path to
``repro_torch.launch.train --backend auto --plan ...`` or
``repro_torch.launch.serve --plan ...``.

``--placement-report ARCH`` ranks the mesh-axis -> level assignments of
the topology for ARCH's analytic collective mix (``tuner.placement``,
the roofline windows priced on the H100), prints the table and embeds it
in the plan's metadata (``Plan.placement()``); ``--placement-axes
data=4,model=1`` gives the logical axis degrees (default: the products
of the placeable levels' declared sizes).

``--measurements`` folds ledger timing records (a directory, glob or
file of JSON: a bare list of samples, or a record carrying them under
``timings`` or ``ledger.timings``, e.g. the ``<base>.timings.json`` that
``train --online-retune --plan-out`` writes) into the swept plan
(``tuner.fold_measurements``): a format-v4 plan whose measured cells
override the oracle.

``--overlap-from-dryrun`` (a directory, glob or file of dry-run
records, of either package's ``launch.dryrun``) derives the overlap
window of each primitive from the records' roofline compute and ledger
(``tuner.overlap_windows_from_dryrun``), in place of the constant
``--overlap-compute-us``.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import time
from typing import Optional, Sequence

from repro_torch import tuner
from repro_torch.core.hw import MiB
from repro_torch.core.schedule import PRIMITIVES
from repro_torch.core.topology import parse_topology

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="plan JSON path (default: the plan cache)")
    ap.add_argument("--smoke", action="store_true",
                    help="coarse grid (seconds instead of minutes)")
    ap.add_argument("--primitives", nargs="+", choices=PRIMITIVES,
                    default=None)
    ap.add_argument("--sizes-mib", type=int, nargs="+", default=None)
    ap.add_argument("--nranks", type=int, nargs="+", default=None)
    ap.add_argument("--factors", type=int, nargs="+", default=None)
    ap.add_argument("--topology", default=None,
                    help="'axis:fabric,...' spec (outermost first; "
                         "fabrics: cxl|ib|ici) or a topology JSON file; "
                         "tunes each level against its own fabric")
    ap.add_argument("--overlap-compute-us", type=float, default=0.0,
                    help="overlappable compute window per collective "
                         "(microseconds); > 0 tunes by exposed time "
                         "max(0, comm - window) and marks cells "
                         "overlap=True")
    ap.add_argument("--kv-block-bytes", type=int, nargs="+",
                    default=None, metavar="BYTES",
                    help="also tune kv_block cache-placement cells "
                         "(serving eviction: pool round-trip vs prefill "
                         "recompute) at these KV-image sizes; requires "
                         "--kv-arch")
    ap.add_argument("--kv-arch", default=None, metavar="ARCH",
                    help="architecture whose cache footprint and active "
                         "parameter count price the kv_block recompute "
                         "arm")
    ap.add_argument("--placement-report", default=None, metavar="ARCH",
                    help="rank mesh-axis -> fabric-level placements of "
                         "--topology for ARCH's analytic collective mix "
                         "(tuner.placement), print the table and embed it "
                         "in the plan's metadata (Plan.placement())")
    ap.add_argument("--placement-axes", default=None,
                    help="logical axis degrees for --placement-report, "
                         "'name=size,...' (default: data = the product of "
                         "the placeable levels' sizes but the innermost, "
                         "model = the innermost's)")
    ap.add_argument("--measurements", default=None,
                    help="directory/glob/file of ledger timing records "
                         "(snapshot()['timings'], e.g. a train run's "
                         "--plan-out sidecar <base>.timings.json); folds "
                         "the measured per-cell wall times into the swept "
                         "plan (tuner.online), emitting a format-v4 plan "
                         "whose measured cells override the oracle")
    ap.add_argument("--overlap-from-dryrun", default=None,
                    help="directory/glob/file of dry-run JSON records: "
                         "derive per-primitive overlap windows from "
                         "their roofline compute and ledger "
                         "(tuner.overlap_windows_from_dryrun) instead of "
                         "the constant --overlap-compute-us")
    ap.add_argument("--quiet", action="store_true")
    return ap


def load_records(path: str) -> list:
    """JSON records from a directory (its ``*.json``), a glob or a file;
    unreadable files are skipped, as by the reference's loader."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.json")))
    elif any(c in path for c in "*?["):
        files = sorted(glob.glob(path))
    else:
        files = [path]
    records = []
    for f in files:
        try:
            with open(f) as fh:
                records.append(json.load(fh))
        except (OSError, ValueError):
            continue
    return records


def load_timings(path: str) -> list:
    """The timing samples of ``--measurements``: a record may be a bare
    list of samples or carry them under ``timings`` (top-level or under
    ``ledger``)."""
    timings = []
    for rec in load_records(path):
        if isinstance(rec, list):
            timings.extend(rec)
        elif isinstance(rec, dict):
            timings.extend(rec.get("timings")
                           or (rec.get("ledger") or {}).get("timings")
                           or [])
    return timings


def kv_block_cells(plan: tuner.Plan, arch: str, sizes: Sequence[int], *,
                   smoke: bool) -> collections.Counter:
    """Add ``kv_block`` cells to ``plan`` for the KV images of ``sizes``
    bytes of ``arch``'s cache, priced by ``kvcache.price_kv_block``;
    returns the count of each backend picked."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.pcontext import UNSHARDED
    from repro_torch.serving import kvcache
    kcfg = get_config(arch, smoke=smoke)
    layout = kvcache.CacheLayout(kcfg, UNSHARDED, 1, 128, torch.float32)
    per_tok = max(1, layout.bytes_for(64) // 64)
    picks: collections.Counter = collections.Counter()
    for nbytes in sizes:
        ntok = max(1, nbytes // per_tok)
        choice = kvcache.price_kv_block(
            nbytes, 2.0 * kcfg.active_param_count() * ntok)
        plan.add("kv_block", nbytes, 1, choice)
        picks[choice.backend] += 1
    return picks


def parse_axes(spec: str) -> dict:
    """``"data=4,model=1"`` -> ``{"data": 4, "model": 1}``."""
    return {k: int(v) for k, v in (p.split("=") for p in spec.split(","))}


def placement_axes(topology) -> dict:
    """The reference's default degrees for ``--placement-report``: data =
    the product of the placeable levels' sizes but the innermost, model
    = the innermost's (None when a level's size is undeclared)."""
    lvs = topology.levels
    sizes = [lv.size for i, lv in enumerate(lvs)
             if not (i + 1 < len(lvs) and lvs[i + 1].grouped)]
    if any(s is None for s in sizes):
        return None
    data = 1
    for s in sizes[:-1]:
        data *= s
    return {"data": data, "model": sizes[-1]}


def main(argv: Optional[Sequence[str]] = None) -> tuner.Plan:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.kv_block_bytes and not args.kv_arch:
        ap.error("--kv-block-bytes requires --kv-arch")

    base = tuner.SMOKE_GRID if args.smoke else tuner.DEFAULT_GRID
    grid = tuner.TuneGrid(
        primitives=tuple(args.primitives) if args.primitives
        else base.primitives,
        sizes=tuple(m * MiB for m in args.sizes_mib) if args.sizes_mib
        else base.sizes,
        nranks=tuple(args.nranks) if args.nranks else base.nranks,
        slicing_factors=tuple(args.factors) if args.factors
        else base.slicing_factors)
    topology = parse_topology(args.topology) if args.topology else None

    overlap = args.overlap_compute_us * 1e-6
    if args.overlap_from_dryrun:
        if args.overlap_compute_us:
            ap.error("--overlap-from-dryrun and --overlap-compute-us "
                     "are mutually exclusive")
        records = load_records(args.overlap_from_dryrun)
        overlap = tuner.overlap_windows_from_dryrun(records)
        got = {p: f"{w * 1e6:.1f}us"
               for p, w in overlap.per_primitive.items()}
        print(f"overlap windows from {len(records)} dry-run records: "
              f"{got}")

    progress = None if args.quiet else (lambda msg: print(f"  {msg}"))
    t0 = time.time()
    plan = tuner.generate_plan(grid, topology=topology,
                               overlap_compute=overlap, progress=progress)
    if args.measurements:
        timings = load_timings(args.measurements)
        plan = tuner.fold_measurements(plan, timings)
        measured = sum(c.sample_count > 0 for c in plan.entries.values())
        print(f"folded {len(timings)} measured samples into {measured} "
              f"cells")
    if args.kv_block_bytes:
        picks = kv_block_cells(plan, args.kv_arch, args.kv_block_bytes,
                               smoke=args.smoke)
        print(f"  kv_block ({args.kv_arch}): {dict(picks)} over "
              f"{len(args.kv_block_bytes)} sizes")
    if args.placement_report:
        if topology is None:
            ap.error("--placement-report requires --topology")
        from repro_torch.configs import get_config
        axes = parse_axes(args.placement_axes) if args.placement_axes \
            else placement_axes(topology)
        if axes is None:
            ap.error("--placement-report needs --placement-axes when "
                     "topology level sizes are undeclared")
        mix = tuner.CollectiveMix.for_model(
            get_config(args.placement_report), axes)
        pplan = tuner.plan_placement(mix, topology)
        print(tuner.format_report(pplan))
        plan.meta["placement"] = pplan.to_json()
    dt = time.time() - t0

    out = args.out or tuner.default_plan_path(topology=topology)
    tuner.save_plan(plan, out)

    by_backend = collections.Counter(
        c.backend for c in plan.entries.values())
    gains = [c.baseline_time / c.predicted_time
             for c in plan.entries.values() if c.predicted_time > 0]
    print(f"tuned {len(plan.entries)} cells in {dt:.1f}s -> {out}")
    print(f"  fingerprint {plan.fingerprint}")
    print(f"  choices: {dict(by_backend)}")
    if topology is not None:
        for lv in topology.levels:
            lkey = topology.level_key(lv.axis)
            mix = collections.Counter(
                c.backend for k, c in plan.entries.items()
                if len(k) == 4 and k[3] == lkey)
            print(f"  level {lv.axis} ({lv.fabric}, "
                  f"{lv.fingerprint()}): {dict(mix)}")
    if gains:
        print(f"  predicted gain vs best fixed knobs: "
              f"mean {sum(gains) / len(gains):.3f}x, "
              f"max {max(gains):.3f}x")
    return plan


if __name__ == "__main__":
    main()
