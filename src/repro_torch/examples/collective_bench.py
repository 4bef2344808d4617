"""Interactive collective explorer: sweep any primitive across message
sizes, node counts, slicing factors and implementation variants - the
tool behind the Sec. 5.4-style sensitivity studies.  Port of
``examples/collective_bench.py`` (framework-free: the simulator and the
InfiniBand model).

Usage:
  PYTHONPATH=src python -m repro_torch.examples.collective_bench \\
      --primitive all_to_all --nodes 3 6 12 --sizes 64 256 1024 \\
      --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import ibmodel, simulator
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import MiB
from repro_torch.core.schedule import PRIMITIVES
from repro_torch.examples import add_device, printer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--primitive", choices=PRIMITIVES,
                    default="all_gather")
    ap.add_argument("--nodes", type=int, nargs="+", default=[3])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[16, 256, 1024], help="MiB")
    ap.add_argument("--slicing", type=int, default=4)
    return add_device(ap)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    lines: list = []
    say = printer(lines)
    rows = []
    say(f"{'nodes':>5} {'size':>7} {'all':>10} {'aggregate':>10} "
        f"{'naive':>10} {'IB-200':>10} {'speedup':>8}")
    for n in args.nodes:
        for mb in args.sizes:
            size = mb * MiB
            r = {v: simulator.run_variant(
                v, args.primitive, n, size,
                slicing_factor=args.slicing).total_time
                for v in ("all", "aggregate", "naive")}
            ib = ibmodel.estimate(args.primitive, n, size).time
            rows.append({"nodes": n, "mib": mb, **r, "ib": ib})
            say(f"{n:>5} {mb:>5}MB "
                f"{r['all'] * 1e3:>8.2f}ms {r['aggregate'] * 1e3:>8.2f}ms "
                f"{r['naive'] * 1e3:>8.2f}ms {ib * 1e3:>8.2f}ms "
                f"{ib / r['all']:>7.2f}x")
    return {"lines": lines, "rows": rows}


if __name__ == "__main__":
    main()
