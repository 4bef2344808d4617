"""The simulator's transfer timeline as an ASCII Gantt chart: the
overlap structure of Fig. 7 - with one chunk the consumer idles until
the producer finishes; with the slicing factor the retrieve stream
starts as soon as chunk 0's doorbell rings.  Port of
``examples/timeline.py`` (framework-free).

Usage:
  PYTHONPATH=src python -m repro_torch.examples.timeline \\
      [--primitive broadcast] [--nranks 3] [--mib 64] [--chunks 1 4] \\
      --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import schedule as sched
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import MiB
from repro_torch.core.simulator import SimOptions, simulate
from repro_torch.examples import add_device, printer

WIDTH = 72


def gantt(primitive: str, nranks: int, size: int, factor: int,
          say=print) -> float:
    """Print one chart; returns the simulated total seconds."""
    s = sched.build(primitive, nranks, size, slicing_factor=factor)
    r = simulate(s, SimOptions(track_timeline=True))
    t_end = r.total_time
    say(f"\n== {primitive} {size // MiB} MiB x{nranks} ranks, "
        f"slicing={factor}: total {t_end * 1e3:.2f} ms ==")
    lanes: dict = {}
    for rank, kind, key, t0, t1 in r.timeline:
        lanes.setdefault((rank, kind), []).append((t0, t1, key))
    for (rank, kind) in sorted(lanes):
        row = [" "] * WIDTH
        for t0, t1, key in lanes[(rank, kind)]:
            a = int(t0 / t_end * (WIDTH - 1))
            b = max(a + 1, int(t1 / t_end * (WIDTH - 1)))
            ch = "W" if kind == "write" else "R"
            for i in range(a, min(b, WIDTH)):
                row[i] = ch if row[i] == " " else "#"
        say(f"rank{rank} {kind:5s} |{''.join(row)}|")
    return t_end


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--primitive", default="broadcast")
    ap.add_argument("--nranks", type=int, default=3)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--chunks", type=int, nargs="+", default=[1, 8])
    return add_device(ap)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    lines: list = []
    say = printer(lines)
    totals = {f: gantt(args.primitive, args.nranks, args.mib * MiB, f, say)
              for f in args.chunks}
    return {"lines": lines, "total_s": totals}


if __name__ == "__main__":
    main()
