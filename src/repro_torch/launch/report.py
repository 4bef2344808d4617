"""Step-time breakdown report from an observability metrics stream.

Reads the JSON-lines file written by ``--metrics-out`` (train / serve,
see ``repro_torch.obs.session``; the reference's files read the same)
and prints a human summary: step
wall-time statistics, where measured collective time went (by
primitive/backend and by (level, fabric) link), retune/hot-swap
activity, and any link-health transitions.  Optionally cross-checks a
flight-recorder trace (``--trace``) for its retained steps and
anomalies.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report run.jsonl \
      [--trace run.trace.json] [--top 8]

Framework-free copy of ``repro.launch.report``: the same text for the
same events.
"""
from __future__ import annotations

import argparse
import json


def load_events(path: str) -> list:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))
    return sorted_vals[i]


def summarize(events: list, top: int = 8) -> str:
    steps = [e for e in events if e.get("kind") == "step"]
    retunes = [e for e in events if e.get("kind") == "retune"]
    health = [e for e in events if e.get("kind") == "health"]
    diags = [e for e in events if e.get("kind") == "diag"]
    metrics = [e for e in events if e.get("kind") == "metric"]
    summary = next((e for e in events if e.get("kind") == "summary"),
                   {})
    out = []
    walls = sorted(e["wall_s"] for e in steps)
    if steps:
        # the first step usually includes compilation; report it apart
        cached = sorted(e["wall_s"] for e in steps[1:]) or walls
        out.append(f"steps: {len(steps)}  "
                   f"wall p50 {_pct(cached, 0.5):.4f}s  "
                   f"p90 {_pct(cached, 0.9):.4f}s  "
                   f"max {cached[-1]:.4f}s  "
                   f"(first step {steps[0]['wall_s']:.2f}s, "
                   f"incl. compile)")
        samples = sum(e.get("timing_samples", 0) for e in steps)
        out.append(f"measured collective samples: {samples}")

    # measured collective seconds by (primitive, backend, level), from
    # the histogram _sum samples of the final registry dump
    coll = [(m["labels"], m["value"]) for m in metrics
            if m["name"] == "repro_collective_seconds_sum"]
    if coll:
        coll.sort(key=lambda kv: -kv[1])
        total = sum(v for _, v in coll) or 1.0
        out.append("collective time by cell "
                   "(primitive@backend [level]):")
        for lab, v in coll[:top]:
            out.append(f"  {lab.get('primitive')}@{lab.get('backend')}"
                       f" [{lab.get('level')}]  {v:.6f}s "
                       f"({100.0 * v / total:.1f}%)")
        if len(coll) > top:
            out.append(f"  ... {len(coll) - top} more cells")

    busy = [(m["labels"], m["value"]) for m in metrics
            if m["name"] == "repro_level_busy_seconds_total"]
    if busy:
        out.append("busy seconds by link (level/fabric):")
        for lab, v in sorted(busy, key=lambda kv: -kv[1]):
            out.append(f"  {lab.get('level')}/{lab.get('fabric')}  "
                       f"{v:.6f}s")

    if retunes:
        swaps = sum(1 for e in retunes if e.get("swapped"))
        last = retunes[-1]
        out.append(f"retunes: {len(retunes)} boundaries, {swaps} hot "
                   f"swaps, final epoch {last.get('epoch')}, "
                   f"measured regret "
                   f"{last.get('regret_s', 0.0):.6f}s")
    for e in health:
        out.append(f"health: link {e.get('link')} {e.get('event')} at "
                   f"step {e.get('step')} "
                   f"(slowdown {e.get('slowdown')}x)")
    if diags:
        out.append(f"diagnostics: {len(diags)}")
        for e in diags[:top]:
            out.append(f"  [{e.get('source')}] {e.get('msg')}")
        if len(diags) > top:
            out.append(f"  ... {len(diags) - top} more")
    degraded = summary.get("degraded_links")
    out.append(f"degraded links at exit: {degraded or 'none'}")

    # serving-trace summary (serve --trace poisson writes these into
    # the final summary event and exports repro_serve_* gauges)
    if "req_per_s" in summary:
        out.append(f"serving: {summary['req_per_s']:.2f} req/s over "
                   f"{summary.get('requests')} requests  "
                   f"latency p50 "
                   f"{summary.get('latency_p50_s', 0.0):.3f}s  "
                   f"p99 {summary.get('latency_p99_s', 0.0):.3f}s")
    serve = sorted((m["name"], m["value"]) for m in metrics
                   if m["name"].startswith("repro_serve_"))
    if serve:
        out.append("serving counters at exit:")
        for name, v in serve:
            out.append(f"  {name[len('repro_serve_'):]}  {v:g}")

    wire = {tuple(sorted(m["labels"].items())): m["value"]
            for m in metrics if m["name"] == "repro_wire_bytes"}
    if wire:
        total = sum(wire.values())
        out.append(f"trace-time wire bytes/step: {total:.3e} "
                   f"({len(wire)} collective kinds)")
    return "\n".join(out)


def summarize_trace(path: str) -> str:
    with open(path) as f:
        doc = json.load(f)
    meta = doc.get("metadata", {})
    n_coll = sum(1 for e in doc.get("traceEvents", [])
                 if e.get("cat") == "collective")
    lines = [f"flight recorder: steps retained "
             f"{meta.get('steps_retained')}, {n_coll} collective "
             f"slices"]
    for a in meta.get("anomalies", []):
        lines.append(f"  anomaly @ {a['ts']:.3f}s: {a['reason']}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.report")
    ap.add_argument("metrics", help="JSON-lines file from --metrics-out")
    ap.add_argument("--trace", default=None,
                    help="flight-recorder JSON from --trace-out")
    ap.add_argument("--top", type=int, default=8,
                    help="cells to list in the collective breakdown")
    args = ap.parse_args(argv)
    print(summarize(load_events(args.metrics), top=args.top))
    if args.trace:
        print(summarize_trace(args.trace))


if __name__ == "__main__":
    main()
