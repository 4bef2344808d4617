#!/usr/bin/env python3
"""Profile one training step of the port on one NVIDIA GPU, for each of
several launcher flag sets, and print where each rank's device time
goes.

Run from the root of a checkout, on a machine with a card::

    python3 tools/train_profile.py --out train_profile.json

Each run is Llama-3.2-1B at full width and depth on 4 ranks sharing the
card (``chip_smoke._train_args``: ``--batch 4 --seq 1024``, ``--lr
3e-5``), 2 steps and then one step under ``torch.profiler`` on every
rank (``launch.train.RunSpec(profile=True)``), summed over the ranks by
``chip_smoke._summarise_profile``: the profiled step's wall time,
device time in kernels, in host-to-device and device-to-host copies and
in the largest GEMMs, and the largest kernels and copies by name.  The
runs, by label: flat ``cxl`` (``--mesh 4x1``); over ``("pod",
"data")`` = (2, 2) with ``--topology pod:cxl,data:ici``, ``hier_cxl``
and ``hier_cxl_fused``; over ``("data", "model")`` = (2, 2) with
``--mesh 2x2 --topology data:cxl,model:cxl``, ``tp_cxl`` and
``tp_cxl_fused``; over the grouped data axis of ``--topology
pod:cxl,data:cxl:3+1`` (a node of three beside a lone node),
``ragged_cxl`` and ``ragged_cxl_fused`` (``--runs`` picks some).  Prints one JSON object and
writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)

HIER = ["--multi-pod", "--topology", chip_smoke.HIER_TOPOLOGY]
TP = ["--topology", chip_smoke.TP_TOPOLOGY]
RAGGED = ["--topology", chip_smoke.RAGGED_TOPOLOGY]
RUNS = {"cxl": ["--backend", "cxl"],
        "hier_cxl": HIER + ["--backend", "cxl"],
        "hier_cxl_fused": HIER + ["--backend", "cxl", "--fuse-kernels"],
        "tp_cxl": TP + ["--backend", "cxl"],
        "tp_cxl_fused": TP + ["--backend", "cxl", "--fuse-kernels"],
        "ragged_cxl": RAGGED + ["--backend", "cxl"],
        "ragged_cxl_fused": RAGGED + ["--backend", "cxl", "--fuse-kernels"]}
MESH = {"tp_cxl": chip_smoke.TP_MESH, "tp_cxl_fused": chip_smoke.TP_MESH}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", nargs="+", choices=sorted(RUNS),
                    default=list(RUNS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from repro_torch.launch import train
    out = {}
    for label in args.runs:
        spec = train.spec_from_args(train.build_parser().parse_args(
            chip_smoke._train_args(
                RUNS[label] + ["--lr", "3e-5", "--steps", "2"],
                MESH.get(label, f"{chip_smoke.DP}x1"))))
        run = train.run_ranks(dataclasses.replace(spec, profile=True))[0]
        out[label] = {"step_s": [s["step_s"] for s in run["steps"]],
                      "profile": chip_smoke._summarise_profile(
                          run["profile"])}
        print(label, json.dumps(out[label]), flush=True)
    text = json.dumps(out, indent=1)
    if args.out:
        pathlib.Path(args.out).write_text(text)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
