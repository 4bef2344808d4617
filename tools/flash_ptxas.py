#!/usr/bin/env python3
"""``ptxas -v`` report of the FlashAttention kernel's instantiations.

Compiles ``src/repro_torch/kernels/csrc/flash_attention.cu`` with the
port's nvcc flags and ``-Xptxas -v`` and prints, per instantiation
(dtype, head_dim), its registers a thread and its spill stores and
loads, as one JSON object; exits 1 when any instantiation spills.  Run
from the root of a checkout, on a machine with the CUDA toolkit:

    python3 tools/flash_ptxas.py
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402


def report(source: str = "flash_attention") -> dict:
    """kernel name -> {registers, spill_stores, spill_loads}."""
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", "-o",
             str(pathlib.Path(tmp) / f"{source}.o"),
             str(build.CSRC / f"{source}.cu")],
            capture_output=True, text=True, check=True)
    out: dict = {}
    name = None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)],
                                  capture_output=True,
                                  text=True).stdout.strip() or m.group(1)
            name = re.sub(r"\(.*", "", name.replace(
                "(anonymous namespace)::", "")).replace("void ", "")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def main() -> int:
    rep = report()
    print(json.dumps(rep, indent=1))
    spills = [k for k, v in rep.items()
              if v.get("spill_stores", 0) or v.get("spill_loads", 0)]
    return 1 if spills or not rep else 0


if __name__ == "__main__":
    sys.exit(main())
