#!/usr/bin/env python3
"""``ssm_scan``'s backward kernel on one NVIDIA GPU: an earlier checkout's
(per channel only) against this checkout's, per channel and per head, in
turns, beside a copy of the same bytes and the kernels' ``ptxas``
registers and spills.

Run from the root of a checkout, on a machine with a card::

    python3 tools/ssm_bwd_ab.py --old OLD/src/repro_torch/kernels/csrc/ssm_scan.cu

``OLD`` is an earlier checkout (``git archive`` of a parent commit,
unpacked into a directory that ``.gitignore`` lists) whose ``ssm_scan.cu``
exports the PR 23 C entry ``ssm_scan_backward_launch(x, dt, A, B, C, D,
hc, dy, dh_last, dx, ddt, part_bc, part_a, part_d, dh0, dbc, dA, dD,
batch, L, D, N, k, stream)``; it is built here with the flags of
``repro_torch.kernels.build``.  At each shape the forward (this
checkout's, unchanged) writes the checkpoints once; then the old
backward and this checkout's are timed old, new, new, old with
``chip_smoke.Timer`` (L2 flushed before every call): at Falcon-Mamba's
(1, 1024, 8192, 16) per channel, and at Zamba2's (1, 1024, 4096, 64) and
(1, 4096, 1024, 64) per head (the old kernel per channel on the heads'
values repeated, as the model called it).  Each new result is checked
against the old one (per head: the per-channel grads summed over each
head).  Also: ``copy_ms``, a copy of the bytes the function must move;
each new backward's device kernels and their device time under
``torch.profiler``; ``ptxas -v``'s registers and spills per kernel of
this checkout's source; how many clusters of the backward the card holds
at once.  Prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

# (b, l, d, n, headdim or None)
SHAPES = ((1, 1024, 8192, 16, None), (1, 1024, 4096, 64, 64),
          (1, 4096, 1024, 64, 64), (1, 1024, 4096, 64, None))
OLD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + \
    [ctypes.c_void_p]


def build_old(src: pathlib.Path):
    """The old backward's ``ssm_scan_backward_launch``, built from
    ``src``."""
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libssm_scan-old-{key}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    fn = ctypes.CDLL(str(out)).ssm_scan_backward_launch
    fn.restype, fn.argtypes = ctypes.c_int, OLD_ARGTYPES
    return fn


def ptxas_report() -> dict:
    """Registers, spill stores and spill loads of each kernel of this
    checkout's ``ssm_scan.cu`` by ``nvcc -Xptxas -v``, and its build
    seconds."""
    import time
    t0 = time.perf_counter()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared",)]
    res = subprocess.run(
        [build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", "-o",
         str(build.BUILD_DIR / "ssm_scan_ptxas.o"),
         str(build.CSRC / "ssm_scan.cu")],
        capture_output=True, text=True, check=True)
    out, name = {}, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)],
                                  capture_output=True,
                                  text=True).stdout.strip()
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
    return {"seconds": time.perf_counter() - t0, "kernels": out}


def active_clusters(n: int, head: bool, cl: int, hs: int) -> int:
    fn = build.entry("ssm_scan", "ssm_scan_backward_clusters",
                     [ctypes.c_int] * 4 + [ctypes.c_void_p])
    got = ctypes.c_int(0)
    build.check("ssm_scan", fn(n, int(head), cl, hs, ctypes.addressof(got)))
    return got.value


def device_kernels(fn) -> dict:
    """Device time (us) by kernel name of one call of ``fn``, and the
    number of kernels it launched, by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return {"count": sum(e.count for e in kern),
            "us": {e.key[:60]: e.self_device_time_total for e in kern}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=pathlib.Path, required=True)
    ap.add_argument("--out", type=pathlib.Path,
                    default=chip_smoke.OUT_DIR / "ssm_bwd_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    old = build_old(args.old)
    rec = {"device": torch.cuda.get_device_name(0),
           "ptxas": ptxas_report(), "shapes": {}}
    timer = chip_smoke.Timer()
    gen = torch.Generator(device=dev).manual_seed(1234)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for b, l, d, n, hd in SHAPES:
        nh = d // hd if hd else d
        x, dy = randn(b, l, d), randn(b, l, d)
        bs, cs = randn(b, l, n), randn(b, l, n)
        if hd:
            dt, a, dres = randn(b, l, nh).abs() * 0.1, -randn(nh).abs(), \
                randn(nh)
            dt_ch, a_ch, d_ch = ss._expand_heads(dt, a, dres, hd, n)
        else:
            dt_ch, a_ch, d_ch = randn(b, l, d).abs() * 0.1, \
                -randn(d, n).abs(), randn(d)
            dt, a, dres = dt_ch, a_ch, d_ch
        _, _, hc = ss._launch(x, dt_ch, a_ch, bs, cs, d_ch, None, True,
                              ss.ssm_geometry(b, l, d, n, sms),
                              checkpoints=True)
        geo = ss.ssm_bwd_geometry(b, l, d, n, hd, sms)
        f32 = dict(dtype=torch.float32, device=dev)
        nblk = -(-d // 32)
        ob = {"dx": torch.empty_like(x), "ddt": torch.empty_like(x),
              "part_bc": torch.empty((b, nblk, l, 2 * n), **f32),
              "part_a": torch.empty((b, d, n), **f32),
              "part_d": torch.empty((b, d), **f32),
              "dbc": torch.empty((b, l, 2 * n), **f32),
              "dA": torch.empty((d, n), **f32), "dD": torch.empty(d, **f32)}
        stream = torch.cuda.current_stream().cuda_stream

        def run_old():
            build.check("ssm_scan", old(*(
                t.data_ptr() if t is not None else None for t in (
                    x, dt_ch, a_ch, bs, cs, d_ch, hc, dy, None, ob["dx"],
                    ob["ddt"], ob["part_bc"], ob["part_a"], ob["part_d"],
                    None, ob["dbc"], ob["dA"], ob["dD"])),
                b, l, d, n, 4 if n >= 4 else n, stream))

        def run_new():
            return ss._backward_launch(x, dt, a, bs, cs, dres, hc, dy, None,
                                       False, geo, hd)

        run_old()
        got = run_new()
        torch.cuda.synchronize()
        want = [ob["dx"], ob["ddt"], ob["dA"], ob["dbc"][..., :n],
                ob["dbc"][..., n:], ob["dD"]]
        if hd:     # the per-channel grads summed over each head
            want[1] = want[1].reshape(b, l, nh, hd).sum(-1)
            want[2] = want[2].sum(-1).reshape(nh, hd).sum(-1)
            want[5] = want[5].reshape(nh, hd).sum(-1)
        rel = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(got[:6], want)]
        turns = {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            turns[side].append(timer(run_old if side == "old" else run_new))
        ck = b * ss.checkpoint_count(l) * d * n
        cost = chip_smoke.ssm_bwd_cost(b, l, d, n, False,
                                       ss.checkpoint_count(l), headdim=hd)
        src = torch.empty(cost["bytes"] // 8, **f32)
        dst = torch.empty_like(src)
        rec["shapes"][f"{b}x{l}x{d}x{n}" + (f"/heads{hd}" if hd else "")] = {
            "old_ms": turns["old"], "new_ms": turns["new"],
            "copy_ms": timer(lambda: dst.copy_(src)),
            "max_rel_err_vs_old": dict(zip(
                ("dx", "ddt", "dA", "dB", "dC", "dD"), rel)),
            "new_kernels": device_kernels(run_new),
            "old_kernels": device_kernels(run_old), "geometry": geo,
            "active_clusters": active_clusters(n, bool(hd), geo["cluster"],
                                               max(geo["head_slots"], 1)),
            "checkpoint_floats": ck, **cost,
            "bound_ms": max(cost["bytes"] / chip_smoke.HBM_BW,
                            cost["flops"] / chip_smoke.PEAK[torch.float32],
                            cost["exps"] / chip_smoke.EXP_RATE) * 1e3}
        del x, dy, bs, cs, dt, a, dres, dt_ch, a_ch, d_ch, hc, ob, got, src
        del dst
        torch.cuda.empty_cache()
    rec["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
