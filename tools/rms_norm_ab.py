#!/usr/bin/env python3
"""``rms_norm`` on one NVIDIA GPU: an earlier checkout's forward kernel
against this checkout's, in turns, beside the plain versions,
``F.rms_norm`` and a copy of the same bytes; then the backward.

Run from the root of a checkout, on a machine with a card::

    python3 tools/rms_norm_ab.py --old OLD/src/repro_torch/kernels/csrc/rmsnorm.cu

``OLD`` is an earlier checkout (``git archive`` of a parent commit,
unpacked into a directory that ``.gitignore`` lists) whose
``rmsnorm.cu`` exports the PR 11 C entry ``rmsnorm_launch(x, scale, y,
rows, D, eps, dtype, stream)``; it is built here with the flags of
``repro_torch.kernels.build``.  Each forward shape (f32) is timed old,
new, new, old with ``chip_smoke.Timer`` (L2 flushed before every
call), then its plain version, ``F.rms_norm`` and ``y.copy_(x)``.  The
backward at (1024, 2048) times this checkout's autograd backward, the
plain chain ``rms_norm_backward``, the autograd backward of
``F.rms_norm`` (each graph built once, ``torch.autograd.grad`` with
``retain_graph=True``, so only the backward is timed) and
``torch.add(x, dy, out=dx)`` (its bytes: read x and dy, write dx), and
counts the device kernels each backward launches and their device time
under ``torch.profiler``.  Prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

FWD_SHAPES = ((1024, 2048), (4, 2048), (1024, 4096), (4, 4096))
BWD_SHAPE = (1024, 2048)
EPS = 1e-5
OLD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]


def build_old(src: pathlib.Path):
    """The old kernel's ``rmsnorm_launch``, built from ``src``."""
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"librmsnorm-old-{key}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    fn = ctypes.CDLL(str(out)).rmsnorm_launch
    fn.restype, fn.argtypes = ctypes.c_int, OLD_ARGTYPES
    return fn


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
                    default=chip_smoke.OUT_DIR / "rms_norm_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rms_norm_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    old = build_old(args.old)
    timer = chip_smoke.Timer()
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def old_fwd(x, s, y):
        err = old(x.data_ptr(), s.data_ptr(), y.data_ptr(), x.shape[0],
                  x.shape[1], EPS, 0, torch.cuda.current_stream().cuda_stream)
        build.check("rmsnorm", err)

    rec = {"device": torch.cuda.get_device_name(0), "forward": {}}
    for t, d in FWD_SHAPES:
        x, s, y = randn(t, d), randn(d), torch.empty(t, d, device=dev)
        old_fwd(x, s, y)
        err = float((y - rn.rms_norm_plain(x, s, EPS)).abs().max())
        turns = {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            turns[side].append(timer(
                (lambda: old_fwd(x, s, y)) if side == "old"
                else (lambda: rn.rms_norm(x, s, EPS))))
        rec["forward"][f"{t}x{d}"] = {
            "old_ms": turns["old"], "new_ms": turns["new"],
            "old_max_abs_err": err,
            "plain_ms": timer(lambda: rn.rms_norm_plain(x, s, EPS)),
            "library_ms": timer(lambda: torch.nn.functional.rms_norm(
                x, (d,), weight=s, eps=EPS)),
            "copy_ms": timer(lambda: y.copy_(x)),
            "bound_ms": (2 * t * d * 4 + 4 * d) / chip_smoke.HBM_BW * 1e3}
    t, d = BWD_SHAPE
    x, dy = randn(t, d).requires_grad_(), randn(t, d)
    s = randn(d).requires_grad_()
    dx = torch.empty_like(dy)
    ys = {"new": rn.rms_norm(x, s, EPS),
          "library": torch.nn.functional.rms_norm(x, (d,), weight=s,
                                                  eps=EPS)}
    calls = {k: (lambda y=y: torch.autograd.grad(y, (x, s), dy,
                                                 retain_graph=True))
             for k, y in ys.items()}
    calls["plain"] = lambda: rn.rms_norm_backward(x.detach(), s.detach(),
                                                  EPS, dy)
    calls["copy"] = lambda: torch.add(x.detach(), dy, out=dx)
    rec["backward"] = {f"{k}_ms": timer(fn) for k, fn in calls.items()}
    rec["backward"].update({f"{k}_kernels": device_kernels(fn)
                            for k, fn in calls.items()})
    rec["backward"]["bound_ms"] = (3 * t * d * 4 + 8 * d) \
        / chip_smoke.HBM_BW * 1e3
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
