#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases (each fails the run if its check fails):

1. build     - build both CUDA kernels from ``src/repro_torch/kernels/csrc``
               (one nvcc per source, in parallel);
2. parity    - each kernel against its plain PyTorch version on the card,
               at the serving path's shapes, f32 and bf16;
3. timing    - each kernel, its plain version and one PyTorch library call
               on the same inputs (device time from CUDA events, L2
               flushed before every call), beside the kernel's roofline
               bound;
4. reference - the smoke-size model on the card against the same model on
               the CPU (prefill at L = 1100, through the flash kernel, and
               three per-slot decode steps);
5. serve     - Llama-3.2-1B at full width (f32, seeded random params):
               a fixed batch of 4 x 1024-token prompts with a roomy HBM
               budget, the same with a budget 4 blocks short and eviction
               to the pool (greedy tokens must match), then a Poisson
               trace of 8 requests with half the prompts sharing a pooled
               prefix.  The kernels' launch counters are zeroed before
               each run and read after it: both kernels must have run.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit, and the result line.  The full record goes
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BW = 3.35e12                                   # H100 SXM, bytes/s
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}   # FLOP/s
TOL = {"rms_norm": {torch.float32: (1e-5, 1e-5),
                    torch.bfloat16: (1e-2, 1e-2)},
       "flash_attention": {torch.float32: (1e-4, 2e-5),
                           torch.bfloat16: (2e-2, 2e-2)}}
PROMPT, NEW, SLOTS, BT = 1024, 16, 4, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def close(got, want, rtol, atol) -> tuple:
    """(max abs error, within tolerance) in the style of assert_close."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.all(err <= atol + rtol * want.abs())
              and torch.all(torch.isfinite(got)))
    return float(err.max()), ok


class Timer:
    """Mean device time of ``fn()`` over ``iters`` calls.  Before each
    call a 256 MiB write evicts the 50 MB L2 (inputs arrive cold), then
    the device spins for about a millisecond while the host enqueues
    ``fn``, so the events bracket device work only, not Python's launch
    overhead."""

    SLEEP_CYCLES = 2_000_000

    def __init__(self):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.float32,
                                     device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def device_profile(fn) -> dict:
    """Device kernel time by name for one call of ``fn`` under
    ``torch.profiler``, and the device's busy share of the wall time
    (the profiler's own host overhead is inside that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.key, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda kv: -kv[1])
    busy = sum(t for _, t in kern)
    return {"wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us if wall_us else None,
            "top": [{"kernel": k[:80], "us": t} for k, t in kern[:8]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED
    from repro_torch.serving import ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record: dict = {"device": torch.cuda.get_device_name(0),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    log(f"device {record['device']}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # 1. build ---------------------------------------------------------
    record["build_s"] = build.build_all()
    log(f"[build] {build.KERNELS} in {record['build_s']:.1f}s")

    # 2. parity --------------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    parity = []
    for dtype in (torch.float32, torch.bfloat16):
        for t in (PROMPT, SLOTS):
            x, s = randn(t, 2048, dtype=dtype), randn(2048)
            err, ok = close(rn.rms_norm(x, s), rn.rms_norm_plain(x, s),
                            *TOL["rms_norm"][dtype])
            parity.append({"kernel": "rms_norm", "shape": [t, 2048],
                           "dtype": str(dtype), "max_abs_err": err,
                           "ok": ok})
        for lq, lk, window, q_off in ((1024, 1024, None, 0),
                                      (1000, 1000, None, 0),
                                      (1024, 1024, 256, 0),
                                      (512, 1024, None, 512)):
            q = randn(1, lq, 32, 64, dtype=dtype)
            k, v = (randn(1, lk, 32, 64, dtype=dtype) for _ in range(2))
            err, ok = close(fa.flash_attention(q, k, v, True, window,
                                               q_off),
                            fa.flash_attention_plain(q, k, v, True, window,
                                                     q_off),
                            *TOL["flash_attention"][dtype])
            parity.append({"kernel": "flash_attention",
                           "shape": [1, lq, lk, 32, 64], "window": window,
                           "q_offset": q_off, "dtype": str(dtype),
                           "max_abs_err": err, "ok": ok})
    torch.cuda.synchronize()
    record["parity"] = parity
    for p in parity:
        log(f"[parity] {json.dumps(p)}")
    if not all(p["ok"] for p in parity):
        fail("a kernel disagrees with its plain version")

    # 3. timing (main path shapes, f32) ---------------------------------
    timer = Timer()
    x, s = randn(PROMPT, 2048), randn(2048)
    rms_bytes = 2 * x.numel() * 4 + 4 * 2048
    rms_flops = 4 * x.numel()
    q, k, v = (randn(1, PROMPT, 32, 64) for _ in range(3))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = int(fa.attention_mask(PROMPT, PROMPT, True, None, 0, PROMPT)
                .sum()) * 32
    fa_flops = 4 * 64 * pairs
    fa_bytes = 4 * q.numel() * 4
    timing = {
        "rms_norm": {
            "ms": timer(lambda: rn.rms_norm(x, s)),
            "plain_ms": timer(lambda: rn.rms_norm_plain(x, s)),
            "library_ms": timer(lambda: torch.nn.functional.rms_norm(
                x, (2048,), weight=s, eps=1e-5)),
            "bytes": rms_bytes, "flops": rms_flops,
            "shape": [PROMPT, 2048]},
        "flash_attention": {
            "ms": timer(lambda: fa.flash_attention(q, k, v, True)),
            "plain_ms": timer(lambda: fa.flash_attention_plain(q, k, v,
                                                               True)),
            "library_ms": timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True)),
            "bytes": fa_bytes, "flops": fa_flops,
            "shape": [1, PROMPT, 32, 64]},
    }
    xd = randn(SLOTS, 2048)
    timing["rms_norm"]["decode_ms"] = timer(lambda: rn.rms_norm(xd, s))
    for name, t in timing.items():
        byte_ms = t["bytes"] / HBM_BW * 1e3
        op_ms = t["flops"] / PEAK[torch.float32] * 1e3
        t["bound_ms"] = max(byte_ms, op_ms)
        t["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
        log(f"[timing] {name} {json.dumps(t)}")
    record["timing"] = timing
    del x, s, q, k, v, qh, kh, vh, xd

    # 4. reference: smoke model on the card vs on the CPU ----------------
    scfg_small = get_config("llama3.2-1b", smoke=True)
    cpu_params = model.init_params(scfg_small,
                                   torch.Generator().manual_seed(0), "cpu")
    gpu_params = model.params_from_numpy(model.params_to_numpy(cpu_params),
                                         dev)
    toks = np.random.default_rng(0).integers(0, scfg_small.vocab_size,
                                             (1, 1100))
    worst = 0.0
    outs = {}
    for name, params, d in (("cpu", cpu_params, torch.device("cpu")),
                            ("gpu", gpu_params, dev)):
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(toks, device=d)},
            scfg_small, UNSHARDED, 1104, cache_dtype=torch.float32)
        steps = [logits]
        pos = torch.tensor([1100], device=d)
        for i in range(3):
            lg, caches = model.decode_step(
                params, caches, torch.tensor([[7 + i]], device=d), pos,
                scfg_small, UNSHARDED)
            steps.append(lg)
            pos = pos + 1
        outs[name] = [t.cpu() for t in steps] + \
            [caches[0]["k"].cpu(), caches[0]["v"].cpu()]
    for a, b in zip(outs["gpu"], outs["cpu"]):
        err, ok = close(a, b, 2e-4, 2e-5)
        worst = max(worst, err)
        if not ok:
            fail(f"smoke model on the card differs from the CPU: "
                 f"max abs error {err}")
    record["reference_max_abs_err"] = worst
    log(f"[reference] smoke prefill L=1100 + 3 decode steps, card vs CPU:"
        f" max abs err {worst:.3e} (rtol 2e-4, atol 2e-5)")
    del cpu_params, gpu_params, outs

    # 5. full-width serve -------------------------------------------------
    cfg = get_config("llama3.2-1b")
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0), dev, torch.float32)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (SLOTS, PROMPT))
    max_seq = PROMPT + NEW + 8
    blocks_needed = SLOTS * -(-(PROMPT + NEW) // BT)
    launches: dict = {}

    def run(label, fn):
        rn.rms_norm.launches = 0
        fa.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = {"rms_norm": rn.rms_norm.launches,
                           "flash_attention": fa.flash_attention.launches}
        log(f"[serve] {label}: {wall:.2f}s  launches {launches[label]}")
        return out, wall

    def fixed(**kw):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_seq=max_seq, decode_slots=SLOTS, kv_block_tokens=BT,
            pool_budget_bytes=1 << 30, **kw), device=dev)
        return eng, eng.generate({"tokens": prompts}, NEW)

    (roomy, roomy_toks), roomy_s = run("fixed_roomy", lambda: fixed())
    (tight, tight_toks), tight_s = run(
        "fixed_pool_eviction",
        lambda: fixed(kv_placement="pool",
                      hbm_budget_blocks=blocks_needed - 4))
    c = tight.counters
    serve_rec = {"fixed_roomy": {"wall_s": roomy_s,
                                 "tok_per_s": SLOTS * NEW / roomy_s,
                                 **roomy.counters},
                 "fixed_pool_eviction": {"wall_s": tight_s,
                                         "tok_per_s": SLOTS * NEW / tight_s,
                                         "hbm_budget_blocks":
                                             blocks_needed - 4, **c}}
    log(f"[serve] roomy tokens[0] {roomy_toks[0].tolist()}")
    if roomy_toks.shape != (SLOTS, NEW) or roomy_toks.max() >= \
            cfg.vocab_size or roomy_toks.min() < 0:
        fail(f"bad token block {roomy_toks.shape}")
    if not (c["evictions"] > 0 and c["restores"] > 0):
        fail(f"pool run did not evict and restore: {c}")
    if not np.array_equal(roomy_toks, tight_toks):
        fail("pool-eviction run's greedy tokens differ from the roomy run")
    del roomy, tight

    args = serve.build_parser().parse_args([
        "--arch", "llama3.2-1b", "--trace", "poisson", "--requests", "8",
        "--prompt-reuse", "0.5", "--prompt-len", str(PROMPT),
        "--new-tokens", str(NEW), "--decode-slots", str(SLOTS),
        "--kv-block-tokens", str(BT), "--pool-budget-mib", "1024"])
    eng = ServeEngine(cfg, params, ServeConfig(
        max_seq=max_seq, decode_slots=SLOTS, kv_block_tokens=BT,
        pool_budget_bytes=args.pool_budget_mib << 20, prefix_sharing=True),
        device=dev)
    trace, _ = run("trace_poisson", lambda: serve.run_trace(eng, cfg, args))
    if not trace["prefix_hits"] > 0 or trace["requests"] != 8:
        fail(f"trace: no pooled prefix hit or lost requests: {trace}")

    # step times at full width (after the counted runs)
    one = torch.as_tensor(prompts[:1], device=dev)
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": one}, cfg, UNSHARDED, max_seq,
                      cache_dtype=torch.float32)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    dec = []
    pos = torch.full((SLOTS,), PROMPT, device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(params, eng.caches, tok, pos, cfg, UNSHARDED)
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t0) * 1e3)
    trace["profile_prefill"] = device_profile(lambda: model.prefill(
        params, {"tokens": one}, cfg, UNSHARDED, max_seq,
        cache_dtype=torch.float32))
    trace["profile_decode_5_steps"] = device_profile(lambda: [
        model.decode_step(params, eng.caches, tok, pos, cfg, UNSHARDED)
        for _ in range(5)])
    for key in ("profile_prefill", "profile_decode_5_steps"):
        log(f"[profile] {key} {json.dumps(trace[key])}")
    trace["prefill_ms"] = float(np.median(pre))
    trace["decode_step_ms"] = float(np.median(dec))
    serve_rec["trace_poisson"] = trace
    serve_rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] trace: {trace['req_per_s']:.3f} req/s  "
        f"{trace['tok_per_s']:.1f} tok/s  p50 {trace['latency_p50_s']:.3f}s"
        f"  p99 {trace['latency_p99_s']:.3f}s  prefill(1x{PROMPT}) "
        f"{trace['prefill_ms']:.1f} ms  decode step ({SLOTS} slots) "
        f"{trace['decode_step_ms']:.2f} ms  prefix hits "
        f"{trace['prefix_hits']}")
    record["serve"] = serve_rec
    record["launches"] = launches

    # 6. launch check ----------------------------------------------------
    total = {n: sum(p[n] for p in launches.values())
             for n in ("rms_norm", "flash_attention")}
    for name, n in total.items():
        if n <= 0:
            fail(f"the serving path never launched the {name} kernel")

    # 7. output lines ----------------------------------------------------
    replaces = {"rms_norm": "src/repro/kernels/rmsnorm.py:36",
                "flash_attention": "src/repro/kernels/flash_attention.py:91"}
    kernels = []
    for name in ("rms_norm", "flash_attention"):
        t = timing[name]
        main = [p for p in parity if p["kernel"] == name
                and p["dtype"] == str(torch.float32)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{'rmsnorm' if name == 'rms_norm' else name}.cu",
            "replaces": replaces[name], "launches": total[name],
            "launches_by_run": {k: v[name] for k, v in launches.items()},
            "max_abs_err": main[0]["max_abs_err"],
            "tolerance": TOL[name][torch.float32],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "dtype": "float32"})
    record["kernels"] = kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    record["nvidia_smi"] = smi
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
