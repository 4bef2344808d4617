"""Serving launcher of the port: request-level generation on the GPU.

Two modes:

* default - the fixed-batch path (one ``generate`` call, reported as
  tok/s);
* ``--trace poisson`` - an open-loop request trace: ``--requests``
  arrivals drawn from a Poisson process (``--arrival-rate`` requests
  per decode step) are submitted against the continuous-batching
  engine and reported as req/s + latency percentiles.
  ``--prompt-reuse`` draws that fraction of prompts from a shared
  prefix, exercising the CXL-pooled prefix cache (prefix sharing is
  auto-enabled when reuse > 0).

Runs on the CUDA card unless ``--device cpu`` is given.  Params are
random, from a seeded ``torch.Generator``.  ``--plan`` loads a tuned
plan whose ``kv_block`` cells price eviction placement
(``repro_torch.launch.tune --kv-block-bytes``); the engine is unsharded,
so no collective resolves against it.  ``--topology`` activates a
topology process-wide, as the reference launcher does.  ``--placement
auto|PATH`` ranks the mesh-axis -> level assignments of that topology
for the model's collective mix at ``--placement-axes`` (``tuner.
placement``), prints the report and installs the placed topology and
the axis aliases, as the reference launcher does (they take effect when
serving sharded).  ``--ckpt DIR`` restores the params from a checkpoint
in the reference's layout (``training.checkpoint``; written by either
package's ``train --ckpt``) at ``--ckpt-step`` (unset or 0: the latest
committed step), checked against the model's unsharded (tp = 1) shapes
as the reference checks them: a checkpoint padded for another tp is
refused.

``--metrics-out`` writes the reference's observability stream
(``obs.ObsSession``): one event a generate round (fixed batch) or a
step (``--trace``), the engine's ``serve_step`` spans, its diagnostics
and, at the end, the final registry with the ``repro_serve_*`` gauges
of ``ServeEngine.counters`` (and ``<base>.prom``).  ``--online-retune``
(requires ``--plan``; excludes ``--trace``) treats every generate round
as a step, as the reference launcher does: the round's wall time is
apportioned over the round's ``auto`` audit, the plan refreshed every
``--retune-interval`` rounds (``--rounds`` of them, default 2 x the
interval) and ``--plan-out`` written at the end.  The engine is
unsharded (tp = 1) and issues no ``auto`` collective, so the launcher
says so through ``diag`` and the plan cannot change, as in the
reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 1024 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --trace poisson --requests 8 \\
      --prompt-reuse 0.5
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch falcon-mamba-7b --batch 4 --prompt-len 1024 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b --batch 4 --prompt-len 1024 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --ckpt DIR [--ckpt-step N] --batch 4 --prompt-len 1024

  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --batch 4 --prompt-len 1024 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi-3-vision-4.2b --batch 4 --prompt-len 1024 --new-tokens 16

A model whose cache has no token axis (Falcon-Mamba's SSM state,
whisper-tiny's cross-attention keys and values) cannot share pooled
prefixes: ``--prompt-reuse`` then runs plain prefills.

The fixed batch of a model with a stub frontend carries its seeded
random embeddings (``stub_batch``): Phi-3-vision's 576 patch
embeddings, which take the cache's first positions (``max_seq`` is
sized with them), or whisper-tiny's 1500 encoder frames.  The reference
launcher's trace builds requests without them, so ``--trace`` refuses
these models.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import CXL_POOL, INFINIBAND
from repro_torch.core.topology import parse_topology, set_active_topology
from repro_torch.launch import add_xla_overlap, refuse_xla_overlap
from repro_torch.models import model
from repro_torch.serving import (Request, SamplingParams, ServeConfig,
                                 ServeEngine)
from repro_torch.training import checkpoint


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))
    return sorted_vals[i]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_trace(cfg, args) -> tuple:
    """(requests, arrival steps) of the Poisson trace, from ``--seed``."""
    rng = np.random.default_rng(args.seed)
    bt = args.kv_block_tokens
    prefix_len = args.prefix_len
    if prefix_len is None:
        # longest block-aligned prefix that still leaves a suffix
        prefix_len = max(bt, (args.prompt_len - 1) // bt * bt)
    prefix_len = min(prefix_len, args.prompt_len - 1)
    shared = rng.integers(0, cfg.vocab_size, prefix_len)
    arrivals = np.cumsum(rng.exponential(
        1.0 / args.arrival_rate, args.requests))   # in decode steps
    reqs = []
    for i in range(args.requests):
        if rng.random() < args.prompt_reuse:
            toks = np.concatenate([shared, rng.integers(
                0, cfg.vocab_size, args.prompt_len - prefix_len)])
        else:
            toks = rng.integers(0, cfg.vocab_size, args.prompt_len)
        reqs.append(Request(
            id=f"req{i}", tokens=toks,
            sampling=SamplingParams(temperature=args.temperature,
                                    seed=args.seed + i),
            max_new_tokens=args.new_tokens))
    return reqs, arrivals


def run_trace(eng: ServeEngine, cfg, args, obs_sess=None) -> dict:
    """Open-loop Poisson request trace against the live engine; prints
    and returns the summary (wall clock around synchronised steps).  With
    ``obs_sess`` each engine step is booked (``on_step``) and the session
    finalized with the summary."""
    reqs, arrivals = make_trace(cfg, args)
    _sync(eng.device)
    t0 = time.perf_counter()
    born, done = {}, {}
    step, nxt = 0, 0
    while nxt < len(reqs) or not eng.sched.idle:
        if (eng.sched.idle and nxt < len(reqs)
                and arrivals[nxt] > step):
            step = int(np.ceil(arrivals[nxt]))   # skip the idle gap
        while nxt < len(reqs) and arrivals[nxt] <= step:
            eng.submit(reqs[nxt])
            born[reqs[nxt].id] = time.perf_counter()
            nxt += 1
        ts = time.perf_counter()
        eng.step()
        _sync(eng.device)
        dt = time.perf_counter() - ts
        step += 1
        for rid, (status, _fresh) in eng.poll().items():
            if status == "finished" and rid not in done:
                done[rid] = time.perf_counter()
        if obs_sess is not None:
            obs_sess.on_step(step, dt, extra={
                "inflight": eng.sched.inflight})
    wall = time.perf_counter() - t0
    lats = sorted(done[r] - born[r] for r in done)
    toks = len(done) * args.new_tokens
    c = eng.counters
    summary = {"requests": len(done), "wall_s": wall,
               "req_per_s": len(done) / wall, "tok_per_s": toks / wall,
               "latency_p50_s": _pct(lats, 0.5),
               "latency_p99_s": _pct(lats, 0.99),
               "preemptions": eng.sched.preemption_count, **c}
    print(f"{cfg.name}: trace poisson  {len(done)} requests in "
          f"{wall:.2f}s ({len(done) / wall:.2f} req/s, "
          f"{toks / wall:.1f} tok/s)")
    print(f"  latency p50 {summary['latency_p50_s']:.3f}s  "
          f"p99 {summary['latency_p99_s']:.3f}s  "
          f"decode steps {c['decode_steps']}  "
          f"prefills {c['prefills']}")
    print(f"  prefix hits {c['prefix_hits']} "
          f"({c['prefix_hit_tokens']} tokens pooled)  "
          f"evictions {c['evictions']}  restores {c['restores']}  "
          f"replays {c['replays']}  "
          f"preemptions {eng.sched.preemption_count}")
    if obs_sess is not None:
        from repro_torch.core import ledger
        obs_sess.finalize(snapshot=ledger.snapshot(), extra={
            "requests": len(done), "wall_s": wall,
            "req_per_s": len(done) / wall,
            "latency_p50_s": summary["latency_p50_s"],
            "latency_p99_s": summary["latency_p99_s"], **eng.stats()})
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--trace", choices=["poisson"], default=None,
                    help="request-trace mode: submit --requests "
                         "Poisson arrivals through submit/step/poll "
                         "and report req/s + latency percentiles "
                         "instead of the fixed batch")
    ap.add_argument("--requests", type=int, default=16,
                    help="trace mode: number of requests")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="trace mode: mean arrivals per decode step")
    ap.add_argument("--prompt-reuse", type=float, default=0.0,
                    help="trace mode: fraction of prompts sharing a "
                         "common prefix (> 0 auto-enables "
                         "--prefix-sharing)")
    ap.add_argument("--prefix-len", type=int, default=None,
                    help="shared-prefix tokens for --prompt-reuse "
                         "(default: longest block-aligned prefix)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-slots", type=int, default=4,
                    help="dense decode lanes (engine batch)")
    ap.add_argument("--kv-block-tokens", type=int, default=16,
                    help="tokens per paged HBM KV block")
    ap.add_argument("--hbm-budget-blocks", type=int, default=None,
                    help="HBM KV block budget (default: enough for "
                         "every slot at max_seq; lower it to force "
                         "eviction to the pool)")
    ap.add_argument("--pool-budget-mib", type=int, default=64,
                    help="CXL pool budget for evictions + pooled "
                         "prefixes (MiB)")
    ap.add_argument("--scheduler", choices=["continuous", "static"],
                    default="continuous",
                    help="'static' is the batch-synchronous baseline "
                         "(admits only when the engine drained)")
    ap.add_argument("--kv-placement",
                    choices=["auto", "pool", "recompute"],
                    default="auto",
                    help="eviction placement: 'auto' prices the pool "
                         "round-trip vs recompute (live oracle)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="publish complete prompt blocks to the "
                         "pooled prefix store and restore them for "
                         "later matching prompts")
    ap.add_argument("--plan", default=None,
                    help="autotuning plan JSON (repro_torch.launch.tune)"
                         "; its kv_block cells price eviction placement "
                         "before the live oracle")
    ap.add_argument("--topology", default=None,
                    help="'axis:fabric[:shape],...' spec or topology "
                         "JSON file, activated process-wide")
    ap.add_argument("--placement", default=None,
                    help="'auto' or a saved placement JSON: rank the "
                         "mesh-axis -> fabric-level assignments for "
                         "this arch (tuner.placement), print the "
                         "report, and activate the placed topology + "
                         "axis aliases; needs --topology")
    ap.add_argument("--placement-axes", default="data=2,model=4",
                    help="logical axis degrees for --placement, "
                         "'name=size,...'")
    ap.add_argument("--ckpt", default=None,
                    help="restore the params from this checkpoint "
                         "directory (train --ckpt, either package)")
    ap.add_argument("--ckpt-step", type=int, default=None,
                    help="the checkpoint's step (unset or 0: the latest)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    ap.add_argument("--online-retune", action="store_true",
                    help="treat every generate round as a step: fold its "
                         "measured wall time back into the plan and "
                         "hot-swap at --retune-interval round boundaries; "
                         "requires --plan (the unsharded engine issues no "
                         "collective to measure: the plan cannot change)")
    ap.add_argument("--retune-interval", type=int, default=4,
                    help="generate rounds between plan refresh + hot-swap "
                         "under --online-retune")
    ap.add_argument("--rounds", type=int, default=None,
                    help="number of generate rounds (default 1; 2 x "
                         "retune-interval under --online-retune)")
    ap.add_argument("--plan-out", default=None,
                    help="persist the measurement-refined plan (format "
                         "v4) here at the end of the run")
    ap.add_argument("--metrics-out", default=None,
                    help="write per-round/step and retune events + the "
                         "final metric registry as JSON-lines here (and a "
                         "Prometheus rendering to <base>.prom)")
    add_xla_overlap(ap)
    return ap


def restore_params(cfg, ckpt_dir: str, step, device) -> dict:
    """The params of a checkpoint in the reference's layout at ``step``
    (None or 0: the latest committed one, as the reference launcher's
    ``args.ckpt_step or latest_step``), restored into the structure and
    unsharded shapes of ``{"params": init_params(cfg, tp=1)}``: a
    checkpoint padded for another tp raises ``ValueError``."""
    step = step or checkpoint.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    tree = checkpoint.restore(ckpt_dir, step,
                              {"params": model.abstract_params(cfg, tp=1)})
    print(f"restored {ckpt_dir} step {step}")
    return model.params_from_numpy(tree["params"], device, cfg, tp=1)


def engine_from_args(args, obs=None) -> tuple:
    """(cfg, engine) for parsed launcher arguments; params come from the
    checkpoint of ``--ckpt``, else from a ``torch.Generator`` seeded 0 on
    the engine's device; ``obs`` is the engine's ``ObsSession``."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.trace and model.frontend_inputs(cfg):
        raise ValueError(f"{cfg.name}: --trace builds text requests, and "
                         f"this model takes its frontend's input with "
                         f"every request (the reference's trace cannot "
                         f"serve it either); serve the fixed batch")
    device = resolve_device(args.device)
    if args.ckpt:
        params = restore_params(cfg, args.ckpt, args.ckpt_step, device)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init_params(cfg, gen, device, torch.float32)
    scfg = ServeConfig(
        max_seq=model.prefix_tokens(cfg) + args.prompt_len
        + args.new_tokens + 8,
        window=args.window, temperature=args.temperature,
        decode_slots=args.decode_slots,
        kv_block_tokens=args.kv_block_tokens,
        hbm_budget_blocks=args.hbm_budget_blocks,
        pool_budget_bytes=args.pool_budget_mib << 20,
        scheduler=args.scheduler, kv_placement=args.kv_placement,
        prefix_sharing=(args.prefix_sharing
                        or args.prompt_reuse > 0.0),
        plan_path=args.plan)
    return cfg, ServeEngine(cfg, params, scfg, device=device, obs=obs)


def stub_batch(cfg, batch: int, prompt_len: int,
               rng: np.random.Generator) -> dict:
    """The fixed batch: ``batch`` prompts of ``prompt_len`` tokens and,
    drawn after them from ``rng``, the frontend's stub embeddings (f32),
    as the reference launcher draws them."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len))}
    if model.prefix_tokens(cfg):
        out["frontend"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    if cfg.encoder is not None:
        out["source"] = rng.standard_normal(
            (batch, cfg.encoder.source_len, cfg.frontend_dim)
        ).astype(np.float32)
    return out


def apply_placement(ap, args) -> None:
    """``--placement``: rank the active topology's placements for the
    model's mix at ``--placement-axes``, print the report and install
    the chosen placement's aliases and placed topology."""
    from repro_torch import tuner
    from repro_torch.core.topology import get_active_topology
    from repro_torch.launch.mesh import make_placed_mesh
    from repro_torch.launch.tune import parse_axes
    topo = get_active_topology()
    if topo is None:
        ap.error("--placement requires --topology")
    cfg = get_config(args.arch, smoke=args.smoke)
    mix = tuner.CollectiveMix.for_model(
        cfg, parse_axes(args.placement_axes),
        seq=args.prompt_len + args.new_tokens)
    pplan = tuner.plan_placement(mix, topo) if args.placement == "auto" \
        else tuner.load_placement(args.placement)
    chosen = pplan.best_with_unsplit(("model",))
    print(tuner.format_report(pplan, chosen=chosen))
    make_placed_mesh(chosen, mix, topo)


def main(argv=None) -> dict:
    """Serve as the flags say; returns the fixed batch's output
    (``out``), the rounds' wall times (``round_s``) and the engine, or
    the trace's summary (``trace``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    refuse_xla_overlap(args)
    if args.online_retune and not args.plan:
        ap.error("--online-retune requires --plan")
    if args.trace and args.online_retune:
        ap.error("--trace and --online-retune are mutually exclusive "
                 "(retune is driven by fixed-batch rounds)")
    if args.topology:
        set_active_topology(parse_topology(args.topology))
    if args.placement:
        apply_placement(ap, args)
    obs_sess = None
    if args.metrics_out:
        from repro_torch.obs import ObsSession
        obs_sess = ObsSession(metrics_out=args.metrics_out)
    cfg, eng = engine_from_args(args, obs=obs_sess)
    if args.trace:
        return {"trace": run_trace(eng, cfg, args, obs_sess), "engine": eng}
    batch = stub_batch(cfg, args.batch, args.prompt_len,
                       np.random.default_rng(0))
    online = None
    if args.online_retune:
        import dataclasses

        from repro_torch import tuner
        from repro_torch.core import ledger
        online = tuner.OnlineTuner(
            tuner.load_plan(args.plan, pool=CXL_POOL, ib=INFINIBAND),
            retune_interval=args.retune_interval)
        # the refreshed plan lives in a file so rebuilt engines load it
        live_path = args.plan_out or (args.plan + ".refined.json")
        ledger.reset()
    rounds = args.rounds if args.rounds is not None else (
        2 * args.retune_interval if args.online_retune else 1)
    out, round_s = None, []
    profile = None     # the auto audit of the engine's first round
    for r in range(rounds):
        _sync(eng.device)
        t0 = time.perf_counter()
        out = eng.generate(batch, max_new_tokens=args.new_tokens)
        _sync(eng.device)
        dt = time.perf_counter() - t0
        round_s.append(dt)
        print(f"{cfg.name}: {out.shape} in {dt:.2f}s "
              f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
        if obs_sess is not None:
            obs_sess.on_step(r, dt, extra={
                "tok_per_s": args.batch * args.new_tokens / dt})
        if online is None:
            continue
        if profile is None:
            # the engine's first round: its audit is the per-round
            # collective profile later rounds rerun (its wall time pays
            # first-touch costs, so it is not folded)
            profile = ledger.snapshot()["auto_choices"]
            if not profile:
                msg = ("--online-retune: the engine issued no auto "
                       "collectives (unsharded tp=1 engines have "
                       "nothing to measure) - rounds will run but "
                       "the plan cannot change")
                if obs_sess is not None:
                    obs_sess.diag("serve", msg)
                else:
                    print(f"[serve] {msg}")
        else:
            online.observe_step(dt, profile)
        prev = online.plan
        refreshed = online.maybe_retune(r)
        if refreshed is not None:
            tuner.save_plan(refreshed, live_path)
            swapped = tuner.choices_changed(prev, refreshed)
            if obs_sess is not None:
                obs_sess.on_retune(epoch=tuner.plan_epoch(),
                                   swapped=swapped,
                                   regret_s=online.measured_regret())
            if swapped:
                # hot-swap between rounds: rebuild the engine against
                # the refreshed plan
                eng = ServeEngine(cfg, eng.params, dataclasses.replace(
                    eng.scfg, plan_path=live_path), device=eng.device,
                    obs=obs_sess)
                ledger.reset()
                profile = None
                print(f"round {r}: plan hot-swap -> {live_path}")
    if online is not None and args.plan_out:
        tuner.save_plan(online.refresh(), args.plan_out)
        print(f"saved refined plan (v4) -> {args.plan_out}")
    if obs_sess is not None:
        from repro_torch.core import ledger as _ledger
        obs_sess.finalize(snapshot=_ledger.snapshot(),
                          extra={"rounds": rounds})
    print(out[: min(2, args.batch)].tolist())
    return {"out": out, "round_s": round_s, "engine": eng}


if __name__ == "__main__":
    main()
