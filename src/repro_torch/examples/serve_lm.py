"""Serve a model with batched requests: prefill a batch of prompts,
decode with greedy or temperature sampling, optionally with the
sliding-window cache (the long_500k configuration's).  Port of
``examples/serve_lm.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
      --arch llama3.2-1b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
      --arch falcon-mamba-7b --smoke --window 64 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.device import synchronize
from repro_torch.core.device import resolve_device
from repro_torch.examples import add_device, printer
from repro_torch.models import model
from repro_torch.serving import ServeConfig, ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU friendly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--window", type=int, default=None)
    return add_device(ap)


def make_batch(cfg, batch: int, prompt_len: int) -> dict:
    """The reference's request batch: prompts from ``default_rng(0)``,
    then the frontends' stub inputs from the same generator."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len))}
    if cfg.frontend == "vision_stub" and cfg.encoder is None:
        out["frontend"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)
    if cfg.encoder is not None:
        out["source"] = rng.standard_normal(
            (batch, cfg.encoder.source_len, cfg.frontend_dim)).astype(
                np.float32)
    return out


def run(cfg, params, args, say=print) -> dict:
    """Generate for ``args``' batch with ``params`` (GLOBAL, tp 1, on
    ``args.device``): ``max_seq`` = prompt + new + 8, as the reference's.
    Returns the tokens (B, new), the seconds and tok/s."""
    dev = resolve_device(args.device)
    eng = ServeEngine(cfg, params, ServeConfig(
        max_seq=args.prompt_len + args.new_tokens + 8,
        window=args.window, temperature=args.temperature), device=dev)
    batch = make_batch(cfg, args.batch, args.prompt_len)
    synchronize(dev)
    t0 = time.time()
    out = eng.generate(batch, max_new_tokens=args.new_tokens)
    synchronize(dev)
    dt = time.time() - t0
    say(f"arch={cfg.name} batch={args.batch} "
        f"prompt={args.prompt_len} new={args.new_tokens} "
        f"window={args.window}")
    say(f"generated {out.shape} in {dt:.2f}s "
        f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    say(f"first request: {out[0].tolist()}")
    return {"tokens": out, "seconds": dt,
            "tok_s": args.batch * args.new_tokens / dt,
            "counters": dict(eng.counters)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    lines: list = []
    out = run(cfg, params, args, printer(lines))
    return {"lines": lines, **out}


if __name__ == "__main__":
    main()
