"""End-to-end example: train a ~100M-param llama-family model on
synthetic data and checkpoint it.  Port of ``examples/train_lm.py``.

The communication backend is selectable as in the training launcher:
at ``--tp 1 --dp 1`` the step runs in this process (``train_loop.train``);
with ``tp x dp > 1`` the step runs on ``tp x dp`` spawned ranks over
(data, model) = (dp, tp) (``launch.train.run_many``: FSDP over data,
tensor parallel over model), every collective through the
``Communicator``.  The checkpoint holds the GLOBAL params either way, as
the launcher's ``--ckpt`` writes them, so the reference's
``checkpoint.restore`` reads it.

Usage:
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 50 \\
      --backend cxl --tp 2 --dp 2
  (add ``--device cpu`` to run on the CPU)
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.examples import add_device, printer
from repro_torch.models.config import ModelConfig, dense_pattern
from repro_torch.training import checkpoint
from repro_torch.training.train_loop import TrainConfig, train

# ~100M params: 12 layers, d_model 768 (gpt2-small scale, llama anatomy)
CFG_100M = ModelConfig(
    name="llama-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000,
    layer_pattern=dense_pattern(12), source="examples/train_lm.py")
WARMUP = 20
LOG_EVERY = 20


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--backend", choices=["ring", "cxl"], default="ring")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_ckpt"))
    return add_device(ap)


def train_config(args) -> TrainConfig:
    return TrainConfig(lr=args.lr, warmup=WARMUP, total_steps=args.steps,
                       backend=args.backend)


def sharded_spec(args, params_path: Optional[str] = None):
    """The ``launch.train.RunSpec`` of a ``tp x dp > 1`` run: one
    variant, the GLOBAL params of ``params_path`` (an .npz,
    ``launch.train.save_params_npz``) or seed 0, the checkpoint at
    ``args.ckpt``."""
    from repro_torch.launch.train import RunSpec
    return RunSpec(arch=CFG_100M.name, smoke=False, config=CFG_100M,
                   variants=(train_config(args),), steps=args.steps,
                   batch=args.batch, seq=args.seq, dp=args.dp, tp=args.tp,
                   device=args.device, params_path=params_path,
                   ckpt=args.ckpt)


def log_sharded(record: dict, say=print) -> list:
    """The sharded run's log, as the reference's loop prints it: every
    ``LOG_EVERY``-th step and the last, with the seconds since the first
    step began (the slowest rank's steps summed).  Returns the losses."""
    losses, t = [], 0.0
    steps = record["steps"]
    for i, s in enumerate(steps):
        t += s["step_s"]
        losses.append(s["loss"])
        if i % LOG_EVERY == 0 or i == len(steps) - 1:
            say(f"step {i:4d} loss {s['loss']:.4f} ({t:.1f}s)")
    return losses


def run(args, params=None, say=print) -> dict:
    """Train ``CFG_100M`` per ``args`` from ``params`` (GLOBAL at ``args.tp``,
    tensors or numpy; None: seed 0 on the device) and checkpoint it.
    Returns the final GLOBAL params, the losses (every step's on the
    sharded path; in one process the logged steps', None between), the
    mean seconds of a step after the first (``mean_step_s``; in one
    process from the clock at the logged steps, whose loss read waits
    for the step's queued work; None with fewer than two logged), the
    run's record (the sharded path's, ``launch.train.run_many``'s) and
    the checkpoint's path."""
    dev = resolve_device(args.device)
    cfg = CFG_100M
    say(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params), "
        f"backend={args.backend}")
    record = None
    if args.tp * args.dp > 1:
        from repro_torch.launch import train as launcher
        with tempfile.TemporaryDirectory(prefix="train-lm-") as tmp:
            path = None
            if params is not None:
                path = os.path.join(tmp, "params.npz")
                launcher.save_params_npz(params, path)
            record = launcher.run_many([sharded_spec(args, path)])[0][0]
        losses = log_sharded(record, say)
        step_s = [s["step_s"] for s in record["steps"]][1:]
        mean_step_s = sum(step_s) / len(step_s) if step_s else None
        params = record["global_params"]
        saved = record["ckpt"]
    else:
        logged: dict = {}

        def log(line: str) -> None:
            say(line)
            parts = line.split()
            logged[int(parts[1])] = (float(parts[3]), time.perf_counter())

        params, _, _ = train(cfg, train_config(args), iter(SyntheticTokens(
            cfg, batch=args.batch, seq=args.seq)), steps=args.steps,
            params=params, log_every=LOG_EVERY, log_fn=log, device=dev)
        saved = checkpoint.save(args.ckpt, args.steps, {"params": params})
        losses = [logged[i][0] if i in logged else None
                  for i in range(args.steps)]
        first, last = min(logged), max(logged)
        mean_step_s = ((logged[last][1] - logged[first][1]) / (last - first)
                       if last > first else None)
    say(f"checkpoint written to {args.ckpt}/step_{args.steps:08d}")
    return {"params": params, "losses": losses, "mean_step_s": mean_step_s,
            "record": record, "ckpt": saved}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    lines: list = []
    return {"lines": lines, **run(args, say=printer(lines))}


if __name__ == "__main__":
    main()
