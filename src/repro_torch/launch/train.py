"""Training launcher: FSDP (+ tensor-parallel) training of a dense
decoder on one host.

Port of ``repro.launch.train`` for the flags of the FSDP and
tensor-parallel paths:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 4x1 --backend cxl --steps 3 --batch 4 --seq 1024 \\
      [--fuse-kernels]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --mesh 4x1 --backend cxl --steps 3 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.tune --nranks 4 \\
      --sizes-mib 1 4 16 64 256 --out plan.json
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 4x1 --backend auto --plan plan.json --steps 3 --batch 4 \\
      --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 4x1 --multi-pod --topology pod:cxl,data:ici --backend cxl \\
      --steps 3 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 2x2 --backend cxl --steps 3 --batch 4 --seq 1024 \\
      [--fuse-kernels]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 4x1 --topology pod:cxl,data:cxl:3+1 --backend cxl \\
      --steps 3 --batch 4 --seq 1024 [--fuse-kernels]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 4x1 --topology pod:cxl,node:cxl:3+1 --placement auto \\
      --backend cxl --steps 3 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b --mesh 2x2 --topology data:cxl,model:cxl \\
      --backend cxl --steps 3 --batch 4 --seq 1024 --prefetch 0 \\
      [--fuse-kernels] [--ckpt DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --mesh 4x1 --backend cxl --steps 3 --batch 4 --seq 1024 \\
      [--fuse-kernels]
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --mesh 2x2 --topology data:cxl,model:cxl --backend cxl --steps 3 \\
      --batch 4 --seq 1024 [--fuse-kernels]
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch falcon-mamba-7b --smoke --mesh 4x1 --backend cxl --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 4x1 --pp-stages 2 --microbatches 2 --pp-schedule 1f1b \\
      --batch 4 --seq 1024 --backend cxl --topology stage:cxl,data:cxl \\
      --steps 3 [--ckpt DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --mesh 4x1 --pp-stages 2 --microbatches 2 \\
      --pp-schedule interleaved --pp-chunks 2 --batch 8 --seq 32 \\
      --backend ring --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 2x2 --topology data:cxl,model:cxl --batch 4 --seq 1024 \\
      --backend auto --plan plan.json --online-retune --retune-interval 1 \\
      --timing-source profiler --metrics-out run.jsonl \\
      --trace-out run.trace.json --plan-out refined.json --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --mesh 2x2 --topology data:cxl,model:cxl \\
      --backend auto --online-retune --retune-interval 1 \\
      --timing-source emulator --emu-degrade model@cxl=4 --steps 4 \\
      --seq 32 --metrics-out run.jsonl --trace-out run.trace.json
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --mesh 4x1 --topology pod:cxl,data:cxl:3+1 --backend auto \\
      --plan plan.json --batch 4 --seq 1024 --resilience \\
      --fault-plan rank_death@1:rank=1 --pool-ckpt-interval 2 --steps 6

The launcher spawns one process per rank (``spawn`` start method); rank
r runs on ``cuda:(r % device_count)``, so the ranks of a one-card host
share that card, and on the CPU with ``--device cpu``.  The ranks form a
``gloo`` process group (file rendezvous in a temporary directory); with
``--backend cxl`` or ``auto`` they also map one shared host pool
(``memfd``, pinned on each rank with ``cudaHostRegister``) with a 256
MiB partition per rank (less for a model whose params are smaller):
larger collectives stream through it in rounds.  Every kernel is built
in this process before the ranks start, so they never run ``nvcc`` at
once.

``--backend auto`` resolves every collective call from a plan
(``--plan``, written by ``repro_torch.launch.tune``, loaded and
fingerprint-checked in every rank; without it each rank loads or tunes
the cached default plan, ``tuner.ensure_default_plan``); each step's
record lists the distinct decisions taken (``choices``).

``--multi-pod`` trains over the hierarchical data axis ``("pod",
"data")`` = (2, DP/2) (``launch.mesh``): every level group has its own
process group and, under ``cxl`` or ``auto``, its own pool, and every
collective over the tuple decomposes against the topology.
``--topology`` (an ``axis:fabric,...`` spec or a JSON file, as in
``launch.tune``) is activated in every rank, and this process warns
about mesh axes it does not cover.  Each step's record holds the pool
bytes of each level and the ledger's wire bytes and calls by level.

``--mesh DPxTP`` with TP > 1 adds the model axis (``launch.mesh``: rank
r at data r // TP, model r % TP): the weights are Megatron-sharded over
it and FSDP-sharded over the data axis, the ranks of one data index take
the same batch rows, and every tensor-parallel AllReduce of the
activations goes through the ``Communicator`` on the model groups' own
process groups and pools.

A grouped topology level (``--topology pod:cxl,data:cxl:3+1``: the 4
data ranks in a group of 3 and a lone rank) keeps the flat data axis and
gives each of its groups of more than one rank, and its group sub-roots,
a process group and a pool of their own (``launch.mesh``); every
collective over it runs the ``Communicator``'s grouped schedules, the
sub-root exchange booked on the parent level.

``--placement auto|PATH`` chooses the mesh from the topology
(``tuner.placement``): the analytic collective mix of the model at the
``--mesh`` degrees is priced on every feasible axis -> level assignment,
the best that keeps ``model`` on one level is applied (its report
printed), and every rank runs on the placed mesh with the placed
topology and the axis aliases of a split axis.  ``--placement-from-
dryrun RECORD`` prices the mix of a dry-run record instead (its
``auto_choices`` audit, ``CollectiveMix.from_dryrun``; a record of
either package's ``launch.dryrun --backend auto``).  ``--xla-overlap``
is refused: XLA flags have no meaning in this package.

A Mixture-of-Experts model (``--arch granite-moe-3b``, ``arctic-480b``)
trains its experts parallel over the model axis: each row's dispatch and
combine are AllToAlls through the ``Communicator`` (``models.moe``), and
the loss adds the routers' auxiliary loss.

The SSM rows (Falcon-Mamba's Mamba-1, Zamba2's Mamba-2) train through
the ``ssm_scan`` kernel and its backward kernel at any ``--mesh``: at tp
> 1 their channels and heads are sharded over the model axis, and a
Mamba-2 row's gated norm sums its squares over it (one more model-level
AllReduce a row, ``models.ssm.gated_norm``), so the model is the same
function at every tp.  Zamba2's shared attention block (``shared_a``) is
gathered as its own FSDP group, once per shared group under
``--prefetch 1`` and at each use under ``--prefetch 0``, its grads
summed over its uses.  Each step's record counts the FSDP gathers by
group (``gathers``).

``--ckpt DIR`` saves the GLOBAL params after the last step, as the
reference launcher does: ``{"params": params}`` at step ``--steps`` in
the reference's checkpoint layout (``training.checkpoint``), the padded
shapes of ``model.abstract_params(cfg, tp)``, assembled in this process
from the ranks' final shards by the run's param specs.  A run of several
variants checkpoints the first one's.

The ranks build their GLOBAL params one at a time (each shards them and
frees the rest before the next rank starts), so a model whose params
fill a fifth of the card still starts on four ranks sharing it.

``--pp-stages S`` (> 1) trains a uniform stack through the microbatch
pipeline (``training.pipeline``), as the reference launcher does: the
ranks of ``--mesh Nx1`` form the rank-major mesh ``(("stage", S),
("data", N / S))``, each stage holds a contiguous slab of the rows
(embedding and final norm replicated), the ranks of one data index take
the same batch rows, split into ``--microbatches`` M, and the
activations and their cotangents hop between stages through
``Communicator.send`` / ``recv`` (the plan's ``p2p`` cells under
``auto``); every level has its own process group and pool.
``--pp-schedule`` and ``--pp-chunks`` validate the schedule and set the
bubble fraction each step reports; the arithmetic does not depend on
them.  Refused with it: a model axis > 1, ``--multi-pod``,
``--placement``, ``--fuse-kernels`` (no FSDP gather to fuse) and a stack
that is not uniform (``models.pipeline_stages.uniform_stage_rows``).
``--ckpt`` saves the GLOBAL params, the stage slabs concatenated.

Observability and online re-tuning (``repro_torch.obs``,
``tuner.online``), as the reference launcher has them:
``--metrics-out`` streams step / retune / health events as JSON-lines
and the final metric registry (+ a Prometheus rendering next to it);
``--trace-out`` keeps a flight recorder of the last ``--trace-steps``
steps of every rank, written as one Chrome trace (one ``pid`` a rank);
rank 0 writes both (``launch.report`` reads them back).
``--timing-source`` picks where measured per-collective times come
from: ``step`` (the step's wall time apportioned over its audit),
``emulator`` (``obs.StepEmulator``, oracle-priced, seeded;
``--emu-degrade`` injects per-level slowdowns) or ``profiler`` (every
collective call timed on the host clock between device syncs,
``core.api.TimedCommunicator``; a step from step 1 on that books no
sample raises).  With ``--online-retune`` (``--backend auto``) every
rank activates the plan in its registry (``--plan`` or the default
plan) and the step resolves through it; each rank runs an
``OnlineTuner`` and at every step boundary the ranks gather every
rank's samples over the world group and fold the same list in the same
order, so every rank refreshes to the same plan at the same boundary
(``--retune-interval``) and bumps its registry to the same epoch (both
checked).  The samples are the union in rank order, not a per-call
maximum: the ranks' audits align on a flat or (data, model) mesh but
not on a grouped level, whose sub-roots call more.  Step 0's samples
reach the flight recorder and not the tuner (it pays first-touch
costs, as the reference's compile step), and no refresh follows the last
step, which no step runs under.  ``--plan-out`` writes the
plan after a final refresh, and beside it (``<base>.timings.json``)
every sample the tuner folded, which ``launch.tune --measurements``
reads.  Each step's record holds this rank's samples, the epoch it ran
under and the epochs its calls resolved at, and a boundary's retune
(epoch, whether the choices changed, the measured regret, the plan's
hash); the run's, the calibration export.  Refused: ``--online-retune``
and a timing source other than ``step`` with ``--pp-stages > 1`` (as
the reference), and the profiler source on a grouped level (one
schedule, two cells).

Resilience (``repro_torch.resilience``), as the reference launcher has
it: ``--fault-plan`` injects a seeded fault schedule (rank deaths, link
degrades through the run's ``StepEmulator``, pool-error windows);
``--pool-ckpt-interval N`` snapshots every rank's shards and AdamW state
into its partition of a pool store every rank maps
(``checkpoint.PoolRegion``: a ``memfd`` pinned on the card, snapshots
device-to-host copies) every N steps; ``--resilience`` runs the detect
-> re-plan -> resume loop after each step: each rank beats its own
heartbeat word, the monitors (one a rank) fold every rank's pool errors
and reach the same verdicts (checked every step, with the recovery
plan's hash), and a confirmed rank death or persistent cxl degrade
hot-swaps the re-plan and rolls every rank, and the data, back to the
newest step every rank committed.  How that differs from the one
process of the reference is in ``_RankResil``.  Refused with
``--pp-stages > 1``: ``--resilience`` and ``--fault-plan`` (as the
reference).  Each step's record holds its ``resilience`` fields (the
snapshot's report, the beats, the pool errors, the verdicts, a
recovery's rollback); the run's, the reference's report (re-plans, dead
ranks, degraded links, faults injected).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import shutil
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs as obs_mod
from repro_torch import tuner
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ledger, tree
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.hw import CXL_POOL, INFINIBAND
from repro_torch.core.pool import (DEFAULT_PARTITION_BYTES, PoolAccessError,
                                   create_backing)
from repro_torch.core.topology import (Topology, get_active_topology,
                                       parse_topology, set_active_topology,
                                       warn_uncovered)
from repro_torch.data.pipeline import SyntheticTokens, local_batch
from repro_torch.kernels import build
from repro_torch.kernels.chunked_reduce import chunked_reduce
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_collectives import all_gather_matmul
from repro_torch.kernels.rmsnorm import rms_norm, rms_norm_vjp
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_vjp
from repro_torch.launch import add_xla_overlap, ranks, refuse_xla_overlap
from repro_torch.launch.mesh import (dp_axes, joint_groups, level_groups,
                                     make_host_mesh, mesh_shape, parse_mesh,
                                     pipeline_shape)
from repro_torch.models import model, pipeline_stages, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.resilience import (RANK_OPS, FailureMonitor, FaultPlan,
                                    ResilienceController, mesh_plan,
                                    mesh_topology)
from repro_torch.training import checkpoint
from repro_torch.training.pipeline import (SCHEDULES, bubble_fraction,
                                           make_schedule,
                                           make_sharded_pipeline_step)
from repro_torch.training.train_loop import (TrainConfig, batch_to_device,
                                             leaf_params,
                                             make_sharded_train_step)
from repro_torch.tuner import runtime as tuner_runtime

KERNEL_COUNTERS = {"rms_norm": rms_norm, "rms_norm_vjp": rms_norm_vjp,
                   "flash_attention": flash_attention,
                   "chunked_reduce": chunked_reduce,
                   "all_gather_matmul": all_gather_matmul,
                   "ssm_scan": ssm_scan, "ssm_scan_vjp": ssm_scan_vjp}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="4x1",
                    help="DPxTP; every rank is a process of this host")
    ap.add_argument("--multi-pod", action="store_true",
                    help="split the data ranks over 2 pods: the data "
                         "axis becomes the tuple (pod, data) = (2, DP/2)")
    ap.add_argument("--topology", default=None,
                    help="'axis:fabric,...' spec (outermost first; "
                         "fabrics: cxl|ib|ici) or a topology JSON file, "
                         "activated in every rank")
    ap.add_argument("--placement", default=None,
                    help="'auto' (rank mesh-axis -> fabric-level "
                         "assignments for this model's collective mix, "
                         "tuner.placement) or a saved placement JSON: the "
                         "mesh the placement chose; needs --topology")
    ap.add_argument("--placement-from-dryrun", default=None,
                    help="a dry-run JSON record (launch.dryrun --backend "
                         "auto): --placement prices its auto_choices "
                         "mix (CollectiveMix.from_dryrun) instead of the "
                         "model's analytic one")
    ap.add_argument("--backend", choices=["ring", "cxl", "auto"],
                    default="ring")
    ap.add_argument("--plan", default=None,
                    help="autotuning plan JSON (repro_torch.launch.tune) "
                         "for --backend auto")
    ap.add_argument("--slicing-factor", type=int, default=4)
    ap.add_argument("--allreduce-mode", default="two_phase",
                    choices=["two_phase", "faithful"])
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation splits; with "
                         "--pp-stages > 1 this is the pipeline "
                         "microbatch count M (bubble fraction "
                         "(S-1)/(M+S-1) under 1F1B)")
    ap.add_argument("--pp-stages", type=int, default=1,
                    help="pipeline stages: > 1 trains on a "
                         "(stage, data) mesh with the microbatch "
                         "pipeline (training.pipeline); activation/"
                         "grad handoffs ride the tuned p2p plan cells "
                         "(cxl pool write + doorbell commit vs direct "
                         "hop)")
    ap.add_argument("--pp-schedule", default="1f1b", choices=SCHEDULES,
                    help="pipeline schedule driving bubble accounting "
                         "and realizability validation (interleaved "
                         "needs microbatches %% stages == 0)")
    ap.add_argument("--pp-chunks", type=int, default=2,
                    help="model chunks per stage under --pp-schedule "
                         "interleaved")
    ap.add_argument("--bucket-mb", type=float, default=25.0)
    ap.add_argument("--prefetch", type=int, default=1, choices=[0, 1])
    ap.add_argument("--fuse-kernels", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="save the final GLOBAL params here (the "
                         "reference's checkpoint layout, step --steps)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--online-retune", action="store_true",
                    help="fold measured collective times back into the "
                         "plan (tuner.online) and hot-swap the refreshed "
                         "plan between steps; requires --backend auto.  "
                         "Samples calibrate only the backend they "
                         "measured: after a boundary that timed only cxl "
                         "calls, ring's candidates keep their raw "
                         "oracle, and the refresh can move cells to a "
                         "backend never timed (on one H100 it moved the "
                         "big cells to gloo, 6.5x slower a step)")
    ap.add_argument("--retune-interval", type=int, default=10,
                    help="steps between plan refresh + hot-swap under "
                         "--online-retune")
    ap.add_argument("--plan-out", default=None,
                    help="persist the measurement-refined plan (format "
                         "v4) here at the end of the run, and its samples "
                         "beside it (<base>.timings.json)")
    ap.add_argument("--metrics-out", default=None,
                    help="write step/retune/health events + the final "
                         "metric registry as JSON-lines here (and a "
                         "Prometheus rendering to <base>.prom)")
    ap.add_argument("--trace-out", default=None,
                    help="flight-recorder Chrome trace JSON of every rank "
                         "(last --trace-steps steps; open in Perfetto)")
    ap.add_argument("--trace-steps", type=int, default=32,
                    help="flight-recorder ring capacity in steps")
    ap.add_argument("--timing-source", default="step",
                    choices=["step", "emulator", "profiler"],
                    help="measured-time source: 'step' apportions the "
                         "step's wall time over its audit; 'emulator' / "
                         "'profiler' give per-collective samples (the "
                         "oracle-priced emulator, or every call timed; "
                         "requires --backend auto)")
    ap.add_argument("--emu-degrade", default=None,
                    help="'key=factor,...' slowdowns for the emulator "
                         "timing source; keys are level axes ('model'), "
                         "fabric kinds ('cxl'), backend-qualified "
                         "'model@cxl', or '*'")
    ap.add_argument("--ewma-decay", type=float, default=0.0,
                    help="per-refresh decay of the online tuner's "
                         "measured EWMAs toward the oracle (requires "
                         "--online-retune)")
    ap.add_argument("--explore-eps", type=float, default=0.0,
                    help="epsilon-greedy re-exploration of measured plan "
                         "cells at refresh (requires --online-retune)")
    ap.add_argument("--resilience", action="store_true",
                    help="run the detect -> re-plan -> resume loop "
                         "(repro_torch.resilience): heartbeat + link-health "
                         "monitoring each step; on a confirmed rank death "
                         "or persistent cxl degrade, hot-swap a survivor/"
                         "failover re-plan and roll every rank back to the "
                         "newest pool snapshot they all committed")
    ap.add_argument("--fault-plan", default=None,
                    help="seeded fault schedule, e.g. 'rank_death@12:rank=5;"
                         "link_degrade@10-18:link=data@cxl,factor=4;"
                         "pool_error@5-7:rate=0.5' (resilience.FaultPlan; "
                         "deaths and pool errors reach heartbeats, the pool "
                         "checkpoint store and the KV tier, not a "
                         "collective's exchange)")
    ap.add_argument("--pool-ckpt-interval", type=int, default=0,
                    help="steps between pool-resident snapshots (training."
                         "checkpoint.PoolCheckpointStore, one partition a "
                         "rank); 0 disables; the resume half of "
                         "--resilience rolls back to the newest step every "
                         "rank committed")
    add_xla_overlap(ap)
    return ap


def tcfg_from_args(args) -> TrainConfig:
    """The reference launcher's TrainConfig (warmup min(20, steps // 5),
    no clipping)."""
    return TrainConfig(lr=args.lr, warmup=min(20, args.steps // 5),
                       total_steps=args.steps, backend=args.backend,
                       slicing_factor=args.slicing_factor,
                       allreduce_mode=args.allreduce_mode,
                       microbatches=args.microbatches, clip_norm=None,
                       bucket_mb=args.bucket_mb, prefetch=args.prefetch,
                       fuse_kernels=args.fuse_kernels, plan_path=args.plan)


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability and online re-tuning of a run (the launcher's
    ``--online-retune`` ... ``--explore-eps``), the same for each of its
    variants."""

    online_retune: bool = False
    retune_interval: int = 10
    timing_source: str = "step"       # "step" | "emulator" | "profiler"
    emu_degrade: tuple = ()           # ((key, factor), ...)
    ewma_decay: float = 0.0
    explore_eps: float = 0.0
    metrics_out: Optional[str] = None
    trace_out: Optional[str] = None
    trace_steps: int = 32
    plan_out: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ResilSpec:
    """Fault injection, recovery and pool snapshots of a run (the
    launcher's ``--fault-plan``, ``--resilience``,
    ``--pool-ckpt-interval``), the same for each of its variants."""

    resilience: bool = False
    fault_plan: Optional[str] = None
    pool_ckpt_interval: int = 0


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """What every rank runs: the model, the data, and one training run
    per TrainConfig in ``variants`` (each from the same params and the
    same batches)."""

    arch: str
    smoke: bool
    variants: tuple
    steps: int
    batch: int
    seq: int
    dp: int
    device: str                       # "cuda" or "cpu"
    tp: int = 1                       # model axis (tensor parallel)
    multi_pod: bool = False           # data axis (pod, data) = (2, dp/2)
    topology: Optional[Topology] = None   # activated in every rank
    shape: Optional[tuple] = None     # the mesh a placement chose
    aliases: Optional[dict] = None    # a placement's axis aliases
    config: Optional[ModelConfig] = None   # in place of the arch's
    params_path: Optional[str] = None  # .npz of GLOBAL params at tp
    capture_grads: bool = False       # return step 0's synced grads
    capture_params: bool = False      # return the params after the run
    ckpt: Optional[str] = None        # save the first variant's final
    #                                   GLOBAL params here, step ``steps``
    profile: bool = False             # the first variant: one more step
    #                                   under the profiler
    timeout_s: float = 600.0
    pp_stages: int = 1                # > 1: the pipeline over (stage,
    #                                   data) = (pp_stages, dp / pp_stages)
    pp_schedule: str = "1f1b"
    pp_chunks: int = 2
    obs: Optional[ObsSpec] = None     # --online-retune, --metrics-out, ...
    resil: Optional[ResilSpec] = None   # --resilience, --fault-plan, ...

    def mesh(self) -> tuple:
        """The rank-major mesh shape every rank builds."""
        if self.pp_stages > 1:
            return pipeline_shape(self.dp, self.pp_stages)
        return self.shape or mesh_shape(self.dp, self.tp, self.multi_pod)

    def data_ranks(self) -> int:
        """The batch's split: the data axis's size (``dp`` counts every
        rank of a pipeline's mesh)."""
        return self.dp // self.pp_stages

    def model_config(self) -> ModelConfig:
        return self.config or get_config(self.arch, smoke=self.smoke)


def load_params_npz(path: str, device, cfg=None, tp: int = 1) -> dict:
    """GLOBAL params from the .npz ``save_params_npz`` writes (the
    reference's params as numpy, made at ``tp``) -> this package's
    params on ``device``; with ``cfg`` their shapes are checked against
    the model's at ``tp`` (``model.params_from_numpy``)."""
    with np.load(path) as f:
        return model.params_from_numpy(tree.from_paths([
            (tuple(k.split("/")), f[k]) for k in f.files]), device, cfg, tp)


def save_params_npz(params, path: str) -> None:
    """Full params (tensors or numpy) -> the .npz ``RunSpec`` reads."""
    np.savez(path, **{"/".join(p): np.asarray(
        x.detach().cpu() if isinstance(x, torch.Tensor) else x)
        for p, x in tree.leaves_with_paths(params)})


def _counters() -> dict:
    return {k: f.launches for k, f in KERNEL_COUNTERS.items()}


def _pool_counts(mesh: dict) -> dict:
    """Bytes this rank published into and retrieved from the pools of
    each level of ``mesh``: an axis's own pool and, on a grouped level,
    the pool of this rank's group (booked to the level) and of the
    sub-roots (booked to the level that carries them, the parent)."""
    out: dict = {}
    for ax in mesh.values():
        subs = [ax] + ([ax.grouped.inner, ax.grouped.cross]
                       if ax.grouped is not None else [])
        for sub in subs:
            if sub is None or sub.pool is None:
                continue
            c = out.setdefault(sub.name, {"published": 0, "retrieved": 0})
            c["published"] += sub.pool.bytes_published
            c["retrieved"] += sub.pool.bytes_retrieved
    return out


def _delta(after: dict, before: dict) -> dict:
    return {name: {k: v - before[name][k] for k, v in c.items()}
            for name, c in after.items()}


def _profile_step(run_step, dev) -> dict:
    """Device time by kernel for one step of this rank, with copies
    (Memcpy) apart from kernels, and the step's wall time.  The profiler
    records the device's activity only: the CPU ops' events add nothing
    to the device times and cost seconds a step to record and fold."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        synchronize(dev)
        t0 = time.perf_counter()
        run_step()
        synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.key, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda kv: -kv[1])
    copies = sum(t for k, t in kern if k.startswith("Memcpy"))
    return {"wall_us": wall_us, "copy_us": copies,
            "kernel_us": sum(t for _, t in kern) - copies,
            "top": [{"kernel": k[:80], "us": t} for k, t in kern[:12]],
            "by_kernel": dict(kern)}


def distinct_choices(audit: list) -> list:
    """The ledger's ``auto_choices`` audit of one step folded into its
    distinct decisions (at a topology level: its axis and fabric), each
    with the number of calls that took it."""
    keys = ("primitive", "msg_bytes", "nranks", "backend",
            "slicing_factor", "allreduce_mode", "overlap", "fused",
            "level", "fabric")
    calls: dict = {}
    for c in audit:
        k = tuple(c[f] for f in keys)
        calls[k] = calls.get(k, 0) + 1
    return [dict(zip(keys, k), calls=n) for k, n in sorted(
        calls.items(), key=lambda kv: tuple("" if v is None else v
                                            for v in kv[0]))]


def plan_sha256(plan) -> str:
    """The hash of a plan's JSON (keys sorted): equal on two ranks iff
    their plans are byte-identical."""
    return hashlib.sha256(json.dumps(plan.to_json(), sort_keys=True)
                          .encode()).hexdigest()


def _gather(obj) -> list:
    """Every rank's ``obj``, in rank order, over the world group."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class _RankObs:
    """One rank's observability and online re-tuning of one variant
    (``RunSpec.obs``): the session (rank 0 writes its files), the timing
    source and the ``OnlineTuner``.  Every rank is fed the same samples
    in the same order at every step boundary (``end_step``), so every
    rank's tuner refreshes to the same plan at the same boundary."""

    def __init__(self, ctx: ranks.RankContext, spec: RunSpec,
                 tcfg: TrainConfig):
        o = spec.obs
        self.o, self.rank = o, ctx.rank
        self.online = None
        self.tcfg = tcfg
        tuner_runtime.clear_link_health()
        if o.online_retune:
            # the reference launcher's plan_path=None: the plan lives in
            # this rank's registry, and the step resolves through it
            if tcfg.plan_path is not None:
                tuner_runtime.activate_plan_file(
                    tcfg.plan_path, pool=CXL_POOL, ib=INFINIBAND)
            base = tuner.ensure_default_plan(topology=get_active_topology())
            self.online = tuner.OnlineTuner(
                base, retune_interval=o.retune_interval,
                decay=o.ewma_decay, explore_eps=o.explore_eps)
            self.tcfg = dataclasses.replace(tcfg, plan_path=None)
        self.sess = None
        if o.metrics_out or o.trace_out:
            self.sess = obs_mod.ObsSession(
                metrics_out=o.metrics_out, trace_out=o.trace_out,
                trace_steps=o.trace_steps,
                log=print if ctx.rank == 0 else None, rank=ctx.rank,
                gather=_gather)
        self.emu = obs_mod.StepEmulator(
            topology=get_active_topology(), noise_std=0.02, seed=0,
            degrade=dict(o.emu_degrade)) \
            if o.timing_source == "emulator" else None
        self.timed = o.timing_source == "profiler"
        self.folded: list = []           # every sample the tuner took
        self.samples = None              # the last step's, for resilience
        self.swaps = 0

    def span(self, i: int):
        return self.sess.step_span(i) if self.sess is not None \
            else contextlib.nullcontext()

    def book(self, i: int, snap: dict) -> list:
        """This rank's samples of step ``i`` (inside its span): the calls
        the profiler source timed, or the emulator's price of each
        audited call (booked into the ledger, so the flight recorder
        takes them; none at step 0, the reference's compile step)."""
        if self.timed:
            return snap["timings"]
        if self.emu is not None and i > 0:
            return self.emu.step_timings(snap["auto_choices"])
        return []

    def end_step(self, i: int, wall_s: float, loss: float, mine: list,
                 snap: dict, epoch: int, last: bool) -> dict:
        """Gather every rank's samples, feed the health monitor and (from
        step 1) the tuner the union in rank order, and retune at the
        boundary (``maybe_retune``; none after the ``last`` step, which
        no step follows: ``--plan-out`` refreshes once more); returns the
        step record's observability fields."""
        audit = snap["auto_choices"]
        got = _gather((mine, wall_s, audit if self.o.timing_source == "step"
                       else None, epoch))
        if len({e for *_, e in got}) != 1:
            raise RuntimeError(f"step {i}: the ranks ran under different "
                               f"plan epochs {[e for *_, e in got]}")
        if self.timed and i > 0:
            empty = [r for r, g in enumerate(got) if not g[0]]
            if empty:
                raise RuntimeError(
                    f"step {i}: the profiler timing source booked no "
                    f"sample on ranks {empty}")
        samples = [t for g in got for t in g[0]]
        wall = max(g[1] for g in got)     # the step ends with its slowest
        per_call = self.o.timing_source != "step"
        # what the failure monitor's link health reads: per-call samples
        # past the first step (the reference's ``step_timings``)
        self.samples = samples if per_call and i > 0 else None
        folded = 0
        if self.online is not None and i > 0:
            if per_call:
                folded = self.online.observe_timings(samples)
                self.folded += samples
            else:
                folded = self.online.observe_step(wall, got[0][2])
        rec = {"timing_samples": len(mine), "audit_calls": len(audit),
               "plan_epoch": epoch,
               "audit_epochs": sorted({c["plan_epoch"] for c in audit},
                                      key=lambda e: -1 if e is None else e),
               "samples_folded": folded, "retune": None}
        if self.sess is not None:
            self.sess.on_step(i, wall, timings=samples if per_call and i > 0
                              else None,
                              extra={"loss": loss, "plan_epoch": epoch,
                                     "rank_samples": len(mine)})
        if self.online is not None and not last:
            rec["retune"] = self._retune(i)
        return rec

    def _retune(self, i: int) -> Optional[dict]:
        online = self.online
        prev = online.plan
        refreshed = online.maybe_retune(i)
        if refreshed is None:
            return None
        swapped = tuner.choices_changed(prev, refreshed)
        self.swaps += swapped
        epoch = tuner_runtime.plan_epoch()
        sha = plan_sha256(refreshed)
        hashes = _gather((epoch, sha))
        if len(set(hashes)) != 1:
            raise RuntimeError(f"step {i}: the ranks refreshed to "
                               f"different plans {hashes}")
        regret = online.measured_regret()
        measured = sum(st.samples > 0 for st in online.stats.values())
        if self.sess is not None:
            self.sess.on_retune(epoch=epoch, swapped=swapped,
                                regret_s=regret, measured_cells=measured)
        drift = obs_mod.calibration_drift(online.calibration_export()) \
            if online.calibration else []
        return {"step": i, "epoch": epoch, "swapped": bool(swapped),
                "regret_s": regret, "measured_cells": measured,
                "plan_sha256": sha, "drift": drift,
                "plan": refreshed.to_json() if self.rank == 0 else None}

    def finish(self, steps: int, wall_s: float) -> dict:
        """The run's end: ``--plan-out`` (rank 0, after a final refresh)
        and its samples, the session's files, the registry cleared."""
        out = {"swaps": self.swaps, "samples_folded": len(self.folded)}
        online, o = self.online, self.o
        if online is not None:
            out["calibration"] = online.calibration_export()
            out["regret_s"] = online.measured_regret()
            out["final_epoch"] = tuner_runtime.plan_epoch()
            if o.plan_out:
                refined = online.refresh()
                out["plan_out_sha256"] = plan_sha256(refined)
                if self.rank == 0:
                    tuner.save_plan(refined, o.plan_out)
                    with open(os.path.splitext(o.plan_out)[0]
                              + ".timings.json", "w") as f:
                        json.dump({"timings": self.folded}, f)
        snap = ledger.snapshot()
        out["ledger"] = {k: snap[k] for k in (
            "wire_bytes", "exposed_bytes", "hidden_bytes",
            "collective_calls", "level_wire_bytes")}
        if self.sess is not None:
            self.sess.finalize(snapshot=snap, extra={
                "steps": int(steps), "wall_s": wall_s,
                "timing_source": o.timing_source,
                **({"calibration": out["calibration"],
                    "regret_s": out["regret_s"]}
                   if online is not None else {})})
        if online is not None:
            tuner_runtime.clear_active_plan()
        return out


def _mem_available_gib() -> Optional[float]:
    """The host's ``MemAvailable`` (GiB), where the kernel reports it."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return None


def _state_tree(params, opt) -> dict:
    """What a pool snapshot holds: this rank's param shards and AdamW
    state (its step count a 1-element tensor)."""
    return {"params": params,
            "opt": {"mu": opt.mu, "nu": opt.nu,
                    "step": torch.tensor([opt.step], dtype=torch.int64)}}


class _RankResil:
    """One rank's fault injection, failure detection, re-planning and
    pool snapshots of one variant (``RunSpec.resil``), in the reference
    launcher's order around each step: ``begin_step`` (the fault plan;
    link degrades reach the run's ``StepEmulator``) before it,
    ``end_step`` (the snapshot, the rank's heartbeat, the controller)
    after it.

    What a run of rank processes changes (ROADMAP queue 3, "differs by
    design"): the fault plan's deaths and pool-error windows reach
    heartbeats, the pool checkpoint store and the KV tier
    (``resilience.RANK_OPS``), never a collective's exchange; each rank
    beats its own word in the region every rank maps
    (``checkpoint.PoolRegion``) and the ranks' pool-error counts are
    summed over the world group before the monitor closes the step, so
    every rank's monitor reaches the same verdicts (checked, with the
    recovery plan's hash); each rank snapshots its own shards into its
    partition, and a recovery rolls every rank back to the newest step
    every partition committed (``common_latest``), the data with it;
    the ranks keep their mesh: the collectives run over the recovery's
    topology at the mesh's shapes (``resilience.mesh_topology``) on the
    recovery plan's cells (``resilience.mesh_plan``), and a confirmed
    dead rank's process goes on as the node that replaced it
    (``FaultPlan.replace``)."""

    def __init__(self, ctx: ranks.RankContext, spec: RunSpec,
                 tcfg: TrainConfig):
        r = spec.resil
        self.r, self.ctx, self.rank = r, ctx, ctx.rank
        self.log = print if ctx.rank == 0 else (lambda *_a, **_k: None)
        self.running = spec.topology      # what the collectives run over
        self.tcfg = tcfg
        self.activated = False
        if r.resilience and tcfg.backend == "auto" \
                and tcfg.plan_path is not None:
            # the plan lives in the registry, where a recovery swaps it
            tuner_runtime.activate_plan_file(tcfg.plan_path, pool=CXL_POOL,
                                             ib=INFINIBAND)
            self.tcfg = dataclasses.replace(tcfg, plan_path=None)
            self.activated = True
        tuner_runtime.clear_rank_liveness()
        self.fp = None
        if r.fault_plan:
            self.fp = FaultPlan.parse(r.fault_plan, ops=RANK_OPS)
            self.fp.install()
        self.region = self.monitor = self.ctl = None
        self.recoveries: list = []

    def open(self, params, opt) -> None:
        """Map the ranks' shared region (rank 0 makes it), sized for the
        largest rank's state in each of two slots, and start the
        monitor over its heartbeat words."""
        r, ctx = self.r, self.ctx
        if not (r.resilience or r.pool_ckpt_interval > 0):
            return
        t0 = time.perf_counter()
        mine = sum(x.numel() * x.element_size()
                   for x in tree.leaves(_state_tree(params, opt)))
        state = max(_gather(mine)) if r.pool_ckpt_interval > 0 else 0
        # two slots, each big enough for image + header slack (the
        # reference launcher's sizing)
        capacity = 2 * (state + (1 << 20)) + 4096
        total = checkpoint.PoolRegion.total_bytes(ctx.nranks, capacity)
        fd = None
        if ctx.rank == 0:
            path, fd = create_backing(total)
            avail = _mem_available_gib()
            self.log(f"pool checkpoints: {ctx.nranks} partitions of "
                     f"{capacity} B ({total / 2**30:.2f} GiB shared); "
                     f"host MemAvailable "
                     f"{'unknown' if avail is None else f'{avail:.1f} GiB'}",
                     flush=True)
        else:
            path = None
        path = _gather(path)[0]
        try:
            self.region = checkpoint.PoolRegion(path, ctx.nranks, ctx.rank,
                                                capacity, ctx.device)
        finally:
            dist.barrier()           # every rank has mapped it
            if fd is not None:
                os.close(fd)
        self.state_bytes, self.capacity = mine, capacity
        self.open_s = time.perf_counter() - t0     # made, mapped, pinned
        if r.resilience:
            self.monitor = FailureMonitor(ctx.nranks,
                                          heartbeats=self.region.heartbeats)
            self.ctl = ResilienceController(self.monitor,
                                            topology=self.running,
                                            log=self.log)
            self.log(f"resilience: monitoring {ctx.nranks} ranks "
                     f"(heartbeat timeout {self.monitor.heartbeat_timeout}, "
                     f"patience {self.monitor.patience})", flush=True)

    def begin_step(self, i: int, emu) -> list:
        """Advance the fault plan (its link degrades reach ``emu``)."""
        if self.fp is None:
            return []
        fresh = [e.describe() for e in self.fp.begin_step(i, emulator=emu)]
        for d in fresh:
            self.log(f"step {i:5d} fault injected: {d}", flush=True)
        return fresh

    def end_step(self, i: int, data_step: int, params, opt,
                 timings: Optional[list]) -> tuple:
        """The snapshot (every ``--pool-ckpt-interval`` steps), the
        rank's heartbeat and the controller's verdict.  Returns (the
        step record's resilience fields, the applied ``RecoveryPlan`` or
        None)."""
        r = self.r
        rec: dict = {}
        if r.pool_ckpt_interval > 0 and i % r.pool_ckpt_interval == 0:
            t0 = time.perf_counter()
            try:
                rep = self.region.store.snapshot(
                    i, _state_tree(params, opt),
                    meta={"data_step": data_step})
                rec["snapshot"] = {**rep, "seconds":
                                   time.perf_counter() - t0}
            except PoolAccessError as e:
                # persists past the retry budget: the previous committed
                # snapshot stays restorable
                if self.monitor is not None:
                    self.monitor.record_pool_error(i)
                rec["snapshot_error"] = str(e)
        if self.ctl is None:
            return rec, None
        mon = self.monitor
        landed = mon.pulse(self.rank, i)
        own = mon.pool_errors_step
        got = _gather((own, landed))
        # every rank's monitor folds every rank's pool errors (after the
        # gather, every rank's beat of this step has landed or failed)
        folded = sum(g[0] for g in got)
        mon.pool_errors_step = folded
        rp = self.ctl.step(i, timings=timings, pulse=False)
        verdicts = [[f.kind, f.rank, f.link, f.step]
                    for f in mon.failures if f.step == i]
        mine = (verdicts, plan_sha256(rp.plan) if rp is not None else None,
                rp.describe() if rp is not None else None)
        every = _gather(mine)
        if any(g != every[0] for g in every):
            raise RuntimeError(f"step {i}: the ranks' verdicts differ: "
                               f"{every}")
        rec.update({"pool_errors": own,
                    "pool_errors_folded": folded,
                    "pulses_landed": [g[1] for g in got],
                    "verdicts": verdicts,
                    # the samples the monitor took (the same on every rank)
                    "timings": timings if self.rank == 0 else None})
        if rp is not None:
            rec["recovery"] = {"reason": rp.reason, "plan_sha256": mine[1]}
        return rec, rp

    def recover(self, i: int, rp, params, opt) -> tuple:
        """Apply ``rp`` on the mesh the ranks keep and roll every rank
        back to the newest step every rank committed.  Returns (the
        recovery record, the restored AdamW state or None, the data step
        the restored snapshot had consumed or None)."""
        if self.running is not None:
            self.running = mesh_topology(rp.topology, self.running)
            set_active_topology(self.running)
            if self.tcfg.backend == "auto":
                tuner_runtime.set_active_plan(
                    mesh_plan(rp.plan, rp.topology, self.running))
        dead = self.monitor.dead_ranks()
        if self.fp is not None:
            for d in dead:
                self.fp.replace(d)
        store = self.region.store if self.r.pool_ckpt_interval > 0 else None
        snap = store.common_latest() if store is not None else None
        died = {f.rank for f in rp.failures if f.kind == "rank_death"}
        fault_steps = [e.step for e in (self.fp.events if self.fp else ())
                       if e.kind == "rank_death" and e.rank in died]
        rec = {"step": i, "reason": rp.reason, "dead_ranks": dead,
               "topology": rp.topology.to_json(),
               "running_topology": None if self.running is None
               else self.running.to_json(),
               "snapshot_step": snap,
               "committed_by_rank": [store.committed(k) for k in
                                     range(self.ctx.nranks)]
               if store is not None else None,
               "steps_lost": self.ctl.steps_lost(min(fault_steps), i, snap)
               if fault_steps else None,
               "plan_epoch": tuner_runtime.plan_epoch(),
               "plan": rp.plan.to_json() if self.rank == 0 else None}
        new_opt = data_step = None
        if snap is not None:
            t0 = time.perf_counter()
            state = _state_tree(params, opt)
            restored, meta = store.restore(state, step=snap, out=state)
            new_opt = AdamWState(step=int(restored["opt"]["step"][0]),
                                 mu=opt.mu, nu=opt.nu)
            data_step = int(meta["data_step"])
            rec["restore_seconds"] = time.perf_counter() - t0
            self.log(f"step {i:5d} resume: rolled back to pool snapshot "
                     f"step {snap} ({i - snap} steps of rollback)",
                     flush=True)
        self.recoveries.append(rec)
        return rec, new_opt, data_step

    def finish(self, spec: RunSpec) -> dict:
        """The run's report (the reference's: re-plans, dead ranks,
        degraded links, faults injected), the fault hook removed, the
        region unmapped, the registry and the spec's topology restored."""
        out: dict = {"recoveries": self.recoveries}
        if self.fp is not None:
            self.fp.uninstall()
            out["faults_injected"] = [[s, d] for s, d in self.fp.injected]
        if self.ctl is not None:
            rep = self.ctl.report()
            out.update(replans=rep["replans"],
                       dead_ranks=rep["monitor"]["dead_ranks"],
                       degraded_links=rep["monitor"]["degraded_links"],
                       failures=rep["monitor"]["failures"])
        if self.region is not None:
            t0 = time.perf_counter()
            self.region.close()
            out.update(state_bytes=self.state_bytes,
                       capacity_bytes=self.capacity, open_s=self.open_s,
                       close_s=time.perf_counter() - t0)
        tuner_runtime.clear_rank_liveness()
        if self.activated or self.recoveries:
            tuner_runtime.clear_active_plan()
        set_active_topology(spec.topology)
        return out


def _rank_run(ctx: ranks.RankContext, specs: Sequence[RunSpec],
              after: Optional[tuple] = None) -> list:
    """Every spec's variants on this rank, spec after spec; then, with
    ``after`` = (fn, args), ``fn(ctx, *args)``'s result as the last
    entry."""
    out = []
    for spec in specs:
        set_active_topology(spec.topology)
        sharding.set_axis_aliases(spec.aliases or {})
        out.append([_run_variant(
            ctx, spec, tcfg, profile=spec.profile and k == 0,
            stage=spec.ckpt is not None and k == 0)
            for k, tcfg in enumerate(spec.variants)])
    if after is not None:
        set_active_topology(None)
        sharding.set_axis_aliases({})
        out.append(after[0](ctx, *after[1]))
    return out


def _local_params(ctx: ranks.RankContext, spec: RunSpec, cfg, shard
                  ) -> dict:
    """This rank's shards of the GLOBAL params (seed 0 or the .npz; its
    ``shard(full)``), as leaves that require grad.  The ranks take
    turns: each builds the GLOBAL params, keeps its shards and frees the
    rest before the next one starts, so only one GLOBAL copy is alive at
    a time."""
    dev = ctx.device
    params = None
    for turn in range(ctx.nranks):
        if turn == ctx.rank:
            if spec.params_path is not None:
                full = load_params_npz(spec.params_path, dev, cfg, spec.tp)
            else:
                full = model.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0), dev,
                    tp=spec.tp)
            params = leaf_params(shard(full))
            del full
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
        dist.barrier()
    return params


def _layout(pspecs, pc, tp: int, stage_axis: Optional[str] = None) -> dict:
    """Where this rank's shards sit in the GLOBAL params: the spec of
    every leaf, the axes they name, and this rank's indices on them (a
    pipeline's: its stage slab, on ``stage_axis``)."""
    dp = pc.dp_axis
    return {"specs": {"/".join(p): s
                      for p, s in tree.leaves_with_paths(pspecs)},
            "dp_axis": sharding.resolve_axis(dp),
            "tp_axis": sharding.resolve_axis("model"),
            "stage_axis": stage_axis,
            "dp_index": pc.comm.axis_index(dp) if dp is not None else 0,
            "n_dp": pc.comm.axis_size(dp) if dp is not None else 1,
            "stage_index": pc.comm.axis_index(stage_axis)
            if stage_axis is not None else 0,
            "n_stage": pc.comm.axis_size(stage_axis)
            if stage_axis is not None else 1,
            "tp_index": pc.tp_index(), "tp": tp}


def _stage_dir(ckpt: str, rank: int) -> str:
    """Where a rank leaves its final shards for the checkpoint: a
    directory beside the steps that ``checkpoint.latest_step`` never
    takes for one."""
    return os.path.join(ckpt, ".rank_shards", f"rank{rank}")


def _stage_shards(params, ckpt: str, rank: int) -> None:
    """Write this rank's final shards as one ``.npy`` a leaf (read back
    memory-mapped by :func:`_staged_shards`): shards of GBs pickled
    through the result queue move at tens of MB/s."""
    d = _stage_dir(ckpt, rank)
    os.makedirs(d, exist_ok=True)
    for i, (_, x) in enumerate(tree.leaves_with_paths(params)):
        np.save(os.path.join(d, f"a{i}.npy"), x.detach().cpu().numpy())


def _staged_shards(ckpt: str, rank: int, paths: Sequence[str]) -> dict:
    d = _stage_dir(ckpt, rank)
    return {p: np.load(os.path.join(d, f"a{i}.npy"), mmap_mode="r")
            for i, p in enumerate(paths)}


def assemble_params(shards: Sequence[dict], layouts: Sequence[dict]) -> dict:
    """The GLOBAL params (numpy, ``model.abstract_params(cfg, tp)``'s
    shapes) from every rank's shards (path -> array) and layouts
    (``_layout``): a leaf concatenates its data shards along its dp dim,
    its model shards along its model dim and a pipeline's stage slabs
    along its row dim, the inverse of ``sharding.shard_params``; a
    replicated leaf is a copy of rank 0's (the shards may be
    memory-mapped files)."""
    by_index: dict = {}
    for sh, lay in zip(shards, layouts):
        by_index.setdefault((lay.get("stage_index", 0), lay["dp_index"],
                             lay["tp_index"]), sh)
    lay = layouts[0]
    out = []
    for key, spec in lay["specs"].items():
        tdim = spec.index(lay["tp_axis"]) \
            if lay["tp"] > 1 and lay["tp_axis"] in spec else None
        ddim = spec.index(lay["dp_axis"]) if lay["dp_axis"] in spec \
            else None
        stage = lay.get("stage_axis")
        sdim = spec.index(stage) if stage is not None and stage in spec \
            else None
        slabs = []
        for s in range(lay["n_stage"] if sdim is not None else 1):
            cols = []
            for t in range(lay["tp"] if tdim is not None else 1):
                parts = [by_index[s, d, t][key] for d in range(
                    lay["n_dp"] if ddim is not None else 1)]
                cols.append(np.concatenate(parts, ddim) if ddim is not None
                            else parts[0])
            slabs.append(np.concatenate(cols, tdim) if tdim is not None
                         else cols[0])
        out.append((tuple(key.split("/")),
                    np.concatenate(slabs, sdim) if sdim is not None
                    else np.array(slabs[0])))
    return tree.from_paths(out)


def _run_variant(ctx: ranks.RankContext, spec: RunSpec, tcfg: TrainConfig,
                 profile: bool = False, stage: bool = False):
    """One training run on this rank: the params (seed 0 or the .npz)
    sharded over the model axis and for FSDP, AdamW from zero,
    ``spec.steps`` steps (at most the variant's ``total_steps``) on this
    rank's data index's slice of the synthetic batches; with
    ``spec.capture_params`` the final param shards, with ``stage`` the
    same written for the checkpoint (``_stage_shards``), each with their
    layout; with ``profile`` one more step under the profiler; with
    ``spec.obs`` observed and re-tuned (``_RankObs``)."""
    dev = ctx.device
    cfg = spec.model_config()
    obs = _RankObs(ctx, spec, tcfg) if spec.obs is not None else None
    if obs is not None:
        tcfg = obs.tcfg
    res = _RankResil(ctx, spec, tcfg) if spec.resil is not None else None
    if res is not None:
        tcfg = res.tcfg
    mesh = make_host_mesh(spec.mesh(), ctx, pools=tcfg.backend != "ring",
                          topology=spec.topology)
    stage_axis = None
    if spec.pp_stages > 1:
        stage_axis = "stage"
        step, pspecs, pc = make_sharded_pipeline_step(
            cfg, tcfg, mesh, n_microbatches=tcfg.microbatches,
            stage_axis=stage_axis, schedule=spec.pp_schedule,
            n_chunks=spec.pp_chunks)
        dp_index = pc.comm.axis_index("data")

        def shard(full):
            return sharding.shard_params(
                full, pspecs, stage_axis, pc.comm.axis_index(stage_axis),
                spec.pp_stages)
    else:
        step, pspecs, pc = make_sharded_train_step(
            cfg, tcfg, mesh, dp_axis=dp_axes(mesh),
            timed=obs is not None and obs.timed)
        dp_index = pc.comm.axis_index(pc.dp_axis)

        def shard(full):
            return sharding.shard_params(
                full, pspecs, pc.dp_axis, dp_index,
                pc.comm.axis_size(pc.dp_axis), tp_axis="model",
                tp_rank=pc.tp_index(), tp=spec.tp)
    t_init = time.perf_counter()
    params = _local_params(ctx, spec, cfg, shard)
    init_s = time.perf_counter() - t_init
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    opt = adamw_init(params)
    batches = SyntheticTokens(cfg, batch=spec.batch, seq=spec.seq)
    data = iter(batches)
    pos = 0                           # the index of the batch data yields
    if res is not None:
        res.open(params, opt)
    out = {"steps": [], "grads": None, "params": None, "layout": None,
           "profile": None, "init_s": init_s, "capture_s": 0.0}

    def to_dev(b):
        """This rank's rows on the device."""
        return batch_to_device(local_batch(b, dp_index, spec.data_ranks()),
                               dev)

    t_run = time.perf_counter()
    n_steps = min(spec.steps, tcfg.total_steps)
    for i in range(n_steps):
        fresh = res.begin_step(i, obs.emu if obs is not None else None) \
            if res is not None else None
        gb, data_step = next(data), pos
        pos += 1
        batch = to_dev(gb)
        for f in KERNEL_COUNTERS.values():
            f.launches = 0
        chunked_reduce.launches_by_n = {}
        step.gathers.clear()
        ledger.reset()
        pool_before = _pool_counts(mesh)
        epoch = tuner_runtime.plan_epoch() if obs is not None else None
        with obs.span(i) if obs is not None else contextlib.nullcontext():
            synchronize(dev)
            t_start, t0 = time.time(), time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            loss = float(metrics["loss"])
            synchronize(dev)
            step_s = time.perf_counter() - t0
            snap = ledger.snapshot()
            mine = obs.book(i, snap) if obs is not None else None
        by_level = _delta(_pool_counts(mesh), pool_before)
        rec = {"loss": loss, "step_s": step_s,
               "t_start": t_start, "t_end": time.time(),
               "lr": metrics["lr"], "launches": _counters(),
               "bubble_fraction": metrics.get("bubble_fraction"),
               "chunked_reduce_by_n": dict(chunked_reduce.launches_by_n),
               "gathers": dict(step.gathers),
               "wire_bytes": snap["wire_bytes"],
               "fused_bytes": snap["fused_bytes"],
               "level_wire_bytes": snap["level_wire_bytes"],
               "level_counts": snap["level_counts"],
               "choices": distinct_choices(snap["auto_choices"]),
               "fallbacks": len(snap["fallbacks"]),
               "moe_dropped": int(metrics["moe_dropped"]),
               "moe_assigned": metrics["moe_assigned"],
               "pool_by_level": by_level,
               "pool_bytes": sum(v for c in by_level.values()
                                 for v in c.values())}
        if obs is not None:
            rec["obs"] = obs.end_step(i, step_s, loss, mine, snap, epoch,
                                      last=i == n_steps - 1)
        if res is not None:
            rec["data_step"] = data_step
            rec["faults"] = fresh
            rec["resilience"], rp = res.end_step(
                i, data_step, params, opt,
                obs.samples if obs is not None else None)
            if rp is not None:
                rollback, new_opt, restored = res.recover(i, rp, params, opt)
                rec["resilience"]["rollback"] = rollback
                if new_opt is not None:
                    opt = new_opt
                    # the data rolls back with the state: the next step
                    # replays the batch after the snapshot's
                    data = iter(batches)
                    for _ in range(restored + 1):
                        next(data)
                    pos = restored + 1
                # rebuild the step, as the reference re-traces it: auto
                # resolves through the recovery plan the registry serves
                step, pspecs, pc = make_sharded_train_step(
                    cfg, tcfg, mesh, dp_axis=dp_axes(mesh),
                    timed=obs is not None and obs.timed)
                if obs is not None and obs.online is not None:
                    # restart measured feedback from the recovery plan
                    o = spec.obs
                    obs.online = tuner.OnlineTuner(
                        tuner_runtime.get_active_plan(),
                        retune_interval=o.retune_interval,
                        decay=o.ewma_decay, explore_eps=o.explore_eps)
        out["steps"].append(rec)
        if spec.capture_grads and i == 0:
            out["grads"] = {"/".join(p): x.grad.detach().cpu().numpy()
                            for p, x in tree.leaves_with_paths(params)}
    if obs is not None:
        out["obs"] = obs.finish(n_steps, time.perf_counter() - t_run)
    if res is not None:
        out["resilience"] = res.finish(spec)
    if spec.capture_params or stage:
        t_cap = time.perf_counter()
        if spec.capture_params:
            out["params"] = {"/".join(p): x.detach().cpu().numpy()
                             for p, x in tree.leaves_with_paths(params)}
        if stage:
            _stage_shards(params, spec.ckpt, ctx.rank)
        out["layout"] = _layout(pspecs, pc, spec.tp, stage_axis)
        out["capture_s"] = time.perf_counter() - t_cap
    if profile and dev.type == "cuda":
        batch = to_dev(next(data))
        out["profile"] = _profile_step(
            lambda: step(params, opt, batch), dev)
    if dev.type == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) \
            / 2**30
    del params, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def pool_window(cfg) -> int:
    """Pool partition per rank: 256 MiB, or the model's whole params
    (plus a page) when they are smaller, since no collective of a step
    moves more; larger calls stream through the partition in rounds."""
    abstract = model.abstract_params(cfg)
    total = sum(x.numel() * x.element_size() for x in tree.leaves(abstract))
    return min(DEFAULT_PARTITION_BYTES, total + 4096)


def run_ranks(spec: RunSpec) -> list:
    """Spawn ``spec.dp * spec.tp`` ranks, run every variant, and merge
    the ranks' records: one dict per variant with the per-step loss (rank
    0's; the loss is the dp mean, the same on every rank), the slowest
    rank's step time, the pool bytes and kernel launches summed over
    ranks (and the fewest launches of any rank), and (``capture_grads``,
    ``capture_params``) every rank's step-0 synced grad shards and its
    final param shards.  With ``ckpt`` the first variant's final GLOBAL
    params are saved there (``assemble_params``), and its record holds
    them (``global_params``), the checkpoint's path (``ckpt``) and the
    seconds the assembly and the save took (``assemble_s``,
    ``save_s``).  Every record holds the seconds of the spawn (ranks
    started, all variants run, results back: ``spawn_s``) and the
    slowest rank's seconds building its params (``init_s``) and copying
    them out (``capture_s``)."""
    return run_many([spec])[0]


def _spawn_groups(spec: RunSpec) -> tuple:
    """What a spawn of the ranks creates for ``spec``: the device, the
    rank count, the level groups (each a process group and a pool), the
    poolless joint groups and whether the world has a pool."""
    shape = spec.mesh()
    nranks = spec.dp * spec.tp
    return (spec.device, nranks, tuple(level_groups(shape, spec.topology)),
            tuple(joint_groups(shape)),
            any(n == nranks for _, n in shape))


def run_many(specs: Sequence[RunSpec], after: Optional[tuple] = None
             ) -> list:
    """:func:`run_ranks` of several specs on ONE spawn of the ranks: the
    specs (models, params, variants, steps) run in turn in the same rank
    processes, so the ranks start once.  They must share the device and
    the spawn's rank groups (:func:`_spawn_groups`); each activates its
    own topology, axis aliases and mesh, whose axes may be named
    otherwise (a (stage, data) pipeline rides a (data, model) spawn of
    the same sizes).  The pools take the largest partition any spec asks
    for.  Returns each spec's records, as :func:`run_ranks` returns them
    (``spawn_s`` the one spawn's).  ``after`` = (fn, args), a
    module-level ``fn(ctx, *args)``, runs on every rank after the specs
    (no topology active), in the same processes and rank groups; its
    results, in rank order, follow the specs' records as one more
    entry."""
    first = specs[0]
    if any(_spawn_groups(sp) != _spawn_groups(first) for sp in specs):
        raise ValueError("run_many: the specs must share the device and "
                         "the ranks' groups")
    if first.device == "cuda":
        resolve_device("cuda")        # raises without a card
        build.build_all()             # once, before the ranks start
    windows = [pool_window(sp.model_config()) for sp in specs
               if any(t.backend != "ring" for t in sp.variants)]
    device, nranks, groups, joint, world_pool = _spawn_groups(first)
    t_spawn = time.perf_counter()
    per_rank = ranks.spawn(
        _rank_run, nranks, (tuple(specs), after), device=device,
        partition_bytes=max(windows, default=0), groups=list(groups),
        poolless=list(joint), world_pool=world_pool,
        timeout_s=max(sp.timeout_s for sp in specs),
        wait_s=sum(sp.timeout_s * (1 + len(sp.variants) * (sp.steps + 1))
                   for sp in specs))
    spawn_s = time.perf_counter() - t_spawn
    out = []
    for i, spec in enumerate(specs):
        mine = [r[i] for r in per_rank]
        saved = None
        if spec.ckpt is not None:
            saved = _save_ckpt(spec, [r[0]["layout"] for r in mine], nranks)
        runs = [_merge([r[v] for r in mine], tcfg)
                for v, tcfg in enumerate(spec.variants)]
        for run in runs:
            run["spawn_s"] = spawn_s
        if saved is not None:
            runs[0].update(saved)
        out.append(runs)
    if after is not None:
        out.append([r[-1] for r in per_rank])
    return out


def _save_ckpt(spec: RunSpec, layouts: list, nranks: int) -> dict:
    """The first variant's final GLOBAL params, assembled from the
    ranks' staged shards, saved to ``spec.ckpt`` at step ``spec.steps``
    (the staging directory removed)."""
    t0 = time.perf_counter()
    paths = list(layouts[0]["specs"])
    params = assemble_params(
        [_staged_shards(spec.ckpt, k, paths) for k in range(nranks)],
        layouts)
    shutil.rmtree(os.path.dirname(_stage_dir(spec.ckpt, 0)))
    t1 = time.perf_counter()
    path = checkpoint.save(spec.ckpt, spec.steps, {"params": params})
    which = f" (the first of {len(spec.variants)} variants)" \
        if len(spec.variants) > 1 else ""
    print(f"saved {path}{which}", flush=True)
    return {"ckpt": path, "global_params": params, "assemble_s": t1 - t0,
            "save_s": time.perf_counter() - t1}


def _merge(per_rank: list, tcfg: TrainConfig) -> dict:
    steps = []
    for i, rec0 in enumerate(per_rank[0]["steps"]):
        recs = [r["steps"][i] for r in per_rank]
        # a grouped level's sub-root pool lives on its sub-roots only
        levels = sorted({name for r in recs for name in r["pool_by_level"]})
        steps.append({
            "loss": rec0["loss"], "lr": rec0["lr"],
            "bubble_fraction": rec0["bubble_fraction"],
            "step_s": max(r["step_s"] for r in recs),
            "t_start": min(r["t_start"] for r in recs),
            "t_end": max(r["t_end"] for r in recs),
            "pool_bytes": sum(r["pool_bytes"] for r in recs),
            "pool_by_level": {
                name: {k: sum(r["pool_by_level"].get(name, {}).get(k, 0)
                              for r in recs)
                       for k in ("published", "retrieved")}
                for name in levels},
            "launches": {k: sum(r["launches"][k] for r in recs)
                         for k in KERNEL_COUNTERS},
            "launches_min_rank": {k: min(r["launches"][k] for r in recs)
                                  for k in KERNEL_COUNTERS},
            "launches_per_rank": [r["launches"] for r in recs],
            "fallbacks": sum(r["fallbacks"] for r in recs),
            # each rank routes its own tokens: the batch's pairs
            "moe_dropped": sum(r["moe_dropped"] for r in recs),
            "moe_assigned": sum(r["moe_assigned"] for r in recs),
            "chunked_reduce_by_n_per_rank": [r["chunked_reduce_by_n"]
                                             for r in recs],
            "gathers_rank0": rec0["gathers"],
            "wire_bytes_rank0": rec0["wire_bytes"],
            "fused_bytes_rank0": rec0["fused_bytes"],
            "level_wire_bytes_rank0": rec0["level_wire_bytes"],
            "level_counts_rank0": rec0["level_counts"],
            "choices_rank0": rec0["choices"]})
    if per_rank[0]["steps"] and "obs" in per_rank[0]["steps"][0]:
        for i, s in enumerate(steps):
            recs = [r["steps"][i]["obs"] for r in per_rank]
            s["obs_per_rank"] = [{k: v for k, v in o.items() if k != "retune"}
                                 for o in recs]
            s["retune_per_rank"] = [None if o["retune"] is None else {
                k: v for k, v in o["retune"].items() if k != "plan"}
                for o in recs]
            s["retune_rank0"] = recs[0]["retune"]
    if per_rank[0]["steps"] and "resilience" in per_rank[0]["steps"][0]:
        for i, s in enumerate(steps):
            recs = [r["steps"][i] for r in per_rank]
            s["data_step"] = recs[0]["data_step"]
            s["faults"] = recs[0]["faults"]
            s["resilience_per_rank"] = [r["resilience"] for r in recs]
    out = {"backend": tcfg.backend, "fuse_kernels": tcfg.fuse_kernels,
           "microbatches": tcfg.microbatches, "prefetch": tcfg.prefetch,
           "steps": steps,
           "init_s": max(r["init_s"] for r in per_rank),
           "capture_s": max(r["capture_s"] for r in per_rank)}
    for key in ("grads", "params"):
        if per_rank[0][key] is not None:
            out[key] = [r[key] for r in per_rank]
    if per_rank[0].get("peak_memory_gib") is not None:
        out["peak_memory_gib"] = [r["peak_memory_gib"] for r in per_rank]
    if per_rank[0]["profile"] is not None:
        out["profile"] = [r["profile"] for r in per_rank]
    if "obs" in per_rank[0]:
        out["obs"] = per_rank[0]["obs"]
        out["obs_per_rank"] = [r["obs"] for r in per_rank]
    if "resilience" in per_rank[0]:
        out["resilience"] = per_rank[0]["resilience"]
        out["resilience_per_rank"] = [r["resilience"] for r in per_rank]
    return out


def choose_placement(args, topology: Topology, dp: int, tp: int) -> tuple:
    """``--placement``'s choice, as the reference launcher makes it: the
    model's analytic mix at the ``--mesh`` degrees, ranked on
    ``topology`` (``auto``) or loaded from a saved placement, and the
    best entry that keeps ``model`` on one level.  Returns (chosen
    placement, mix, placement plan)."""
    if args.placement_from_dryrun:
        with open(args.placement_from_dryrun) as f:
            record = json.load(f)
        mix = tuner.CollectiveMix.from_dryrun(record,
                                              {"data": dp, "model": tp})
    else:
        mix = tuner.CollectiveMix.for_model(
            get_config(args.arch, smoke=args.smoke),
            {"data": dp, "model": tp}, seq=args.seq,
            batch_per_rank=max(1, args.batch // max(1, dp)))
    pplan = tuner.plan_placement(mix, topology) \
        if args.placement == "auto" else tuner.load_placement(args.placement)
    return pplan.best_with_unsplit(("model",)), mix, pplan


def check_pipeline_args(args, dp: int, tp: int) -> None:
    """``--pp-stages > 1``'s refusals: what the reference launcher
    refuses with it (``--placement``, ``--online-retune``, the per-call
    timing sources, ``--resilience``, ``--fault-plan``), what the
    pipeline path cannot take (a model axis, ``--multi-pod``, a stack
    that is not uniform: ``uniform_stage_rows``' errors), ``--fuse-
    kernels`` (no FSDP gather to fuse), a stage count that does not
    divide the ranks and a schedule that cannot be realised."""
    pp = args.pp_stages
    for on, flag in ((args.placement, "--placement"),
                     (args.placement_from_dryrun, "--placement-from-dryrun"),
                     (args.multi_pod, "--multi-pod"),
                     (args.online_retune, "--online-retune"),
                     (args.resilience, "--resilience"),
                     (args.fault_plan, "--fault-plan"),
                     (args.timing_source != "step",
                      "--timing-source emulator/profiler")):
        if on:
            raise SystemExit(f"{flag} is not supported with --pp-stages > "
                             f"1 (plain pipeline training path only)")
    if args.fuse_kernels:
        raise SystemExit("--fuse-kernels has nothing to fuse with "
                         "--pp-stages > 1: the pipeline path gathers no "
                         "FSDP shards")
    if tp > 1:
        raise SystemExit(f"--pp-stages > 1 trains over (stage, data): "
                         f"the model axis must be 1, got --mesh {args.mesh}")
    try:
        pipeline_shape(dp, pp)
        pipeline_stages.uniform_stage_rows(
            get_config(args.arch, smoke=args.smoke), pp)
        make_schedule(args.pp_schedule, pp, args.microbatches,
                      args.pp_chunks)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from None


def resil_from_args(args) -> Optional[ResilSpec]:
    """The run's ``ResilSpec`` (None when no flag of it is given); the
    fault plan is parsed here, so a bad spec fails before a rank
    starts."""
    if args.pool_ckpt_interval < 0:
        raise SystemExit("--pool-ckpt-interval must be >= 0")
    if args.fault_plan:
        try:
            FaultPlan.parse(args.fault_plan)
        except ValueError as e:
            raise SystemExit(f"--fault-plan: {e}") from None
    if not (args.resilience or args.fault_plan or args.pool_ckpt_interval):
        return None
    return ResilSpec(resilience=args.resilience,
                     fault_plan=args.fault_plan or None,
                     pool_ckpt_interval=args.pool_ckpt_interval)


def obs_from_args(args, topology: Optional[Topology]) -> Optional[ObsSpec]:
    """The run's ``ObsSpec`` (None when no flag of it is given), with the
    reference launcher's refusals."""
    if args.online_retune and args.backend != "auto":
        raise SystemExit("--online-retune requires --backend auto")
    if (args.ewma_decay or args.explore_eps) and not args.online_retune:
        raise SystemExit("--ewma-decay/--explore-eps tune the online "
                         "tuner; add --online-retune")
    if args.timing_source != "step" and args.backend != "auto":
        raise SystemExit("--timing-source emulator/profiler needs the "
                         "--backend auto audit to key samples to plan "
                         "cells")
    if args.retune_interval < 1:
        raise SystemExit("--retune-interval must be >= 1")
    if args.timing_source == "profiler" and topology is not None and any(
            lv.grouped for lv in topology.levels):
        raise SystemExit("--timing-source profiler cannot time a grouped "
                         "(ragged) level: its schedule runs two plan cells "
                         "in one region")
    degrade = []
    for part in (args.emu_degrade or "").split(","):
        if part.strip():
            k, _, v = part.partition("=")
            degrade.append((k.strip(), float(v)))
    if not (args.online_retune or args.metrics_out or args.trace_out
            or args.plan_out or args.timing_source != "step"):
        return None
    return ObsSpec(online_retune=args.online_retune,
                   retune_interval=args.retune_interval,
                   timing_source=args.timing_source,
                   emu_degrade=tuple(degrade), ewma_decay=args.ewma_decay,
                   explore_eps=args.explore_eps,
                   metrics_out=args.metrics_out, trace_out=args.trace_out,
                   trace_steps=args.trace_steps, plan_out=args.plan_out)


def spec_from_args(args) -> RunSpec:
    """The run the launcher's flags describe (one variant); with
    ``--placement`` the placed mesh, topology and axis aliases; with
    ``--pp-stages > 1`` the pipeline over (stage, data)."""
    dp, tp = parse_mesh(args.mesh)
    if args.pp_stages < 1:
        raise SystemExit("--pp-stages must be >= 1")
    data = dp
    if args.pp_stages > 1:
        check_pipeline_args(args, dp, tp)
        data = dp // args.pp_stages
    if args.batch % (data * args.microbatches):
        raise SystemExit(f"--batch {args.batch} must split over {data} "
                         f"data ranks x {args.microbatches} microbatches")
    mesh_shape(dp, tp, args.multi_pod)         # odd DP with --multi-pod
    refuse_xla_overlap(args)
    if args.placement_from_dryrun and not args.placement:
        raise SystemExit("--placement-from-dryrun feeds the placement "
                         "planner; add --placement auto")
    topology = parse_topology(args.topology) if args.topology else None
    placed: dict = {}
    if args.placement:
        if topology is None:
            raise SystemExit("--placement requires --topology")
        if args.multi_pod:
            raise SystemExit("--placement chooses the mesh: drop "
                             "--multi-pod")
        chosen, mix, pplan = choose_placement(args, topology, dp, tp)
        print(tuner.format_report(pplan, chosen=chosen), flush=True)
        sizes, names, aliases = tuner.mesh_spec(chosen, mix, topology)
        topology = tuner.placed_topology(chosen, topology)
        placed = dict(shape=tuple(zip(names, sizes)), aliases=aliases)
    obs = obs_from_args(args, topology)
    resil = resil_from_args(args)
    return RunSpec(arch=args.arch, smoke=args.smoke,
                   variants=(tcfg_from_args(args),), steps=args.steps,
                   batch=args.batch, seq=args.seq, dp=dp, tp=tp,
                   device=resolve_device(args.device).type,
                   multi_pod=args.multi_pod, topology=topology,
                   ckpt=args.ckpt, pp_stages=args.pp_stages,
                   pp_schedule=args.pp_schedule, pp_chunks=args.pp_chunks,
                   obs=obs, resil=resil, **placed)


def print_obs(run: dict, o: ObsSpec) -> None:
    """The observed run's samples and epochs a step, its retunes, the
    learned calibration and the measured regret."""
    for i, s in enumerate(run["steps"]):
        ob = s["obs_per_rank"]
        print(f"step {i:5d} timing samples a rank "
              f"{[x['timing_samples'] for x in ob]} of "
              f"{[x['audit_calls'] for x in ob]} calls, plan epoch "
              f"{ob[0]['plan_epoch']}", flush=True)
        rt = s["retune_rank0"]
        if rt is not None:
            print(f"step {i:5d} retune -> epoch {rt['epoch']} "
                  f"({'choices changed' if rt['swapped'] else 'same choices'}"
                  f", regret {rt['regret_s']:.6f}s, {rt['measured_cells']} "
                  f"measured candidates, plan {rt['plan_sha256'][:12]})",
                  flush=True)
            for d in rt["drift"]:
                print(f"step {i:5d} calibration drift: {d['backend']}@"
                      f"{d['level']} measures {d['scale']}x the oracle - "
                      f"{d['recommendation']}", flush=True)
    ob = run["obs"]
    for e in ob.get("calibration", {}).get("scales", []):
        print(f"calibration {e['backend']} {e['level']} {e['primitive']}: "
              f"measured/oracle {e['scale']:.4f} over {e['samples']:.0f} "
              f"samples", flush=True)
    if "regret_s" in ob:
        print(f"measured regret {ob['regret_s']:.6f}s, {ob['swaps']} swaps "
              f"with changed choices", flush=True)
    if o.plan_out and o.online_retune:
        print(f"saved refined plan (v4) -> {o.plan_out} (+ "
              f"{os.path.splitext(o.plan_out)[0]}.timings.json, "
              f"{ob['samples_folded']} samples)", flush=True)


def print_resil(run: dict) -> None:
    """Each step's snapshots, beats, verdicts and recovery, then the
    reference launcher's end-of-run report."""
    for i, s in enumerate(run["steps"]):
        rs = s["resilience_per_rank"]
        snaps = [r.get("snapshot") for r in rs]
        if any(snaps) or any("snapshot_error" in r for r in rs):
            print(f"step {i:5d} pool snapshot (data step {s['data_step']}):"
                  + "".join(
                      f" rank {k} " + (f"{x['bytes']} B in {x['seconds']:.3f}"
                                       f"s ({x['retries']} retries)"
                                       if x else "failed")
                      for k, x in enumerate(snaps)), flush=True)
        r0 = rs[0]
        if "verdicts" in r0:
            if not all(r0["pulses_landed"]) or r0["pool_errors_folded"]:
                print(f"step {i:5d} heartbeats landed "
                      f"{r0['pulses_landed']}, pool errors "
                      f"{r0['pool_errors_folded']}", flush=True)
            for kind, rank, link, at in r0["verdicts"]:
                what = f"rank {rank}" if rank is not None else \
                    f"link {link}" if link is not None else "pool"
                print(f"step {i:5d} confirmed {kind}({what}) on every rank",
                      flush=True)
        rb = r0.get("rollback")
        if rb is not None:
            print(f"step {i:5d} re-plan [{rb['reason']}] (plan "
                  f"{r0['recovery']['plan_sha256'][:12]} on every rank); "
                  f"committed by rank {rb['committed_by_rank']}, rolled back "
                  f"to step {rb['snapshot_step']}, steps lost "
                  f"{rb['steps_lost']}", flush=True)
    rep = run["resilience"]
    if "faults_injected" in rep:
        print(f"faults injected: {len(rep['faults_injected'])}", flush=True)
    if "replans" in rep:
        print(f"resilience: {rep['replans']} re-plan(s), dead ranks "
              f"{rep['dead_ranks']}, degraded links "
              f"{rep['degraded_links']}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    spec = spec_from_args(args)
    device = spec.device
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = spec.mesh()
    if spec.topology is not None:
        warn_uncovered(spec.topology, dict(shape))
    print(f"training {cfg.name} on mesh "
          + " ".join(f"{a}={n}" for a, n in shape) + f" ({device}) "
          f"backend={args.backend} fuse_kernels={args.fuse_kernels}"
          + (f" plan={args.plan}" if args.plan else "")
          + (f" topology={args.topology}" if args.topology else ""),
          flush=True)
    if spec.pp_stages > 1:
        bub = bubble_fraction(spec.pp_stages, args.microbatches,
                              args.pp_schedule, args.pp_chunks)
        print(f"pipeline: {spec.pp_stages} stages x {spec.data_ranks()} dp, "
              f"{args.microbatches} microbatches, schedule "
              f"{args.pp_schedule}, bubble fraction {bub:.3f}", flush=True)
    t0 = time.time()
    run = run_ranks(spec)[0]
    for i, s in enumerate(run["steps"]):
        print(f"step {i:5d} loss {s['loss']:.4f} lr {s['lr']:.2e} "
              f"step {s['step_s']:.2f}s pool {s['pool_bytes'] / 2**20:.1f}"
              f" MiB launches {json.dumps(s['launches'])}", flush=True)
        if s["moe_assigned"]:
            print(f"  MoE pairs dropped {s['moe_dropped']} of "
                  f"{s['moe_assigned']}", flush=True)
        if len(s["pool_by_level"]) > 1:
            print("  pool MiB by level " + json.dumps(
                {a: {k: round(v / 2**20, 1) for k, v in c.items()}
                 for a, c in s["pool_by_level"].items()}), flush=True)
        if s["level_counts_rank0"]:
            print("  collective calls by level (rank 0) "
                  + json.dumps(s["level_counts_rank0"]), flush=True)
    for c in run["steps"][0]["choices_rank0"] if run["steps"] else []:
        print(f"auto {c['primitive']} {c['msg_bytes']} B x{c['nranks']}"
              + (f" at {c['level']}" if c.get("level") else "") + ": "
              f"{c['backend']} factor {c['slicing_factor']} "
              f"{c['allreduce_mode']} fused={c['fused']} "
              f"({c['calls']} calls in step 0)", flush=True)
    if spec.obs is not None:
        print_obs(run, spec.obs)
    if spec.resil is not None:
        print_resil(run)
    print(f"ranks' wall {run['spawn_s']:.1f}s (params built "
          f"{run['init_s']:.1f}s, captured {run['capture_s']:.1f}s)"
          + (f", checkpoint assembled {run['assemble_s']:.1f}s, saved "
             f"{run['save_s']:.1f}s" if "ckpt" in run else ""), flush=True)
    if run.get("peak_memory_gib"):
        print("peak memory a rank (GiB) " + " ".join(
            f"{g:.2f}" for g in run["peak_memory_gib"]), flush=True)
    print(f"done in {time.time() - t0:.1f}s", flush=True)
    return run


if __name__ == "__main__":
    main()
