"""Training step: the FSDP (+ tensor-parallel) train step of one rank.

Port of ``repro.training.train_loop``.  The reference's sharded step is
one ``shard_map`` over the mesh; here each rank is a process that holds
its FSDP shards and its slice of the batch and runs the same step body.
Every collective - the FSDP param AllGather, the grad ReduceScatter (its
autograd transpose), the tensor-parallel AllReduces of the activations,
the replicated-grad AllReduce and the loss mean - goes through the
``Communicator``, so ``ring`` vs ``cxl`` swaps the whole
communication layer, and ``auto`` picks per call from a tuned plan
(``TrainConfig.plan_path``, loaded by every rank that builds the step;
with ``plan_path=None`` it resolves through the process-wide registry of
``tuner.runtime``, as the reference's launcher does, which is how online
re-tuning's hot-swapped plans reach the step).

Params are leaf tensors with ``requires_grad``; after a step each one's
``.grad`` holds its synced gradient (what the optimizer consumed), and
params and moments have been updated in place.

``train`` is the reference's single-host loop (the examples' and a CPU
smoke run's): the unsharded step over every batch of an iterator, logged
as the reference logs it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import overlap, tree
from repro_torch.core.api import Communicator, TimedCommunicator
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import CXL_POOL, INFINIBAND
from repro_torch.models import model, moe, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext, UNSHARDED
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, linear_warmup_cosine)
from repro_torch.tuner.plan import load_plan


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    clip_norm: Optional[float] = 1.0     # local shards' norm when sharded
    remat: bool = True
    microbatches: int = 1                # gradient accumulation splits
    backend: str = "ring"                # 'ring' | 'cxl' | 'auto'
    slicing_factor: int = 4
    allreduce_mode: str = "two_phase"
    plan_path: Optional[str] = None      # autotuning plan for 'auto'
    # communication/compute overlap (core.overlap): NCCL-style cap on
    # the fused grad-sync AllReduce buffers; > 0 also switches the FSDP
    # gathers to row-fused buckets, <= 0 restores the per-leaf baseline.
    # prefetch=1 double-buffers the FSDP AllGather.
    bucket_mb: float = 25.0
    prefetch: int = 1
    # The FSDP gathers return the matmul weights as rank-major shard
    # stacks that the consuming matmuls stream through the
    # all_gather_matmul kernel (models.layers.dense).  Requires the
    # bucketed gather path (bucket_mb > 0).
    fuse_kernels: bool = False

    @property
    def bucket_bytes(self) -> int:
        return int(self.bucket_mb * 1024 * 1024)


def make_gather_fn(tcfg: TrainConfig, rspecs: dict, pc: ParallelContext,
                   dp_axis):
    """FSDP gather hook: row-fused buckets (``core.overlap``; a row is
    one bucket whatever ``bucket_mb``, which only caps the grad-sync
    buffers) or the per-leaf reference when ``bucket_mb <= 0``.  Either
    counts its calls by group key in its ``calls``."""
    if tcfg.bucket_bytes > 0:
        return overlap.make_gather_fn(rspecs, pc, dp_axis,
                                      bucket_bytes=None,
                                      fuse=tcfg.fuse_kernels)
    return sharding.fsdp_gather_fn(rspecs, pc, dp_axis)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    pc: ParallelContext = UNSHARDED,
                    gather_fn=None, param_spec_tree=None,
                    dp_axis=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics) for
    the params and batch this process holds.  With ``microbatches > 1``
    the local batch is split and gradients are accumulated in f32, as
    the reference's accumulator (the synced grads are then f32 whatever
    the params' dtype).
    ``param_spec_tree`` enables the replicated-grad AllReduce sync."""
    lr_fn = linear_warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.total_steps)

    def lf(p, b):
        loss, aux = model.loss_fn(p, b, cfg, pc, remat=tcfg.remat,
                                  gather_fn=gather_fn,
                                  prefetch=tcfg.prefetch)
        if pc.dp_axis is not None:
            loss = pc.dp_all_reduce_mean(loss)
        return loss, aux

    def step(params, opt_state: AdamWState, batch):
        leaves = tree.leaves(params)
        for p in leaves:
            p.grad = None
        mb = tcfg.microbatches
        parts = [batch] if mb == 1 else [
            {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(mb)]
        loss_sum = 0.0
        aux_sum: dict = {}
        dropped, assigned = 0, 0
        acc: dict = {}      # microbatch grads summed in f32, as the reference
        for b in parts:
            moe.DROPS.start()
            loss, aux = lf(params, b)
            # the forward's routing only: the remat replays route again
            d, a = moe.DROPS.stop()
            dropped, assigned = dropped + d, assigned + a
            loss.backward()
            if mb > 1:
                for path, p in tree.leaves_with_paths(params):
                    g = p.grad.float()
                    acc[path] = g if path not in acc else acc[path].add_(g)
                    p.grad = None
            loss_sum += loss.detach()
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
        with torch.no_grad():
            grads = tree.map_with_path(
                lambda path, p: acc[path] / mb if mb > 1 else p.grad, params)
            if param_spec_tree is not None:
                if tcfg.bucket_bytes > 0:
                    grads = overlap.bucketed_sync_grads(
                        grads, param_spec_tree, pc, dp_axis,
                        bucket_bytes=tcfg.bucket_bytes)
                else:
                    grads = sharding.sync_grads(grads, param_spec_tree,
                                                pc, dp_axis)
            gnorm = torch.zeros(())
            if tcfg.clip_norm is not None and pc.tp_axis is None:
                grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
            for path, p in tree.leaves_with_paths(params):
                p.grad = tree.get(grads, path).to(p.dtype)
            lr = lr_fn(opt_state.step)
            params, opt_state = adamw_update(params, grads, opt_state, lr)
        metrics = {"loss": loss_sum / mb, "lr": lr, "grad_norm": gnorm,
                   "moe_dropped": dropped, "moe_assigned": assigned,
                   **{k: v / mb for k, v in aux_sum.items()}}
        return params, opt_state, metrics
    return step


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                            mesh: dict, tp_axis: str = "model",
                            dp_axis=("data",), timed: bool = False) -> tuple:
    """The train step of this rank of ``mesh`` (``launch.mesh``: axis
    name -> ``AxisGroup``).  ``dp_axis`` is a name or a tuple of names,
    outer level first (``launch.mesh.dp_axes``: ``("pod", "data")`` on
    a multi-pod mesh); levels of one rank drop out, as in the
    reference.  With ``mesh[tp_axis]`` of size tp > 1 the step is
    tensor-parallel over it (the reference's Megatron sharding; the
    params' GLOBAL shapes are those of ``model.abstract_params(cfg,
    tp)``).  Returns (step_fn, param_specs, pc); ``step_fn`` takes this
    rank's shards (``sharding.shard_params`` per ``param_specs``, at
    ``pc.comm.axis_index(pc.dp_axis)`` and, over the model axis, at
    ``pc.tp_index()``), their AdamW state and this rank's batch slice
    (the ranks of one dp index take the same rows).  With ``timed``
    (backend ``auto`` only) the step's Communicator is a
    ``TimedCommunicator``: every collective call books its measured
    time in the ledger beside its audit entry."""
    tp = mesh[tp_axis].size if tp_axis in mesh else 1
    dp = (dp_axis,) if isinstance(dp_axis, str) else tuple(dp_axis)
    dp = tuple(a for a in dp if mesh[a].size > 1) or (dp[0],)
    dp_spec = dp if len(dp) > 1 else dp[0]
    plan = None
    if tcfg.plan_path is not None:
        # fingerprint-checked: refuse a plan tuned for other hardware
        plan = load_plan(tcfg.plan_path, pool=CXL_POOL, ib=INFINIBAND)
    comm = (TimedCommunicator if timed else Communicator)(
        backend=tcfg.backend, slicing_factor=tcfg.slicing_factor,
        allreduce_mode=tcfg.allreduce_mode, axes=mesh, plan=plan)
    pc = ParallelContext(tp_axis=tp_axis if tp > 1 else None,
                         dp_axis=dp_spec, tp=tp, comm=comm)
    sharding.set_mesh_sizes({a: g.size for a, g in mesh.items()})
    pspecs = sharding.param_specs(model.abstract_params(cfg, tp=tp), cfg,
                                  model_axis=tp_axis, dp_axis=dp_spec,
                                  fsdp=True)
    rspecs = sharding.row_specs(pspecs)
    gather = make_gather_fn(tcfg, rspecs, pc, dp_spec)
    step = make_train_step(cfg, tcfg, pc, gather_fn=gather,
                           param_spec_tree=pspecs, dp_axis=dp_spec)
    step.gathers = gather.calls
    return step, pspecs, pc


def leaf_params(params: Any) -> Any:
    """Detached leaf copies of ``params`` that require grad: what a
    train step holds and updates in place."""
    return tree.map_with_path(
        lambda _p, x: x.detach().clone().requires_grad_(True), params)


def batch_to_device(batch: dict, device) -> dict:
    """A host batch (numpy) on ``device``: token ids as int64, the
    frontends' stub embeddings in their own dtype (f32)."""
    return {k: torch.as_tensor(v, device=device, dtype=torch.long
                               if np.issubdtype(np.asarray(v).dtype,
                                                np.integer) else None)
            for k, v in batch.items()}


def train(cfg: ModelConfig, tcfg: TrainConfig, data_iter, steps: int,
          params=None, generator: Optional[torch.Generator] = None,
          log_every: int = 10, log_fn=print, device=None) -> tuple:
    """Single-host training loop: ``steps`` unsharded steps
    (:func:`make_train_step`) over the batches of ``data_iter``, logging
    step, loss, lr and seconds every ``log_every`` steps and at the last,
    in the reference's format.  ``params=None`` makes them with
    ``model.init_params(cfg, generator, device)`` (``generator=None``: a
    generator on the device seeded 0); given params are copied, not
    updated.  ``device=None`` is the CUDA card (raises without one).
    Returns (params, opt_state, metrics of the last step)."""
    dev = resolve_device(device)
    if params is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = model.init_params(cfg, generator, dev)
    params = leaf_params(params)
    opt_state = adamw_init(params)
    step = make_train_step(cfg, tcfg)
    t0 = time.time()
    metrics: dict = {}
    for i, batch in zip(range(steps), data_iter):
        params, opt_state, metrics = step(params, opt_state,
                                          batch_to_device(batch, dev))
        if i % log_every == 0 or i == steps - 1:
            log_fn(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                   f"lr {float(metrics['lr']):.2e} "
                   f"({(time.time()-t0):.1f}s)")
    return params, opt_state, metrics
