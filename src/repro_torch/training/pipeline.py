"""Pipeline parallelism: schedules, bubble accounting, the rank runtime.

Port of ``repro.training.pipeline``.

**Schedules** (copied: framework-free).  ``schedule_1f1b`` /
``schedule_interleaved`` produce per-stage op lists (the order a
multi-controller runtime would execute) and ``simulate`` runs them under
greedy unit-time execution with the true dataflow dependencies - F(vs,
m) after F(vs-1, m), B(vs, m) after B(vs+1, m) and F(vs, m) - raising
``PipelineDeadlock`` if the lists ever wedge.  Bubble closed forms (per
stage, in per-op time units; an interleaved chunk op is ``1/v`` of a
1F1B stage op):

* 1F1B:         span = 2M + 2(S-1),   bubble = 2(S-1)
* interleaved:  span = 2Mv + 2(S-1),  bubble = 2(S-1)  (= 2(S-1)/v
  stage-op units - the Megatron-style 1/v bubble shrink; requires
  M % S == 0 so chunk groups tile the pipeline)

**Execution.**  As in the reference, the pipeline is ``M + S - 1``
ticks: at tick ``t`` stage ``s`` works on microbatch ``m = t - s`` and
every rank hands its activation one hop on with ``Communicator.send``
(zeros on a tick that is not valid).  The reference differentiates its
one SPMD program with ``jax.grad``, so the transpose of every tick's
``send`` runs on every rank.  Here each rank is a process with its own
autograd graph, and a stage never uses some of what it receives (stage 0
takes the embedding, not the last stage's payload): autograd would
never run those hops' backward, and the peers would wait for them.  So
the reverse pipeline is driven explicitly: ``M + S - 1`` reverse ticks,
each a ``Communicator.recv`` of the cotangent of the activation this
rank received one tick later (zeros where there is none) and one
``torch.autograd.backward`` through the tick's saved stage output.
Every rank makes the same sequence of ``Communicator`` calls.  What the
reference masks to zero is not computed: invalid ticks, the embedding
off stage 0, the final norm, logits and cross-entropy off the last
stage; their cotangents are zero, so the loss and every gradient are
unchanged.

The loss is the mean over microbatches of each microbatch's
cross-entropy, plus the rows' auxiliary (router) losses; one scalar
AllReduce over the stage axis shares each, and, as the reference's
``share``, each rank's gradient comes from its local part only (a
cotangent of 1/M).  The data mean of the loss hands each rank a
cotangent of 1 (its transpose sums 1/N over N ranks), so the reverse
pipeline is seeded with 1/M.  ``schedule`` drives the bubble accounting
and validates the schedule; the arithmetic is schedule-independent.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch

from repro_torch.core import tree
from repro_torch.core.api import Communicator
from repro_torch.core.hw import CXL_POOL, INFINIBAND
from repro_torch.models import layers, model, moe, pipeline_stages, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext
from repro_torch.optim import adamw_update, linear_warmup_cosine
from repro_torch.tuner.plan import load_plan

SCHEDULES = ("1f1b", "interleaved")


# --------------------------------------------------------------------- #
# schedules (host side: op ordering + bubble accounting)
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Op:
    """One scheduled unit of stage work: a forward or backward pass of
    one microbatch through one model chunk (chunk 0 unless
    interleaved)."""
    kind: str             # 'F' | 'B'
    microbatch: int
    chunk: int = 0


class PipelineDeadlock(RuntimeError):
    """Greedy execution of the per-stage op lists wedged: some stage's
    next op waits on work that can never complete."""


def schedule_1f1b(n_stages: int, n_microbatches: int) -> list[list[Op]]:
    """PipeDream-flush 1F1B: stage ``s`` runs ``min(S-1-s, M)`` warmup
    forwards, then alternates F/B in steady state, then drains the
    remaining backwards.  Peak live activations per stage are bounded
    by the warmup depth (S - s) instead of M (GPipe)."""
    S, M = n_stages, n_microbatches
    if S < 1 or M < 1:
        raise ValueError("need n_stages >= 1 and n_microbatches >= 1")
    out = []
    for s in range(S):
        warm = min(S - 1 - s, M)
        ops = [Op("F", m) for m in range(warm)]
        for i in range(M - warm):
            ops.append(Op("F", warm + i))
            ops.append(Op("B", i))
        for i in range(max(M - warm, 0), M):
            ops.append(Op("B", i))
        out.append(ops)
    return out


def schedule_interleaved(n_stages: int, n_microbatches: int,
                         n_chunks: int = 2) -> list[list[Op]]:
    """Interleaved 1F1B (Megatron-style looping pipeline): each
    physical stage hosts ``v = n_chunks`` model chunks, so virtual
    stage ``c*S + s`` lives on physical stage ``s`` and a microbatch
    loops through the pipeline ``v`` times.  Forward order walks chunk
    groups of ``S`` microbatches (chunk 0 of microbatches 0..S-1, then
    chunk 1 of the same group, ...), which is why ``M % S == 0`` is
    required; backward mirrors it with chunks reversed.  Bubble per
    stage is 2(S-1) *chunk* ops = 2(S-1)/v stage ops."""
    S, M, v = n_stages, n_microbatches, n_chunks
    if S < 1 or M < 1:
        raise ValueError("need n_stages >= 1 and n_microbatches >= 1")
    if v < 1:
        raise ValueError("n_chunks must be >= 1")
    if v == 1:
        return schedule_1f1b(S, M)
    if M % S:
        raise ValueError(
            f"interleaved schedule needs microbatches % stages == 0 "
            f"(got M={M}, S={S})")
    total = M * v

    def f_op(k: int) -> Op:
        g = k % (S * v)
        return Op("F", (k // (S * v)) * S + g % S, g // S)

    def b_op(k: int) -> Op:
        g = k % (S * v)
        return Op("B", (k // (S * v)) * S + g % S, v - 1 - g // S)

    out = []
    for s in range(S):
        warm = min((S - 1 - s) * 2 + (v - 1) * S, total)
        ops = [f_op(k) for k in range(warm)]
        for i in range(total - warm):
            ops.append(f_op(warm + i))
            ops.append(b_op(i))
        for i in range(max(total - warm, 0), total):
            ops.append(b_op(i))
        out.append(ops)
    return out


def make_schedule(schedule: str, n_stages: int, n_microbatches: int,
                  n_chunks: int = 2) -> list[list[Op]]:
    if schedule == "1f1b":
        return schedule_1f1b(n_stages, n_microbatches)
    if schedule == "interleaved":
        return schedule_interleaved(n_stages, n_microbatches, n_chunks)
    raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")


def simulate(per_stage_ops: list[list[Op]], n_chunks: int = 1) -> int:
    """Greedy unit-time execution of the per-stage op lists under the
    pipeline dataflow dependencies.  Each stage runs its ops strictly
    in list order, one per tick, starting an op only when its inputs
    exist: F(vs, m) needs F(vs-1, m); B(vs, m) needs F(vs, m) and
    B(vs+1, m) (virtual stage vs = chunk*S + s).  Returns the span in
    ticks; raises :class:`PipelineDeadlock` if no stage can make
    progress before all ops complete."""
    S = len(per_stage_ops)
    V = n_chunks * S
    done: dict = {}
    idx = [0] * S
    total = sum(len(o) for o in per_stage_ops)
    ndone, t = 0, 0
    while ndone < total:
        runnable = []
        for s in range(S):
            if idx[s] >= len(per_stage_ops[s]):
                continue
            op = per_stage_ops[s][idx[s]]
            vs = op.chunk * S + s
            if op.kind == "F":
                ok = vs == 0 or done.get(("F", vs - 1, op.microbatch),
                                         total + 1) <= t
            else:
                ok = done.get(("F", vs, op.microbatch), total + 1) <= t \
                    and (vs == V - 1
                         or done.get(("B", vs + 1, op.microbatch),
                                     total + 1) <= t)
            if ok:
                runnable.append((s, op, vs))
        if not runnable:
            stuck = {s: per_stage_ops[s][idx[s]] for s in range(S)
                     if idx[s] < len(per_stage_ops[s])}
            raise PipelineDeadlock(
                f"wedged at tick {t} with {total - ndone} ops left: "
                f"{stuck}")
        for s, op, vs in runnable:
            done[(op.kind, vs, op.microbatch)] = t + 1
            idx[s] += 1
            ndone += 1
        t += 1
    return t


def bubble_count(n_stages: int, n_microbatches: int,
                 schedule: str = "1f1b", n_chunks: int = 2) -> int:
    """Per-stage idle ticks (in per-op time units: chunk ops for the
    interleaved schedule): ``2 * (n_stages - 1)`` for both schedules -
    the interleaved win is that its op unit is ``1/v`` of a stage op,
    so the same tick count is ``2(S-1)/v`` stage-op units of idle
    time."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if n_stages < 1 or n_microbatches < 1:
        raise ValueError("need n_stages >= 1 and n_microbatches >= 1")
    return 2 * (n_stages - 1)


def bubble_fraction(n_stages: int, n_microbatches: int,
                    schedule: str = "1f1b", n_chunks: int = 2) -> float:
    """Idle fraction of the pipelined step: bubble / span.  For 1F1B
    this is ``(S-1)/(M + S - 1)``; interleaving divides the bubble's
    stage-op units by ``v``."""
    v = n_chunks if schedule == "interleaved" else 1
    busy = 2 * n_microbatches * v
    bub = bubble_count(n_stages, n_microbatches, schedule, n_chunks)
    return bub / (busy + bub)


# --------------------------------------------------------------------- #
# the rank runtime
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class PipelineRun:
    """What a rank's forward ticks leave for its reverse ticks: per valid
    tick, the leaf that took the received activation (None on stage 0),
    the stage output and the tick's local loss term; a zero activation
    (the payload of a tick with nothing to send); the local sums of the
    cross-entropy and the aux losses."""
    ticks: int
    n_microbatches: int
    zeros: torch.Tensor
    saved: dict
    xent_sum: torch.Tensor
    aux_sum: torch.Tensor


def pipeline_forward(params, batch: dict, cfg: ModelConfig,
                     pc: ParallelContext, *, stage_axis: str,
                     n_microbatches: int, remat: bool = True) -> PipelineRun:
    """The forward ticks on this rank: ``params`` holds its slab of the
    stacked rows (``g0``) and the replicated embedding and final norm;
    the local batch splits into ``n_microbatches`` along the batch dim.
    Every tick sends this rank's stage output one hop on the stage axis
    (zeros on an invalid tick)."""
    comm = pc.comm
    S = comm.axis_size(stage_axis)
    sidx = comm.axis_index(stage_axis)
    M = n_microbatches
    tokens, labels = batch["tokens"], batch["labels"]
    if tokens.shape[0] % M:
        raise ValueError(f"local batch {tokens.shape[0]} not divisible "
                         f"by {M} microbatches")
    mb, seq = tokens.shape[0] // M, tokens.shape[1]
    tok_mb = tokens.reshape((M, mb, seq))
    lab_mb = labels.reshape((M, mb, seq))
    mask = batch.get("loss_mask")
    mask_mb = mask.reshape((M, mb, seq)) if mask is not None else None
    positions = torch.arange(seq, device=tokens.device)
    first, last = sidx == 0, sidx == S - 1
    dev = tokens.device
    zeros = torch.zeros((mb, seq, cfg.d_model), device=dev,
                        dtype=tree.leaves(params["embed"])[0].dtype)
    xent_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    saved: dict = {}
    h_recv = zeros
    ticks = M + S - 1
    for t in range(ticks):
        m = t - sidx
        if 0 <= m < M:
            h_in = None
            if first:
                x = layers.embed_tokens(params["embed"], tok_mb[m], cfg,
                                        pc).to(zeros.dtype)
            else:
                h_in = x = h_recv.requires_grad_(True)
            h_out, term = pipeline_stages.stage_forward(
                params["g0"], x, cfg, pc, positions, remat=remat)
            aux_sum = aux_sum + term.detach()
            if last:
                hn = layers.rms_norm(h_out, params["final_norm"],
                                     cfg.norm_eps)
                logits = layers.lm_logits(params["embed"], hn, cfg, pc)
                xent = layers.sharded_xent(
                    logits, lab_mb[m], pc,
                    mask=None if mask_mb is None else mask_mb[m],
                    vocab_size=cfg.vocab_size)
                xent_sum = xent_sum + xent.detach()
                term = term + xent
            saved[t] = (h_in, h_out, term)
            out = h_out.detach()
        else:
            out = zeros
        with torch.no_grad():
            h_recv = comm.send(out, stage_axis)
    return PipelineRun(ticks, M, zeros, saved, xent_sum, aux_sum)


def pipeline_backward(run: PipelineRun, pc: ParallelContext,
                      stage_axis: str) -> None:
    """The reverse ticks, last first: each ``recv``s the cotangent of the
    activation this rank sent at that tick (from the rank one stage
    ahead: the cotangent of what it received) and runs the tick's
    backward, seeding its local loss term with 1/M; the params' ``.grad``
    accumulate.  Stage 0 sends zeros back (it took the embedding)."""
    comm = pc.comm
    last = comm.axis_index(stage_axis) == comm.axis_size(stage_axis) - 1
    g_send = run.zeros
    for t in reversed(range(run.ticks)):
        with torch.no_grad():
            g_out = comm.recv(g_send, stage_axis)
        g_send = run.zeros
        entry = run.saved.pop(t, None)
        if entry is None:
            continue
        h_in, h_out, term = entry
        outs, grads = [], []
        if term.requires_grad:
            outs.append(term)
            grads.append(torch.full_like(term, 1.0 / run.n_microbatches))
        if not last:      # the last stage's payload goes nowhere: zeros
            outs.append(h_out)
            grads.append(g_out)
        torch.autograd.backward(outs, grads)
        if h_in is not None:
            g_send = h_in.grad


def share_loss(run: PipelineRun, pc: ParallelContext,
               stage_axis: str) -> tuple:
    """The loss and its parts, each summed over the stage axis by one
    scalar AllReduce (cross-entropy first, then aux, as the reference's
    ``share``) and averaged over the microbatches: (loss, {"xent",
    "aux"})."""
    with torch.no_grad():
        xent = pc.comm.all_reduce(run.xent_sum, stage_axis) \
            / run.n_microbatches
        aux = pc.comm.all_reduce(run.aux_sum, stage_axis) \
            / run.n_microbatches
    return xent + aux, {"xent": xent, "aux": aux}


def sync_stage_grads(grads, pc: ParallelContext, stage_axis: str):
    """Sum the stage-replicated leaves' grads over the stage axis: the
    embedding is used at both pipeline ends (tied weights), the final
    norm only by the last stage - each rank holds a partial gradient,
    and AdamW needs them identical.  Layer-stacked leaves (``g*``) are
    stage-local slabs and stay untouched."""
    return {k: (v if k.startswith("g") else tree.map_with_path(
        lambda _p, g: pc.comm.all_reduce(g, stage_axis), v))
        for k, v in grads.items()}


def make_pipeline_train_step(cfg: ModelConfig, tcfg, pc: ParallelContext,
                             *, stage_axis: str, n_stages: int,
                             n_microbatches: int, schedule: str = "1f1b",
                             n_chunks: int = 2):
    """Pipeline-parallel train step of this rank: (params, opt_state,
    batch) -> (params, opt_state, metrics), the pipeline's counterpart of
    ``train_loop.make_train_step``.  Data parallelism over ``pc.dp_axis``
    is plain replicated-grad DP (grads averaged over the data axis after
    the stage-axis sync).  ``schedule`` / ``n_chunks`` set the
    ``bubble_fraction`` the metrics report and validate the schedule."""
    make_schedule(schedule, n_stages, n_microbatches, n_chunks)
    lr_fn = linear_warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    bub = bubble_fraction(n_stages, n_microbatches, schedule, n_chunks)

    def step(params, opt_state, batch):
        for p in tree.leaves(params):
            p.grad = None
        moe.DROPS.start()
        run = pipeline_forward(params, batch, cfg, pc,
                               stage_axis=stage_axis,
                               n_microbatches=n_microbatches,
                               remat=tcfg.remat)
        # the forward's routing only: the remat replays route again
        dropped, assigned = moe.DROPS.stop()
        pipeline_backward(run, pc, stage_axis)
        loss, aux = share_loss(run, pc, stage_axis)
        with torch.no_grad():
            if pc.dp_axis is not None:
                loss = pc.dp_all_reduce_mean(loss)
            # a leaf this stage never used (the final norm off the last
            # stage) has a zero gradient, as under jax.grad
            grads = tree.map_with_path(
                lambda _p, p: p.grad if p.grad is not None
                else torch.zeros_like(p), params)
            grads = sync_stage_grads(grads, pc, stage_axis)
            if pc.dp_axis is not None:
                grads = tree.map_with_path(
                    lambda _p, g: pc.dp_all_reduce_mean(g), grads)
            for path, p in tree.leaves_with_paths(params):
                p.grad = tree.get(grads, path)
            lr = lr_fn(opt_state.step)
            params, opt_state = adamw_update(params, grads, opt_state, lr)
        return params, opt_state, {
            "loss": loss, "lr": lr, "bubble_fraction": bub,
            "moe_dropped": dropped, "moe_assigned": assigned, **aux}
    return step


def make_sharded_pipeline_step(cfg: ModelConfig, tcfg, mesh: dict, *,
                               n_microbatches: int,
                               stage_axis: str = "stage",
                               dp_axis: Optional[str] = "data",
                               schedule: str = "1f1b",
                               n_chunks: int = 2) -> tuple:
    """The pipeline train step of this rank of a (stage, data) host mesh
    (``launch.mesh``: axis name -> ``AxisGroup``), the counterpart of the
    reference's ``make_sharded_pipeline_step`` for the port's rank
    runtime.  Returns (step_fn, param_specs, pc): the layer-stacked
    params split over the stage axis (``sharding.shard_params(full,
    param_specs, stage_axis, stage index, S)`` gives a rank's slab),
    embedding and final norm replicated; the ranks of one data index take
    the same batch rows.  ``step_fn.gathers`` is empty: nothing is
    FSDP-gathered."""
    n_stages = mesh[stage_axis].size
    pipeline_stages.uniform_stage_rows(cfg, n_stages)
    dp = dp_axis if dp_axis in mesh and mesh[dp_axis].size > 1 else None
    plan = None
    if tcfg.plan_path is not None:
        # fingerprint-checked: refuse a plan tuned for other hardware
        plan = load_plan(tcfg.plan_path, pool=CXL_POOL, ib=INFINIBAND)
    comm = Communicator(backend=tcfg.backend,
                        slicing_factor=tcfg.slicing_factor,
                        allreduce_mode=tcfg.allreduce_mode, axes=mesh,
                        plan=plan)
    pc = ParallelContext(tp_axis=None, dp_axis=dp, tp=1, comm=comm)
    sharding.set_mesh_sizes({a: g.size for a, g in mesh.items()})
    pspecs = pipeline_stages.stage_param_specs(
        model.abstract_params(cfg, tp=1), stage_axis)
    step = make_pipeline_train_step(
        cfg, tcfg, pc, stage_axis=stage_axis, n_stages=n_stages,
        n_microbatches=n_microbatches, schedule=schedule,
        n_chunks=n_chunks)
    step.gathers = collections.Counter()
    return step, pspecs, pc
