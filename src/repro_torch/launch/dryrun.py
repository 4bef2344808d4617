"""Multi-pod dry-run of the port: one rank's step traced on the
meta device.

Port of ``repro.launch.dryrun``.  For every (architecture x input shape x
mesh) combination the reference lowers and compiles the real step
function against ``ShapeDtypeStruct`` inputs and never executes it.  This
package has no compiler to ask, so it traces: rank 0 of the mesh runs its
step - train_step for ``train_4k``, prefill for ``prefill_32k``, one
decode step against a KV cache for ``decode_32k`` / ``long_500k`` - on
``torch.device("meta")``, which allocates nothing and launches nothing.
Every collective still goes through the ``Communicator``: it resolves
its plan cell (``auto``) and books its wire bytes exactly as an executed
step would, while the exchange itself moves nothing
(``core.mesh_collectives``; the mesh has no process group and no pool,
``launch.mesh.make_meta_mesh``).  All ranks of an SPMD step are alike,
so rank 0's trace is the per-chip record.

The record keeps the reference's format, so the reference's consumers
read it (``tuner.placement.CollectiveMix.from_dryrun``,
``tuner.overlap_windows_from_dryrun``, ``tune --overlap-from-dryrun``,
``train --placement-from-dryrun``).  What it cannot hold is left out:

* ``lower_s`` holds the trace's seconds; there is no ``compile_s``;
* ``memory`` holds ``argument_size_in_bytes`` and
  ``output_size_in_bytes``, summed exactly from the step's meta tensors
  (no temporaries: nothing is scheduled);
* ``cost`` holds ``flops`` (``torch.utils.flop_counter.FlopCounterMode``
  over the trace) and ``bytes accessed`` (every aten op's operand and
  result bytes, :class:`BytesAccessed`), the two keys that
  ``tuner.overlap_windows_from_dryrun`` reads;
* ``collectives`` is the ledger's, in :func:`parse_collectives`'s shape,
  with ``"collectives_source": "ledger"``: there is no HLO to parse.

``launch/xla.py`` of the reference (XLA flag presets) has no
counterpart: this package compiles no XLA program, and ``--xla-overlap``
is refused in one line here and by ``train`` and ``serve``.

``--arch all`` runs the reference's ten architectures.  With
``REPRO_DRYRUN_DEVICES`` set the meshes are the reduced (data, model) =
(2, 2) and (pod, data, model) = (2, 2, 2) (``launch.mesh.dryrun_mesh``),
as the reference's local runs; no device count is forced.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape decode_32k [--multi-pod|--both-meshes] \\
      [--backend ring|cxl|auto] [--mesh-shape DPxTP] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --both-meshes
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
import traceback
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.core import ledger
from repro_torch.core.api import Communicator
from repro_torch.launch import add_xla_overlap, refuse_xla_overlap
from repro_torch.launch.mesh import dp_axes, dryrun_mesh, make_meta_mesh
from repro_torch.models import model, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import ParallelContext
from repro_torch.optim import adamw_init
from repro_torch.training.train_loop import (TrainConfig, leaf_params,
                                             make_sharded_train_step)

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# the reference's ten architectures (``repro.configs.ARCH_IDS``)
ARCH_IDS = ["zamba2-1.2b", "phi-3-vision-4.2b", "arctic-480b",
            "whisper-tiny", "granite-moe-3b-a800m", "falcon-mamba-7b",
            "deepseek-coder-33b", "yi-6b", "phi3-medium-14b", "llama3.2-1b"]

DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8,
               "s32": 4, "u64": 8, "u32": 4, "s16": 2, "u16": 2,
               "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16}

_COLL_RE = re.compile(
    r"=\s+(\w+)\[([\d,]*)\][^\s]*\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"[\w-]*\(")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

# the ledger's primitives under the HLO op names of parse_collectives
_HLO_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
              "reduce_scatter": "reduce-scatter",
              "all_to_all": "all-to-all", "p2p": "collective-permute"}


def _result_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def parse_collectives(hlo: str) -> dict:
    """Per-chip wire bytes by collective type, from the partitioned HLO
    (the reference's parser, copied: this package has no HLO of its own;
    :func:`collectives_from_ledger` fills the same shape).

    Result-shape bytes are converted to wire bytes with the standard ring
    cost for the op's group size n (parsed from replica_groups)."""
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0}
    counts = dict.fromkeys(out, 0)
    for line in hlo.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        dtype, dims, op = m.groups()
        rb = _result_bytes(dtype, dims)
        n = None
        g = _GROUPS_RE.search(line)
        if g:
            n = len(g.group(1).split(","))
        else:
            g2 = _GROUPS_IOTA_RE.search(line)
            if g2:
                n = int(g2.group(2))
        if not n or n < 2:
            if op == "collective-permute":
                n = 2  # permute always moves the full payload
            else:
                continue
        if op == "all-gather":
            wire = rb * (n - 1) / n
        elif op == "all-reduce":
            wire = rb * 2 * (n - 1) / n
        elif op == "reduce-scatter":
            wire = rb * (n - 1)
        elif op == "all-to-all":
            wire = rb * (n - 1) / n
        else:  # collective-permute
            wire = float(rb)
        out[op] += wire
        counts[op] += 1
    return {"wire_bytes": out, "counts": counts,
            "total_wire_bytes": sum(out.values())}


def collectives_from_ledger(snap: dict) -> dict:
    """:func:`parse_collectives`'s shape from a ledger snapshot: wire
    bytes and call sites by HLO op name (the five always present; a
    primitive with no HLO name, such as a grouped level's broadcast,
    under its own)."""
    out = dict.fromkeys(_HLO_NAMES.values(), 0.0)
    counts = dict.fromkeys(_HLO_NAMES.values(), 0)
    for kind, b in (snap.get("wire_bytes") or {}).items():
        name = _HLO_NAMES.get(kind, kind)
        out[name] = out.get(name, 0.0) + float(b)
        counts[name] = counts.get(name, 0) + int(
            (snap.get("counts") or {}).get(kind, 0))
    return {"wire_bytes": out, "counts": counts,
            "total_wire_bytes": sum(out.values())}


class BytesAccessed(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results over
    a trace (each read once, each write once): the step's ``bytes
    accessed`` with no fusion and no cache."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves, _ = tree_flatten((args, kwargs or {}, out))
        self.total += sum(t.numel() * t.element_size() for t in leaves
                          if isinstance(t, torch.Tensor))
        return out


# --------------------------------------------------------------------- #
# input builders
# --------------------------------------------------------------------- #

def _text_len(cfg: ModelConfig, seq: int) -> int:
    """Text length: a decoder-only stub frontend's prefix takes the
    rest of ``seq``."""
    if cfg.frontend != "text" and cfg.encoder is None:
        return seq - cfg.frontend_tokens
    return seq


def make_batch(cfg: ModelConfig, batch: int, seq: int, device,
               frontend_dtype=torch.bfloat16,
               generator: Optional[torch.Generator] = None) -> dict:
    """One rank's batch (the reference's ``batch_sds``): tokens and
    labels (batch, text), a vision prefix's ``frontend`` or an encoder's
    ``source`` in ``frontend_dtype``.  Random from ``generator`` on a
    device that holds data; empty on the meta device."""
    text = _text_len(cfg, seq)
    shapes = {"tokens": (batch, text), "labels": (batch, text)}
    if cfg.frontend == "vision_stub" and cfg.encoder is None:
        shapes["frontend"] = (batch, cfg.frontend_tokens, cfg.frontend_dim)
    if cfg.encoder is not None:
        shapes["source"] = (batch, cfg.encoder.source_len,
                            cfg.frontend_dim or cfg.d_model)
    out = {}
    for k, shape in shapes.items():
        ints = k in ("tokens", "labels")
        if torch.device(device).type == "meta":
            out[k] = torch.empty(shape, device=device, dtype=torch.int64
                                 if ints else frontend_dtype)
        elif ints:
            out[k] = torch.randint(0, cfg.vocab_size, shape,
                                   generator=generator, device=device)
        else:
            out[k] = torch.randn(shape, generator=generator,
                                 device=device).to(frontend_dtype)
    return out


def has_attention(cfg: ModelConfig) -> bool:
    return any(ch in "ae" for ch in cfg.layer_pattern)


def plan_report(ledger_snap: dict) -> dict:
    """Plan-aware dry-run report (the reference's): condense the
    auto-plan audit trail (``ledger.snapshot()["auto_choices"]``) into
    the per-shape backend mix and the predicted step-time delta of the
    tuned choices vs the best fixed knobs, split per topology level.

    Choice records carry the cost model's predicted/baseline times and
    the ambient trip-count scale at the call site (``calls``, 1 a call
    here: every call of the trace books its own entry), so the deltas
    are per-step estimates.  Times are those of the nearest tuned plan
    cell, so absolute seconds are approximate when a call site falls
    outside the tuned grid; the delta's sign and per-level split remain
    exact."""
    choices = ledger_snap.get("auto_choices") or []
    by_backend: dict = {}
    by_prim: dict = {}
    by_level: dict = {}
    predicted = baseline = 0.0
    for ch in choices:
        calls = float(ch.get("calls", 1.0))
        key = ch["backend"]
        by_backend[key] = by_backend.get(key, 0.0) + calls
        prim = by_prim.setdefault(ch["primitive"], {})
        prim[key] = prim.get(key, 0.0) + calls
        lvl = f"{ch.get('level') or 'flat'}/{ch.get('fabric') or '?'}"
        rec = by_level.setdefault(
            lvl, {"calls": 0.0, "predicted_s": 0.0, "baseline_s": 0.0})
        rec["calls"] += calls
        rec["predicted_s"] += ch.get("predicted_time", 0.0) * calls
        rec["baseline_s"] += ch.get("baseline_time", 0.0) * calls
        predicted += ch.get("predicted_time", 0.0) * calls
        baseline += ch.get("baseline_time", 0.0) * calls
    for rec in by_level.values():
        rec["delta_s"] = rec["baseline_s"] - rec["predicted_s"]
    return {
        "backend_mix": by_backend,
        "backend_mix_by_primitive": by_prim,
        "per_level": by_level,
        "predicted_comm_s": predicted,
        "baseline_comm_s": baseline,
        "predicted_step_delta_s": baseline - predicted,
    }


def decode_window(cfg: ModelConfig, shape_name: str):
    """long_500k uses the sliding-window ring buffer for attention rows
    (SSM rows are O(1) regardless)."""
    if shape_name == "long_500k" and has_attention(cfg):
        return cfg.sliding_window
    return None


def cache_specs(cfg: ModelConfig, pc: ParallelContext, batch: int,
                seq: int, window=None, cache_dtype=torch.bfloat16,
                device="meta") -> list:
    """One rank's decode cache, as meta tensors by default (the
    reference's ``cache_specs`` gives the PartitionSpecs of the GLOBAL
    cache; here the per-rank local shapes): the KV cache's sequence and
    the Mamba state's channels sharded over the model axis, cross
    attention's heads when kv is sharded, ``batch`` this rank's rows;
    zeros on a device that holds data."""
    return model.init_cache(cfg, pc, batch, seq, cache_dtype,
                            window=window, device=device)


# --------------------------------------------------------------------- #
# per-shape step
# --------------------------------------------------------------------- #

def _size(mesh: dict, axes) -> int:
    return math.prod(mesh[a].size for a in axes)


def _index(mesh: dict, axes) -> int:
    i = 0
    for a in axes:
        i = i * mesh[a].size + mesh[a].rank
    return i


def build_step(arch: str, shape_name: str, mesh: dict, backend: str, *,
               allreduce_mode: str = "two_phase", bucket_mb: float = 25.0,
               prefetch: int = 1, seq_len: Optional[int] = None,
               global_batch: Optional[int] = None,
               kind: Optional[str] = None, device="meta",
               param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
               seed: int = 0, cfg: Optional[ModelConfig] = None) -> tuple:
    """The reference's ``build_lowerable``: (fn, args, cfg) of this
    rank's step of ``shape_name`` on ``mesh`` (axis name ->
    ``AxisGroup``: ``launch.mesh.make_meta_mesh`` for a trace,
    ``make_host_mesh`` for a rank that executes it).  ``seq_len``,
    ``global_batch`` and ``kind`` default to the shape's entries.  On
    ``device="meta"`` every tensor is a meta tensor; on a device that
    holds data the params are random from ``seed`` (``model.
    init_params``, GLOBAL, then this rank's shards), the cache and the
    decode's tokens and position zeros, the batch random.  Train runs
    the FSDP + TP step (remat, a microbatch of 2 sequences a rank,
    ``bucket_mb`` / ``prefetch``); prefill and decode hold their params
    TP-resident (no FSDP), as the reference.  ``fn.pc`` is the step's
    ``ParallelContext``."""
    cfg = cfg or get_config(arch)
    info = SHAPES[shape_name]
    seq = info["seq_len"] if seq_len is None else seq_len
    gbatch = info["global_batch"] if global_batch is None else global_batch
    kind = kind or info["kind"]
    tp = mesh["model"].size if "model" in mesh else 1
    dp = dp_axes(mesh)
    dp_spec = dp if len(dp) > 1 else dp[0]
    dp_size = _size(mesh, dp)
    sharding.set_mesh_sizes({a: g.size for a, g in mesh.items()
                             if isinstance(a, str)})
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device).manual_seed(seed)

    if kind == "train":
        local_b = gbatch // dp_size
        tcfg = TrainConfig(remat=True, microbatches=max(1, local_b // 2),
                           backend=backend, allreduce_mode=allreduce_mode,
                           clip_norm=None, bucket_mb=bucket_mb,
                           prefetch=prefetch)
        step, pspecs, pc = make_sharded_train_step(
            cfg, tcfg, mesh, dp_axis=dp)
        step.pc = pc
        full = model.abstract_params(cfg, tp=tp, dtype=param_dtype) \
            if gen is None else model.init_params(cfg, gen, device,
                                                  param_dtype, tp=tp)
        params = leaf_params(sharding.shard_params(
            full, pspecs, dp_spec, _index(mesh, dp), dp_size,
            tp_axis="model", tp_rank=pc.tp_index(), tp=tp))
        opt = adamw_init(params)
        batch = make_batch(cfg, local_b, seq, device, generator=gen)
        return step, (params, opt, batch), cfg

    comm = Communicator(backend=backend, allreduce_mode=allreduce_mode,
                        axes=mesh)
    pc = ParallelContext(tp_axis="model", dp_axis=dp_spec, tp=tp,
                         comm=comm)
    pspecs = sharding.param_specs(model.abstract_params(cfg, tp=tp), cfg,
                                  dp_axis=dp_spec, fsdp=False)
    full = model.abstract_params(cfg, tp=tp, dtype=param_dtype) \
        if gen is None else model.init_params(cfg, gen, device,
                                              param_dtype, tp=tp)
    params = sharding.shard_params(full, pspecs, None, 0, 1,
                                   tp_axis="model", tp_rank=pc.tp_index(),
                                   tp=tp)
    del full
    if kind == "prefill":
        batch = make_batch(cfg, gbatch // dp_size, seq, device,
                           generator=gen)
        batch.pop("labels")

        def prefill_fn(p, b):
            return model.prefill(p, b, cfg, pc, max_seq=seq,
                                 cache_dtype=cache_dtype)
        prefill_fn.pc = pc
        return prefill_fn, (params, batch), cfg

    # decode kinds
    window = decode_window(cfg, shape_name)
    batch_sharded = gbatch >= dp_size and gbatch % dp_size == 0
    local_b = gbatch // dp_size if batch_sharded else gbatch
    cache = cache_specs(cfg, pc, local_b, seq, window, cache_dtype, device)
    tok = torch.zeros((local_b, 1), dtype=torch.int64, device=device)
    pos = torch.zeros((), dtype=torch.int64, device=device)

    def serve_fn(p, c, t, position):
        return model.decode_step(p, c, t, position, cfg, pc, window=window)
    serve_fn.pc = pc
    return serve_fn, (params, cache, tok, pos), cfg


def _nbytes(obj) -> int:
    leaves, _ = tree_flatten(obj)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def trace_step(fn, args) -> dict:
    """Run ``fn(*args)`` (on meta tensors: a trace) under the ledger,
    the FLOP counter and :class:`BytesAccessed`; returns the record's
    ``ledger``, ``lower_s``, ``memory`` and ``cost``."""
    ledger.reset()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, BytesAccessed() as acc:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    return {"ledger": ledger.snapshot(), "lower_s": round(seconds, 1),
            "memory": {"argument_size_in_bytes": _nbytes(args),
                       "output_size_in_bytes": _nbytes(out)},
            "cost": {"flops": float(flops.get_total_flops()),
                     "bytes accessed": float(acc.total)}}


def _mesh_sizes(multi_pod: bool, mesh_shape: Optional[str]) -> dict:
    if mesh_shape:
        dp_, tp_ = (int(x) for x in mesh_shape.split("x"))
        return {"data": dp_, "model": tp_}
    return dryrun_mesh(multi_pod)


def run_one(arch: str, shape_name: str, multi_pod: bool, backend: str,
            out_dir: Optional[str], mesh_shape: Optional[str] = None,
            allreduce_mode: str = "two_phase",
            bucket_mb: float = 25.0, prefetch: int = 1,
            placement: Optional[str] = None, **step_kw) -> dict:
    """One record, as the reference's ``run_one``: ``mesh_shape`` 'DPxTP'
    re-factors the single pod; ``placement`` ('auto' or a placement
    JSON, with an active topology and ``mesh_shape``) builds the mesh
    from the planned axis -> level assignment and records the ranked
    report.  ``step_kw`` goes to :func:`build_step` (``seq_len``,
    ``global_batch``, dtypes)."""
    mesh_name = ("pod" + mesh_shape) if mesh_shape else (
        "pod2x16x16" if multi_pod else "pod16x16")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "backend": backend, "allreduce_mode": allreduce_mode,
           "bucket_mb": bucket_mb, "prefetch": prefetch,
           "status": "error"}
    try:
        from repro_torch.core.topology import (get_active_topology,
                                               warn_uncovered)
        topo = get_active_topology()
        if placement:
            from repro_torch import tuner
            from repro_torch.launch.mesh import make_placed_mesh
            if topo is None or not mesh_shape:
                raise ValueError("--placement needs --topology and "
                                 "--mesh-shape DPxTP")
            dp_, tp_ = (int(x) for x in mesh_shape.split("x"))
            info = SHAPES[shape_name]
            mix = tuner.CollectiveMix.for_model(
                get_config(arch), {"data": dp_, "model": tp_},
                seq=info["seq_len"],
                batch_per_rank=max(1, info["global_batch"] // dp_))
            pplan = tuner.plan_placement(mix, topo) \
                if placement == "auto" else \
                tuner.load_placement(placement)
            chosen = pplan.best_with_unsplit(("model",))
            rec["placement"] = {
                "chosen": chosen.to_json(),
                "candidates": len(pplan.ranked),
                "meta": pplan.meta}
            print(tuner.format_report(pplan, chosen=chosen))
            sizes = dict(make_placed_mesh(chosen, mix, topo))
            topo = get_active_topology()
        else:
            sizes = _mesh_sizes(multi_pod, mesh_shape)
        if topo is not None:
            warn_uncovered(topo, sizes)
        mesh = make_meta_mesh(sizes, 0, topology=topo)
        fn, args, cfg = build_step(arch, shape_name, mesh, backend,
                                   allreduce_mode=allreduce_mode,
                                   bucket_mb=bucket_mb, prefetch=prefetch,
                                   **step_kw)
        rec.update(trace_step(fn, args))
        if backend == "auto":
            rec["plan_report"] = plan_report(rec["ledger"])
        rec["collectives"] = collectives_from_ledger(rec["ledger"])
        rec["collectives_source"] = "ledger"
        tp = sizes.get("model", 1)
        rec["params"] = int(cfg.param_count(tp=tp))
        rec["active_params"] = int(cfg.active_param_count(tp=tp))
        rec["status"] = "ok"
        print(f"[dryrun] {arch} {shape_name} {mesh_name} {backend}: OK "
              f"(trace {rec['lower_s']}s on the meta device)")
        print(f"  memory: {rec['memory']}")
        print(f"  flops/chip: {rec['cost']['flops']:.3e}  wire bytes/chip: "
              f"{rec['collectives']['total_wire_bytes']:.3e}")
        lvl_bytes = rec["ledger"].get("level_wire_bytes") or {}
        for lvl, kinds in sorted(lvl_bytes.items()):
            print(f"  level {lvl}: {sum(kinds.values()):.3e} "
                  f"ledger wire bytes")
        if "plan_report" in rec:
            pr = rec["plan_report"]
            print(f"  plan: backend mix {pr['backend_mix']}, predicted "
                  f"step-time delta vs best fixed "
                  f"{pr['predicted_step_delta_s']:.3e}s")
            for lvl, r in sorted(pr["per_level"].items()):
                print(f"    {lvl}: {r['calls']:.0f} calls, "
                      f"delta {r['delta_s']:.3e}s")
    except Exception as e:  # noqa: BLE001 - record and continue
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} {shape_name} {mesh_name} {backend}: "
              f"FAIL {rec['error']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if allreduce_mode == "two_phase" else \
            f"_{allreduce_mode}"
        fname = (f"{arch}_{shape_name}_{mesh_name}_{backend}"
                 f"{suffix}.json")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--backend", choices=["ring", "cxl", "auto"],
                    default="ring")
    ap.add_argument("--plan", default=None,
                    help="autotuning plan for --backend auto; the "
                         "per-collective decisions land in the record's "
                         "ledger.auto_choices and the condensed "
                         "plan_report")
    ap.add_argument("--topology", default=None,
                    help="'axis:fabric,...' spec or topology JSON: "
                         "decompose tuple-axis collectives per level "
                         "and split ledger wire bytes per fabric")
    ap.add_argument("--mesh-shape", default=None,
                    help="DPxTP single-pod logical mesh override")
    ap.add_argument("--placement", default=None,
                    help="'auto' or a saved placement JSON: build the "
                         "mesh from the planned axis->level assignment "
                         "(tuner.placement; needs --topology and "
                         "--mesh-shape) and record the ranked report")
    ap.add_argument("--allreduce-mode", default="two_phase",
                    choices=["two_phase", "faithful"])
    ap.add_argument("--bucket-mb", type=float, default=25.0,
                    help="grad-sync bucket cap for the train shape; "
                         "> 0 also row-fuses the FSDP gathers "
                         "(0 = per-leaf collectives)")
    ap.add_argument("--prefetch", type=int, default=1, choices=[0, 1],
                    help="FSDP AllGather prefetch depth for the train "
                         "shape (0 = serialized baseline)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--metrics-out", default=None,
                    help="export each run's ledger-derived metrics as "
                         "JSON-lines here (obs schema, one sample per "
                         "line tagged with the run id) plus a Prometheus "
                         "rendering of the last run's registry at "
                         "<base>.prom")
    add_xla_overlap(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    refuse_xla_overlap(args)
    from repro_torch.core.topology import (parse_topology,
                                           set_active_topology)
    if args.topology:
        set_active_topology(parse_topology(args.topology))
    if args.plan:
        from repro_torch.core.hw import CXL_POOL, INFINIBAND
        from repro_torch.tuner import activate_plan_file
        activate_plan_file(args.plan, pool=CXL_POOL, ib=INFINIBAND)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    mf = open(args.metrics_out, "w") if args.metrics_out else None
    last_reg = None
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_one(arch, shape, mp, args.backend, args.out,
                              mesh_shape=args.mesh_shape,
                              allreduce_mode=args.allreduce_mode,
                              bucket_mb=args.bucket_mb,
                              prefetch=args.prefetch,
                              placement=args.placement)
                failures += rec["status"] != "ok"
                if mf is not None and rec.get("ledger"):
                    from repro_torch.obs import MetricsRegistry, from_ledger
                    reg = MetricsRegistry()
                    from_ledger(reg, rec["ledger"])
                    run_id = f"{arch}/{shape}" + (
                        "/multi_pod" if mp else "")
                    for m in reg.metrics():
                        for name, key, v in m.samples():
                            mf.write(json.dumps(
                                {"kind": "metric", "run": run_id,
                                 "name": name, "type": m.kind,
                                 "labels": dict(key), "value": v},
                                sort_keys=True) + "\n")
                    last_reg = reg
    if mf is not None:
        mf.close()
        if last_reg is not None:
            prom = os.path.splitext(args.metrics_out)[0] + ".prom"
            with open(prom, "w") as f:
                f.write(last_reg.to_prometheus())
            print(f"[dryrun] metrics: {args.metrics_out} (+ {prom})")
    print(f"[dryrun] done in {time.perf_counter() - t0:.1f}s; "
          f"{failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
