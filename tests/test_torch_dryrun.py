"""The port's dry-run (``repro_torch.launch.dryrun``: one rank's step
traced on the meta device) against the reference's
(``repro.launch.dryrun``: ``build_lowerable(...).lower()``).

The reference lowers, with no compile, in one subprocess at
``REPRO_DRYRUN_DEVICES=8`` (the reduced meshes (data, model) = (2, 2) and
(pod, data, model) = (2, 2, 2)); the port traces in this process on the
same meshes (``launch.mesh.make_meta_mesh``).  Both run the smoke
configs of the reference's ten architectures at small shapes (the
reference's ``SHAPES`` and ``get_config`` patched in its process, the
port's ``build_step`` given the same entries), and Llama-3.2-1B at full
width at ``decode_32k``'s own shapes.  Held:

* ``prefill_32k``, ``decode_32k``, ``long_500k``: the ledgers (wire
  bytes and calls by primitive, wire bytes by level) equal, under
  ``ring`` (no topology), ``cxl`` (a topology of every mesh axis on the
  pool) and ``auto`` (the same plan; the audits equal call for call);
  Zamba2's plus the port's gated-norm AllReduce of each Mamba-2 row
  (ROADMAP queue 3, "Differs by design", PR 25);
* ``train_4k``: the trip counts of queue 3 (PR 20): the reference books
  everything inside ``value_and_grad`` three times, so over the model
  axis it books each microbatch's activation AllReduces (the embedding's
  and each row's) and cross-entropy AllReduces and its max's gathers
  beyond the port's; over the data axis it books the FSDP gathers three
  times as all-gathers where the port books each once and its transpose
  as a reduce-scatter; both book the grad sync's reduce-scatter once;
* the record's format, read by the reference's consumers
  (``CollectiveMix.from_dryrun``, ``overlap_windows_from_dryrun``) and
  by the port's (``train --placement-from-dryrun``, ``tune
  --overlap-from-dryrun``) with the reference's answers; ``plan_report``
  and ``parse_collectives`` equal to the reference's; the CLI; the
  ``--xla-overlap`` refusal of the three launchers; and every kernel
  wrapper's meta-device dispatch (the plain version's shapes, no
  launch).

Also runnable as a script: ``python tests/test_torch_dryrun.py
--reference OUT.json TMPDIR`` writes the reference's ledgers.
"""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TEN = ("zamba2-1.2b", "phi-3-vision-4.2b", "arctic-480b", "whisper-tiny",
       "granite-moe-3b-a800m", "falcon-mamba-7b", "deepseek-coder-33b",
       "yi-6b", "phi3-medium-14b", "llama3.2-1b")
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
# (seq_len, global_batch) of each shape at smoke size; a vision prefix
# adds its tokens to seq_len
SMALL = {"train_4k": (64, 8), "prefill_32k": (64, 4),
         "decode_32k": (64, 8), "long_500k": (128, 1)}
TOPO = {False: "data:cxl,model:cxl", True: "pod:cxl,data:cxl,model:cxl"}
# (arch, shape, multi_pod, backend): backend cxl and auto run under the
# mesh's topology (TOPO), ring under none; "full" is Llama-3.2-1B at full
# width at the shape's own sizes
RUNS = ([(a, s, False, "cxl") for a in TEN for s in SERVE_SHAPES]
        + [(a, "decode_32k", True, "cxl") for a in TEN]
        + [(a, s, mp, "ring") for a in ("llama3.2-1b", "granite-moe-3b-a800m",
                                        "zamba2-1.2b", "whisper-tiny")
           for s, mp in (("decode_32k", False), ("prefill_32k", True))]
        + [(a, s, False, "auto") for a in ("llama3.2-1b", "zamba2-1.2b",
                                           "granite-moe-3b-a800m")
           for s in ("prefill_32k", "decode_32k")]
        + [("full", "decode_32k", mp, b) for mp in (False, True)
           for b in ("ring", "cxl")]
        + [("full", "decode_32k", False, "auto")]
        + [("llama3.2-1b", "train_4k", False, "cxl")])


REPORT_RUN = ("llama3.2-1b", "decode_32k", False, "auto")
HLO_SAMPLE = "\n".join([
    "%a = f32[8,128]{1,0} all-gather(f32[4,128] %x), "
    "replica_groups={{0,1}}, dimensions={0}",
    "%b = bf16[64]{0} all-reduce(bf16[64] %y), replica_groups=[2,2]",
    "%c = f32[16]{0} reduce-scatter(f32[32] %z), replica_groups={{0,1}}",
    "%d = f32[4]{0} collective-permute(f32[4] %w), "
    "source_target_pairs={{0,1}}"])


def _key(arch, shape, mp, backend) -> str:
    return f"{arch}|{shape}|{int(mp)}|{backend}"


def _sizes(arch: str, shape: str, cfg) -> tuple:
    if arch == "full":
        return None, None
    seq, gb = SMALL[shape]
    if cfg.frontend != "text" and cfg.encoder is None:
        seq += cfg.frontend_tokens
    return seq, gb


def _aggregate(choices: list) -> list:
    """An auto audit summed by (primitive, bytes, ranks, backend, level):
    the reference books a scanned call site once with its trip count
    (``calls``), the port each call."""
    agg: dict = {}
    for c in choices:
        k = (c["primitive"], int(c["msg_bytes"]), int(c["nranks"]),
             c["backend"], c.get("level"))
        agg[k] = agg.get(k, 0.0) + float(c.get("calls", 1.0))
    return sorted([list(k) + [v] for k, v in agg.items()])


def _summary(snap: dict) -> dict:
    return {"wire_bytes": snap.get("wire_bytes"),
            "collective_calls": snap.get("collective_calls"),
            "level_wire_bytes": snap.get("level_wire_bytes"),
            "choices": _aggregate(snap.get("auto_choices") or [])}


# ---------------------------------------------------------------------- #
# the reference side
# ---------------------------------------------------------------------- #

def reference_main(out_path: str, tmp: str) -> None:
    os.environ["REPRO_DRYRUN_DEVICES"] = "8"
    from repro.launch import dryrun as rd      # before jax: the flags
    import jax

    from repro.configs import get_config
    from repro.core import ledger
    from repro.core.hw import CXL_POOL, INFINIBAND
    from repro.core.topology import (clear_active_topology, parse_topology,
                                     set_active_topology)
    from repro.tuner import activate_plan_file, clear_active_plan

    shapes = dict(rd.SHAPES)
    out = {}
    for arch, shape, mp, backend in RUNS:
        name = "llama3.2-1b" if arch == "full" else arch
        cfg = get_config(name, smoke=arch != "full")
        seq, gb = _sizes(arch, shape, cfg)
        rd.SHAPES[shape] = dict(shapes[shape]) if seq is None else dict(
            shapes[shape], seq_len=seq, global_batch=gb)
        rd.get_config = lambda _a, cfg=cfg: cfg
        clear_active_topology()
        clear_active_plan()
        if backend != "ring":
            set_active_topology(parse_topology(TOPO[mp]))
        if backend == "auto":
            activate_plan_file(os.path.join(tmp, "plan.json"),
                               pool=CXL_POOL, ib=INFINIBAND)
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model")) if mp \
            else jax.make_mesh((2, 2), ("data", "model"))
        fn, args, _ = rd.build_lowerable(name, shape, mesh, backend)
        ledger.reset()
        fn.lower(*args)
        snap = ledger.snapshot()
        out[_key(arch, shape, mp, backend)] = _summary(snap)
        if (arch, shape, mp, backend) == REPORT_RUN:
            out["report"] = {"auto_choices": snap["auto_choices"],
                             "plan_report": rd.plan_report(snap)}
    out["parse_collectives"] = rd.parse_collectives(HLO_SAMPLE)
    with open(out_path, "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------- #
# the port side
# ---------------------------------------------------------------------- #

def _port_run(arch, shape, mp, backend, plan_path) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.hw import CXL_POOL, INFINIBAND
    from repro_torch.core.topology import (clear_active_topology,
                                           parse_topology,
                                           set_active_topology)
    from repro_torch.launch import dryrun
    from repro_torch.tuner import activate_plan_file, clear_active_plan
    name = "llama3.2-1b" if arch == "full" else arch
    cfg = get_config(name, smoke=arch != "full")
    seq, gb = _sizes(arch, shape, cfg)
    clear_active_topology()
    clear_active_plan()
    try:
        if backend != "ring":
            set_active_topology(parse_topology(TOPO[mp]))
        if backend == "auto":
            activate_plan_file(plan_path, pool=CXL_POOL, ib=INFINIBAND)
        return dryrun.run_one(name, shape, mp, backend, None, seq_len=seq,
                              global_batch=gb, cfg=cfg)
    finally:
        clear_active_topology()
        clear_active_plan()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import tune
    tmp = str(tmp_path_factory.mktemp("torch_dryrun"))
    plan_path = os.path.join(tmp, "plan.json")
    tune.main(["--smoke", "--nranks", "2", "--topology", TOPO[False],
               "--quiet", "--out", plan_path])
    ref_path = os.path.join(tmp, "reference.json")
    env = dict(os.environ)
    env["REPRO_DRYRUN_DEVICES"] = "8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference", ref_path,
         tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        os.environ["REPRO_DRYRUN_DEVICES"] = "8"
        mine = {_key(*r): _port_run(*r, plan_path) for r in RUNS}
        log = ref.communicate(timeout=900)[0]
    finally:
        os.environ.pop("REPRO_DRYRUN_DEVICES", None)
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with open(ref_path) as f:
        reference = json.load(f)
    return mine, reference, tmp, plan_path


def _gated_norm(arch: str, shape: str, mp: bool) -> tuple:
    """The port's gated-norm AllReduces of a Zamba2 step on the model
    axis (2 ranks): one (B_local, L) f32 sum a Mamba-2 row; returns
    (rows, bytes each)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    seq, gb = _sizes(arch, shape, cfg)
    dp = 4 if mp else 2
    if shape == "prefill_32k":
        b, length = gb // dp, seq
    else:
        b, length = (gb // dp if gb >= dp else gb), 1
    return cfg.layer_pattern.count("2"), float(b * length * 4)


SERVE_RUNS = [r for r in RUNS if r[1] != "train_4k"]


@pytest.mark.parametrize("arch,shape,mp,backend", SERVE_RUNS)
def test_serve_ledgers_equal_the_reference(runs, arch, shape, mp, backend):
    """Prefill and decode: the port's ledger of one rank's step equals
    the reference's trace-time ledger (its scanned rows booked by trip
    count), level by level; Zamba2's has the port's gated-norm
    AllReduces on top; under ``auto`` the audits agree call for call."""
    mine, reference, _, _ = runs
    rec = mine[_key(arch, shape, mp, backend)]
    assert rec["status"] == "ok", rec.get("traceback")
    got, want = _summary(rec["ledger"]), reference[_key(arch, shape, mp,
                                                        backend)]
    if arch == "zamba2-1.2b":
        rows, s = _gated_norm(arch, shape, mp)
        ar = got["wire_bytes"]["all_reduce"] - rows * s
        assert ar == pytest.approx(want["wire_bytes"]["all_reduce"],
                                   rel=1e-12)
        assert got["collective_calls"]["all_reduce"] - rows == \
            want["collective_calls"]["all_reduce"]
        if backend == "auto":
            extra = [c for c in got["choices"] if c[0] == "all_reduce"
                     and c[1] == int(s) and c[4] == "model"]
            assert sum(c[5] for c in extra) >= rows
        for k in ("wire_bytes", "collective_calls"):
            got[k].pop("all_reduce")
            want[k].pop("all_reduce")
        for lv in ("level_wire_bytes",):
            for d in (got[lv], want[lv]):
                d.get("model/cxl", {}).pop("all_reduce", None)
        got["choices"] = want["choices"] = None
    assert got == want


def test_train_ledger_follows_the_reference_trip_counts(runs):
    """``train_4k`` of llama3.2-smoke on (data, model) = (2, 2), cxl on
    both levels: a rank's 4 sequences in microbatches of 2 (M = 2), its
    activations bf16 (the dry-run's params), the cross entropy f32.  The
    reference books everything inside ``value_and_grad`` three times
    (ROADMAP queue 3, PR 20): per microbatch, one more activation
    AllReduce of the embedding and of each row and two more f32 token
    AllReduces (the cross entropy's), two more gathers of the max, over
    the model axis; the FSDP gathers three times, as all-gathers, over
    the data axis, where the port books each once and its transpose as
    a reduce-scatter.  The grad sync is booked once by both, in f32 (the
    microbatches' grads summed in f32), and the loss mean's AllReduce
    once more a microbatch by the reference."""
    from repro_torch.configs import get_config
    mine, reference, _, _ = runs
    key = _key("llama3.2-1b", "train_4k", False, "cxl")
    rec = mine[key]
    assert rec["status"] == "ok", rec.get("traceback")
    got = rec["ledger"]["level_wire_bytes"]
    want = reference[key]["level_wire_bytes"]
    assert set(got) == set(want) == {"data/cxl", "model/cxl"}
    cfg = get_config("llama3.2-1b", smoke=True)
    seq, gb = SMALL["train_4k"]
    mb, rows = (gb // 2) // 2, 2                 # microbatches, their rows
    act = rows * seq * cfg.d_model * 2           # bf16, 2 (n-1)/n = 1
    tok = rows * seq * 4
    m, rm = got["model/cxl"], want["model/cxl"]
    assert rm["all_reduce"] == m["all_reduce"] + mb * (
        act * (1 + cfg.n_layers) + 2 * tok)
    assert rm["all_gather"] == m["all_gather"] + mb * 2 * tok
    assert rm["reduce_scatter"] == m["reduce_scatter"] > 0
    d, rd = got["data/cxl"], want["data/cxl"]
    assert d["reduce_scatter"] == d["all_gather"] > 0
    assert rd["all_gather"] == 3 * d["all_gather"]
    assert "reduce_scatter" not in rd
    # the grad sync (f32: both sum the microbatches' grads in f32) once,
    # the loss mean's f32 scalar three times a microbatch against twice
    assert rd["all_reduce"] == d["all_reduce"] + mb * 4
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0


def test_record_format(runs):
    """A port record carries the reference's keys but ``compile_s``
    (nothing compiles): ``lower_s`` the trace's seconds, ``memory`` the
    step's argument and output bytes, ``cost`` its FLOPs and aten-op
    bytes, ``collectives`` the ledger's in ``parse_collectives``' shape;
    the full-width decode's arguments are Llama-3.2-1B's TP-resident
    bf16 params and its (64, 16384) cache slice a rank."""
    mine, _, _, _ = runs
    rec = mine[_key("full", "decode_32k", False, "cxl")]
    assert rec["status"] == "ok"
    for k in ("arch", "shape", "mesh", "backend", "allreduce_mode",
              "bucket_mb", "prefetch", "ledger", "lower_s", "memory",
              "cost", "collectives", "params", "active_params"):
        assert k in rec, k
    assert "compile_s" not in rec and rec["collectives_source"] == "ledger"
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    col = rec["collectives"]
    assert col["wire_bytes"]["all-reduce"] == \
        rec["ledger"]["wire_bytes"]["all_reduce"]
    assert col["total_wire_bytes"] == rec["ledger"]["total_wire_bytes"]
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b")
    # the bf16 cache slice of a rank, every kv head, plus tokens and pos
    kv = cfg.n_layers * 2 * 64 * 16384 * cfg.n_kv_heads * cfg.head_dim * 2
    params = cfg.param_count(tp=2) // 2 * 2    # TP-resident bf16, roughly
    assert kv < rec["memory"]["argument_size_in_bytes"] < kv + 2 * params
    assert rec["params"] == cfg.param_count(tp=2)


def test_plan_report_and_parse_collectives_equal_the_reference(runs):
    """``plan_report`` of an ``auto`` audit and the copied
    ``parse_collectives`` on HLO lines give the reference's answers (its
    own, computed in its process on the same inputs)."""
    from repro_torch.launch import dryrun
    mine, reference, _, _ = runs
    ref = reference["report"]
    assert ref["auto_choices"]
    assert dryrun.plan_report({"auto_choices": ref["auto_choices"]}) == \
        ref["plan_report"]
    assert mine[_key(*REPORT_RUN)]["plan_report"]["backend_mix"]
    got = json.loads(json.dumps(dryrun.parse_collectives(HLO_SAMPLE)))
    assert got == reference["parse_collectives"]


def test_reference_consumers_read_a_port_record(runs):
    """The reference's ``CollectiveMix.from_dryrun`` and
    ``overlap_windows_from_dryrun`` read a port record as the port's do."""
    from repro import tuner as ref_tuner
    from repro_torch import tuner
    mine, _, _, _ = runs
    rec = json.loads(json.dumps(mine[_key(*REPORT_RUN)]))
    sizes = {"data": 2, "model": 2}
    a = tuner.CollectiveMix.from_dryrun(rec, sizes)
    b = ref_tuner.CollectiveMix.from_dryrun(rec, sizes)
    assert [(x.axis, x.size, [(c.primitive, c.msg_bytes, c.calls)
                              for c in x.calls]) for x in a.axes] == \
        [(x.axis, x.size, [(c.primitive, c.msg_bytes, c.calls)
                           for c in x.calls]) for x in b.axes]
    records = [json.loads(json.dumps(r)) for r in mine.values()
               if r["status"] == "ok"]
    hw = dict(peak_flops=989e12, hbm_bw=3.35e12)
    wa = tuner.overlap_windows_from_dryrun(records, **hw).per_primitive
    wb = ref_tuner.overlap_windows_from_dryrun(records, **hw).per_primitive
    assert wa.keys() == wb.keys() and wa
    for k in wa:
        assert wa[k] == pytest.approx(wb[k], rel=1e-12)


def test_placement_from_dryrun_matches_the_reference(runs, tmp_path):
    """``train --placement auto --placement-from-dryrun RECORD`` prices
    the record's audit (``CollectiveMix.from_dryrun``) and chooses what
    the reference's planner chooses from the same record."""
    from repro import tuner as ref_tuner
    from repro.core.topology import parse_topology as ref_parse
    from repro_torch.launch import train
    from repro_torch.models import sharding
    from repro_torch.core import topology
    mine, _, _, _ = runs
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(mine[_key(*REPORT_RUN)]))
    spec = "pod:cxl,node:cxl:3+1"
    try:
        got = train.spec_from_args(train.build_parser().parse_args(
            ["--arch", "llama3.2-1b", "--mesh", "4x1", "--batch", "4",
             "--device", "cpu", "--topology", spec, "--placement", "auto",
             "--placement-from-dryrun", str(path)]))
    finally:
        sharding.clear_axis_aliases()
        topology.clear_active_topology()
    mix = ref_tuner.CollectiveMix.from_dryrun(
        json.loads(path.read_text()), {"data": 4, "model": 1})
    chosen = ref_tuner.plan_placement(mix, ref_parse(spec)) \
        .best_with_unsplit(("model",))
    sizes, names, _ = ref_tuner.mesh_spec(chosen, mix, ref_parse(spec))
    assert got.mesh() == tuple(zip(names, sizes))


def test_overlap_from_dryrun_feeds_the_sweep(runs, capsys):
    """``tune --overlap-from-dryrun DIR`` derives its windows from the
    records there, as the reference's does, and tunes the cells that a
    window hides as overlapped; with ``--overlap-compute-us`` too it
    refuses."""
    from repro_torch.launch import tune
    mine, _, tmp, _ = runs
    d = os.path.join(tmp, "records")
    os.makedirs(d, exist_ok=True)
    for i, r in enumerate(mine.values()):
        with open(os.path.join(d, f"r{i}.json"), "w") as f:
            json.dump(r, f)
    plan = tune.main(["--smoke", "--nranks", "2", "--quiet",
                      "--overlap-from-dryrun", d,
                      "--out", os.path.join(tmp, "ov.json")])
    out = capsys.readouterr().out
    assert f"overlap windows from {len(mine)} dry-run records" in out
    assert any(c.overlap for c in plan.entries.values())
    with pytest.raises(SystemExit):
        tune.main(["--smoke", "--overlap-from-dryrun", d,
                   "--overlap-compute-us", "5"])


def test_cli_writes_reference_named_records(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the reduced mesh
    writes the reference's file name and a metrics stream."""
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--backend", "cxl",
         "--out", str(tmp_path), "--metrics-out",
         str(tmp_path / "m.jsonl")], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads((tmp_path / "whisper-tiny_decode_32k_pod16x16_cxl.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "pod16x16"
    assert (tmp_path / "m.prom").exists()
    assert "0 failures" in out.stdout


@pytest.mark.parametrize("launcher", ["train", "serve", "dryrun"])
def test_xla_overlap_is_refused(launcher):
    """``launch/xla.py`` has no counterpart: every launcher refuses
    ``--xla-overlap`` in one line."""
    from repro_torch import launch
    mod = __import__(f"repro_torch.launch.{launcher}",
                     fromlist=[launcher])
    argv = ["--arch", "llama3.2-1b", "--xla-overlap"]
    with pytest.raises(SystemExit) as err:
        if launcher == "train":
            mod.spec_from_args(mod.build_parser().parse_args(argv))
        else:
            mod.main(argv)
    assert str(err.value) == launch.XLA_REFUSAL
    assert "XLA flags have no meaning" in str(err.value)


def _meta_calls():
    import torch

    from repro_torch.kernels import chunked_reduce as cr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_collectives as fc
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss

    def m(*shape):
        return torch.empty(shape, device="meta")
    return {
        "rms_norm": (lambda: rn.rms_norm(m(6, 32), m(32), 1e-5), (6, 32)),
        "rms_norm_vjp": (lambda: rn.rms_norm_vjp(
            m(6, 32), m(32), 1e-5, m(6, 32))[0], (6, 32)),
        "flash_attention": (lambda: fa.flash_attention(
            m(1, 64, 2, 32), m(1, 64, 2, 32), m(1, 64, 2, 32)),
            (1, 64, 2, 32)),
        "flash_attention_train": (lambda: fa.flash_attention_train(
            m(1, 64, 2, 32).requires_grad_(), m(1, 64, 2, 32),
            m(1, 64, 2, 32)), (1, 64, 2, 32)),
        "chunked_reduce": (lambda: cr.chunked_reduce(m(3, 40)), (40,)),
        "all_gather_matmul": (lambda: fc.all_gather_matmul(
            m(5, 2 * 16), m(2, 16, 24)), (5, 24)),
        "ssm_scan": (lambda: ss.ssm_scan(
            m(1, 8, 4), m(1, 8, 4), m(4, 16), m(1, 8, 16), m(1, 8, 16),
            m(4)), (1, 8, 4)),
        "reduce_scatter_rmsnorm": (lambda: fc.reduce_scatter_rmsnorm(
            m(2, 6, 32), m(32)), (6, 32)),
    }


@pytest.mark.parametrize("name", ["rms_norm", "rms_norm_vjp",
                                  "flash_attention", "flash_attention_train",
                                  "chunked_reduce", "all_gather_matmul",
                                  "ssm_scan", "reduce_scatter_rmsnorm"])
def test_meta_tensors_take_the_shape_only_path(name):
    """A meta tensor takes the kernel's plain version, which only
    propagates shapes there: a meta result of the right shape, and no
    launch counted (the explicit ``device.type`` test of
    ``kernels.PLAIN_DEVICES``; a CUDA tensor still launches or raises,
    ``tests/test_torch_cuda.py``)."""
    from repro_torch.kernels import (chunked_reduce, flash_attention,
                                     rmsnorm)
    before = (rmsnorm.rms_norm.launches, rmsnorm.rms_norm_vjp.launches,
              flash_attention.flash_attention.launches,
              chunked_reduce.chunked_reduce.launches)
    fn, shape = _meta_calls()[name]
    out = fn()
    out = out[0] if isinstance(out, tuple) else out
    assert out.device.type == "meta" and tuple(out.shape) == shape
    assert (rmsnorm.rms_norm.launches, rmsnorm.rms_norm_vjp.launches,
            flash_attention.flash_attention.launches,
            chunked_reduce.chunked_reduce.launches) == before


def test_meta_exchanges_move_nothing():
    """On a meta mesh (no process group, no pool) every collective of
    the Communicator returns a meta result of the flat schedule's shape
    and books the bytes an executed call books, a grouped level's
    included."""
    import torch

    from repro_torch.core import ledger
    from repro_torch.core.api import Communicator
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch.mesh import make_meta_mesh
    x = torch.empty((4, 6), device="meta")
    for backend in ("ring", "cxl"):
        topo = parse_topology("pod:cxl,data:cxl:3+1")
        mesh = make_meta_mesh({"data": 4}, 1, topology=topo)
        comm = Communicator(backend=backend, axes=mesh, topology=topo)
        ledger.reset()
        assert comm.all_reduce(x, "data").shape == (4, 6)
        assert comm.all_gather(x, "data").shape == (16, 6)
        assert comm.reduce_scatter(x, "data").shape == (1, 6)
        assert comm.all_to_all(x, "data").shape == (4, 6)
        assert comm.broadcast(x, "data").shape == (4, 6)
        assert comm.all_max(x, "data").shape == (4, 6)
        snap = ledger.snapshot()
        assert set(snap["level_wire_bytes"]) == {"data/cxl", "pod/cxl"}
        flat = make_meta_mesh({"data": 2, "model": 2})
        comm = Communicator(backend=backend, axes=flat)
        for out in (comm.all_reduce(x, ("data", "model")),
                    comm.send(x, "model"), comm.gather(x, "data"),
                    comm.scatter(x, "model"), comm.reduce(x, "data")):
            assert out.device.type == "meta"


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:4])
    else:
        print(json.dumps({"usage": "--reference OUT.json TMPDIR"}))
        sys.exit(2)
