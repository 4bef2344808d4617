"""The port's examples that run no model (``repro_torch.examples``:
``collective_bench``, ``timeline``, ``quickstart``, ``topology_workflow``,
``autotune_workflow``'s tuning) against the JAX package's
``examples/*.py`` on the CPU, and the last public names of the port
(``make_communicator``, ``MemmapCorpus`` / ``write_corpus``,
``load_dryrun_records``) against the reference's, with a diff of the two
packages' public names.

The framework-free examples print the reference's tables character for
character.  ``quickstart``'s part 3 runs on 4 gloo CPU ranks through the
shared pool (the reference's needs forced host devices and prints a hint
without them).  ``topology_workflow``'s ledger is held to the reference's
``Communicator`` driven over ``AbstractMesh((2, 2, 2), ...)``: the
reference's own example fails on this tree's jax (ROADMAP queue 3, pinned
here with its ``--start-pos`` usage line in ``serve_lm.py``)."""
import ast
import contextlib
import io
import os
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SRC = ROOT / "src"
PORT_EXAMPLES = ("autotune_workflow", "collective_bench", "quickstart",
                 "serve_lm", "timeline", "topology_workflow", "train_lm")


def _reference_stdout(name: str, argv: list) -> str:
    """``examples/<name>.py`` run in this process with ``argv``."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(EXAMPLES / f"{name}.py"),
                           run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


def _reference_stdout_alone(name: str, argv: list) -> str:
    """``examples/<name>.py`` in a process of its own on one host device
    (no ``XLA_FLAGS`` forcing more: a module of this run may have set
    them)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"),
                          *argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def _port_stdout(main, argv: list) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return buf.getvalue(), out


@pytest.mark.parametrize("argv", [
    [], ["--primitive", "all_to_all", "--nodes", "3", "6", "--sizes", "64",
         "256"],
    ["--primitive", "reduce_scatter", "--nodes", "4", "--sizes", "16",
     "--slicing", "8"]])
def test_collective_bench_prints_the_reference_table(argv):
    from repro_torch.examples import collective_bench
    got, out = _port_stdout(collective_bench.main, argv + ["--device",
                                                           "cpu"])
    assert got == _reference_stdout("collective_bench", argv)
    assert "\n".join(out["lines"]) + "\n" == got


@pytest.mark.parametrize("argv", [
    [], ["--primitive", "all_gather", "--nranks", "4", "--mib", "16",
         "--chunks", "1", "4"]])
def test_timeline_prints_the_reference_chart(argv):
    from repro_torch.examples import timeline
    got, out = _port_stdout(timeline.main, argv + ["--device", "cpu"])
    assert got == _reference_stdout("timeline", argv)
    assert set(out["total_s"]) == set(int(c) for c in argv[
        argv.index("--chunks") + 1:]) if argv else {1, 8}


def test_quickstart_parts_1_2_match_and_part_3_on_four_cpu_ranks():
    """Parts 1 and 2 print the reference's lines; part 3 AllReduces on 4
    gloo ranks through the pool under cxl, the numpy sum at rtol 1e-4
    (the example's own check; no kernel launches on the CPU)."""
    from repro_torch.examples import quickstart
    got, out = _port_stdout(quickstart.main, ["--device", "cpu"])
    ref = _reference_stdout_alone("quickstart", [])
    # the reference's part 3 needs forced host devices: on one its last
    # line is a hint in place of the port's result
    assert got.splitlines()[:-1] == ref.splitlines()[:-1]
    assert ref.splitlines()[-1].startswith("mesh backend: single device")
    assert got.splitlines()[-1].startswith(
        "mesh backend: cxl-scheduled AllReduce exact on 4 ranks")
    y = quickstart.part3_input(4)
    quickstart.check_allreduce(out["ranks"], y)
    assert [r["chunked_reduce_by_n"] for r in out["ranks"]] == [{}] * 4
    with pytest.raises(AssertionError):
        bad = [dict(r, out=r["out"] + 1e-2) for r in out["ranks"]]
        quickstart.check_allreduce(bad, y)


def test_topology_workflow_matches_the_reference_communicator():
    """Per-level wire bytes and per-level auto choices of the 16 MiB
    hierarchical AllReduce equal the reference's, whose Communicator is
    driven here over ``AbstractMesh((2, 2, 2), names)`` (its example's
    one-argument ``AbstractMesh`` fails on this jax)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import tuner as rtuner
    from repro.core import ledger as rledger
    from repro.core.api import Communicator as RComm
    from repro.core.hw import CXLPoolConfig, InfiniBandConfig, MiB
    from repro.core.topology import Level, Topology
    from repro_torch.examples import topology_workflow as tw

    got, out = _port_stdout(tw.main, ["--device", "cpu"])
    assert "\n".join(out["lines"]) + "\n" == got
    topo = Topology(levels=(
        Level("pod", "ib", ib=InfiniBandConfig(link_bw=12.5e9)),
        Level("node", "cxl", pool=CXLPoolConfig(device_bw=18e9)),
        Level("gpu", "ici")))
    grid = rtuner.TuneGrid(sizes=tuple(m * MiB for m in (1, 16, 64)),
                           nranks=(2,), slicing_factors=(1, 4))
    plan = rtuner.generate_plan(grid, topology=topo)
    assert out["plan_entries"] == len(plan.entries)
    comm = RComm(backend="auto", plan=plan)
    mesh = jax.sharding.AbstractMesh((2, 2, 2), ("pod", "node", "gpu"))
    axes = ("pod", "node", "gpu")
    rledger.reset()
    jax.eval_shape(jax.shard_map(
        lambda g: comm.all_reduce(g, axes), mesh=mesh, in_specs=P(axes),
        out_specs=P(axes), check_vma=False),
        jax.ShapeDtypeStruct((16 * MiB // 4, 1), jnp.float32))
    snap = rledger.snapshot()
    assert out["level_wire_bytes"] == {
        k: sum(v.values()) for k, v in snap["level_wire_bytes"].items()}
    keys = ("primitive", "msg_bytes", "nranks", "backend", "slicing_factor",
            "allreduce_mode", "level", "fabric")
    assert [tuple(c[k] for k in keys) for c in out["auto_choices"]] == \
        [tuple(c[k] for k in keys) for c in snap["auto_choices"]]
    # the printed choices: one line a decision, in the reference's format
    assert got.splitlines()[-len(snap["auto_choices"]):] == [
        f"  {c['primitive']:<15} level={c['level']:<5} "
        f"fabric={c['fabric']:<4} -> {c['backend']}"
        for c in snap["auto_choices"]]


def test_autotune_workflow_plan_lookups_and_audit_match_reference():
    """The smoke grid's plan has the reference's cells and choices (the
    port prices fused cells' hidden compute with the H100's roofline, so
    only their times move), the six lookups take the reference's
    choices, and the auto step of carried-across params gives the
    reference's loss and audits the reference's decisions; the port
    also audits the AllGathers' transposes (the gradient's
    reduce-scatters at the gathers' sizes), which the reference's
    trace-time audit does not see."""
    import jax
    import jax.numpy as jnp
    from repro import tuner as rtuner
    from repro.configs import get_config as rget
    from repro.core import ledger as rledger
    from repro.core.hw import MiB
    from repro.data.pipeline import SyntheticTokens as RTokens
    from repro.models import model as rmodel
    from repro.optim import adamw_init as radamw
    from repro.training.train_loop import TrainConfig as RTC
    from repro.training.train_loop import make_sharded_train_step as rstep
    from repro_torch.configs import get_config
    from repro_torch.examples import autotune_workflow as aw
    from repro_torch.models import model

    cfg = get_config("llama3.2-1b", smoke=True)
    rcfg = rget("llama3.2-1b", smoke=True)
    rparams = rmodel.init_params(jax.random.key(0), rcfg, tp=1,
                                 dtype=jnp.float32)
    params = model.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                     "cpu", cfg)
    lines: list = []
    out = aw.run(params, "cpu", say=lines.append)
    assert len(lines) == 1 + len(aw.LOOKUPS) + 2 + 4

    want = rtuner.generate_plan(rtuner.SMOKE_GRID)
    knobs = ("backend", "slicing_factor", "allreduce_mode", "fused",
             "overlap")
    assert out["plan"].fingerprint == want.fingerprint
    assert sorted(out["plan"].entries) == sorted(want.entries)
    for k, c in want.entries.items():
        assert [getattr(out["plan"].entries[k], f) for f in knobs] == \
            [getattr(c, f) for f in knobs], k
    for (prim, size), c in zip(aw.LOOKUPS, out["lookups"]):
        r = want.lookup(prim, size, 3)
        assert [getattr(c, f) for f in knobs] == \
            [getattr(r, f) for f in knobs], (prim, size)
    assert [(p, s // MiB) for p, s in aw.LOOKUPS] == [
        (p, s) for p in ("all_gather", "all_reduce", "broadcast")
        for s in (1, 256)]

    tcfg = RTC(backend="auto", plan_path=out["plan_path"], clip_norm=None,
               total_steps=2, warmup=0)
    rledger.reset()
    step, *_ = rstep(rcfg, tcfg, jax.make_mesh((1, 1), ("data", "model")))
    batch = {k: jnp.asarray(v) for k, v in next(iter(
        RTokens(rcfg, batch=2, seq=16))).items()}
    _, _, metrics = step(rparams, radamw(rparams), batch)
    np.testing.assert_allclose(out["loss"], float(metrics["loss"]),
                               rtol=1e-5)
    ref = rledger.snapshot()["auto_choices"]

    def cells(audit):
        return {(a["primitive"], a["msg_bytes"], a["nranks"], a["backend"])
                for a in audit}
    gathers = {c[1] for c in cells(ref) if c[0] == "all_gather"}
    mine = cells(out["auto_choices"])
    transposes = {c for c in mine if c[0] == "reduce_scatter"}
    assert transposes and {c[1] for c in transposes} <= gathers
    assert mine - transposes == cells(ref)
    # the four audit lines it prints are the reference's first four
    assert [(a["primitive"], a["msg_bytes"]) for a in
            out["auto_choices"][:4]] == [(a["primitive"], a["msg_bytes"])
                                         for a in ref[:4]]


def test_memmap_corpus_batches_bitwise_the_reference(tmp_path):
    """The same file and seed give the reference's batches bitwise
    (tokens beyond the vocabulary clipped, labels the shifted window),
    and the file ``write_corpus`` writes is byte for byte the
    reference's."""
    from repro.configs import get_config as rget
    from repro.data import pipeline as rpipe
    from repro_torch.configs import get_config
    from repro_torch.data import MemmapCorpus, write_corpus
    cfg, rcfg = get_config("llama3.2-1b", smoke=True), \
        rget("llama3.2-1b", smoke=True)
    toks = (np.arange(10_000) * 7919) % (cfg.vocab_size + 50)
    path, rpath = str(tmp_path / "c.bin"), str(tmp_path / "r.bin")
    write_corpus(path, toks)
    rpipe.write_corpus(rpath, toks)
    assert pathlib.Path(path).read_bytes() == pathlib.Path(rpath).read_bytes()
    for seed in (0, 3):
        it = iter(MemmapCorpus(cfg, path, batch=2, seq=32, seed=seed))
        rit = iter(rpipe.MemmapCorpus(rcfg, path, batch=2, seq=32,
                                      seed=seed))
        for _ in range(3):
            b, rb = next(it), next(rit)
            assert b.keys() == rb.keys()
            for k in b:
                assert b[k].dtype == rb[k].dtype
                np.testing.assert_array_equal(b[k], rb[k])
            np.testing.assert_array_equal(b["tokens"][:, 1:],
                                          b["labels"][:, :-1])
            assert b["tokens"].max() < cfg.vocab_size
    write_corpus(path, np.arange(16))
    with pytest.raises(ValueError, match="shorter than one sample"):
        MemmapCorpus(cfg, path, batch=2, seq=32)


def test_data_package_exports_the_reference_names():
    import repro.data as rdata
    import repro_torch.data as pdata
    assert set(rdata.__all__) - set(pdata.__all__) == {"make_batch_specs"}
    for name in pdata.__all__:
        assert getattr(pdata, name) is not None


def test_make_communicator_equals_communicator():
    from repro_torch.core.api import Communicator, make_communicator
    from repro_torch.core.topology import parse_topology
    from repro_torch.tuner import SMOKE_GRID, generate_plan
    assert make_communicator() == Communicator()
    topo = parse_topology("pod:cxl,data:ici")
    plan = generate_plan(SMOKE_GRID)
    kw = dict(slicing_factor=8, allreduce_mode="faithful", topology=topo)
    got = make_communicator("cxl", plan=plan, **kw)
    assert got == Communicator(backend="cxl", plan=plan, **kw)
    assert got.plan is plan and got.axes == {}
    with pytest.raises(ValueError):
        make_communicator("nccl")


def test_load_dryrun_records_is_load_records(tmp_path):
    from repro.launch import tune as rtune
    from repro_torch.launch import tune
    assert tune.load_dryrun_records is tune.load_records
    (tmp_path / "a.json").write_text('{"x": 1}')
    (tmp_path / "b.json").write_text("not json")
    for path in (str(tmp_path), str(tmp_path / "*.json"),
                 str(tmp_path / "a.json")):
        assert tune.load_dryrun_records(path) == \
            rtune.load_dryrun_records(path)


def _public_names(path: pathlib.Path, imports: bool) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
        elif imports and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_") and not n.isupper()}


# what the port leaves out of the reference's public names, by design
BY_DESIGN = {
    "core/hw.py": {"TPUConfig"},                    # GPUConfig instead
    "data/pipeline.py": {"make_batch_specs"},       # JAX PartitionSpecs
    "launch/dryrun.py": {"build_lowerable", "batch_sds"},   # build_step
    "training/pipeline.py": {"pipeline_loss_fn"},   # forward / backward
}


def test_public_names_of_both_packages():
    """A diff of every module's public top-level functions, classes and
    names: the port has all of the reference's but the by-design ones,
    and every module but ``launch/xla.py``."""
    ref, port = SRC / "repro", SRC / "repro_torch"
    missing_files, missing = [], {}
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        twin = port / rel
        if not twin.exists():
            missing_files.append(rel)
            continue
        gone = _public_names(path, False) - _public_names(twin, True)
        if gone:
            missing[rel] = gone
    assert missing_files == ["launch/xla.py"]
    assert missing == BY_DESIGN


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_examples_refuse_the_card_without_one(name):
    """With no CUDA card, an example asked for the card (the default)
    raises before it runs anything: none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    with pytest.raises(SystemExit):
        mod.build_parser().parse_args(["--device", "tpu"])



def _run_reference_example(argv: list) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_reference_topology_workflow_fails_on_this_jax():
    """ROADMAP queue 3: ``examples/topology_workflow.py:43`` builds
    ``AbstractMesh((("pod", 2), ...))``, a signature this tree's jax no
    longer takes."""
    res = _run_reference_example(["examples/topology_workflow.py"])
    assert res.returncode == 1
    assert "AbstractMesh.__init__() missing 1 required positional " \
           "argument: 'axis_names'" in res.stderr


def test_reference_serve_lm_usage_names_a_flag_it_lacks():
    """ROADMAP queue 3: ``examples/serve_lm.py:7-8`` documents
    ``--start-pos 524280``, which its parser does not have; the port's
    docstring names only the flags its parser has."""
    res = _run_reference_example([
        "examples/serve_lm.py", "--arch", "falcon-mamba-7b", "--smoke",
        "--window", "64", "--start-pos", "524280"])
    assert res.returncode == 2
    assert "unrecognized arguments: --start-pos 524280" in res.stderr
    from repro_torch.examples import serve_lm
    assert "--start-pos" not in serve_lm.__doc__
    flags = {a for act in serve_lm.build_parser()._actions
             for a in act.option_strings}
    used = {w.rstrip("\\") for w in serve_lm.__doc__.split()
            if w.startswith("--")}
    assert used <= flags
