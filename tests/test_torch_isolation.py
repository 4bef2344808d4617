"""The port stands alone: no module of ``repro_torch`` imports ``jax`` or
the ``repro`` package, and its entry points never fall back to the CPU
on their own."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules() -> list:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def test_every_module_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not "
            "None and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


OBS_MODULES = ("repro_torch.obs", "repro_torch.obs.metrics",
               "repro_torch.obs.trace", "repro_torch.obs.health",
               "repro_torch.obs.profile", "repro_torch.obs.session",
               "repro_torch.tuner.online", "repro_torch.launch.report")


def test_obs_and_online_modules_import_alone():
    """The observability and online re-tuning slice exists in the port
    and runs with ``jax`` and ``repro`` blocked: each module imports, and
    a tracer, a registry, a health monitor, an emulator, a session and an
    online tuner do their work, with nothing of either loaded."""
    code = ("import sys, json, tempfile, os\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {OBS_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch import obs, tuner\n"
            "from repro_torch.core.topology import parse_topology\n"
            "from repro_torch.launch import report\n"
            "topo = parse_topology('data:cxl,model:cxl')\n"
            "plan = tuner.generate_plan(tuner.SMOKE_GRID, topology=topo)\n"
            "emu = obs.StepEmulator(topology=topo, seed=0)\n"
            "c = dict(primitive='all_reduce', msg_bytes=1 << 20, nranks=2,"
            " backend='cxl', slicing_factor=4, allreduce_mode='two_phase',"
            " level='model', fabric='cxl', calls=1.0)\n"
            "d = tempfile.mkdtemp()\n"
            "s = obs.ObsSession(metrics_out=os.path.join(d, 'm.jsonl'),"
            " trace_out=os.path.join(d, 't.json'), log=None)\n"
            "ot = tuner.OnlineTuner(plan, retune_interval=1)\n"
            "for i in range(3):\n"
            "    with s.step_span(i):\n"
            "        t = emu.step_timings([c] * 3)\n"
            "    ot.observe_timings(t)\n"
            "    s.on_step(i, 0.1, timings=t)\n"
            "    ot.maybe_retune(i)\n"
            "s.finalize(snapshot={'wire_bytes': {'all_reduce': 1.0}})\n"
            "text = report.summarize(report.load_events("
            "os.path.join(d, 'm.jsonl')))\n"
            "assert 'steps: 3' in text and ot.calibration_export()['scales']\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not "
            "None and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_names(tree) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_no_jax_or_repro_import_statement(path):
    names = _imported_names(ast.parse((PKG / path).read_text()))
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, f"{path} imports {bad}"


def test_engine_without_device_refuses_cpu_fallback():
    """With no CUDA card and no explicit device="cpu", constructing the
    engine (or its params) raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serving import ServeConfig, ServeEngine
    cfg = get_config("llama3.2-1b", smoke=True)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, ServeConfig(max_seq=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, ServeConfig(max_seq=16), device="cpu")
    out = eng.generate({"tokens": np.ones((1, 4), np.int64)}, 2)
    assert out.shape == (1, 2)


def test_launcher_rejects_unported_flags(tmp_path):
    from repro_torch.launch import serve
    ap = serve.build_parser()
    # --online-retune and --metrics-out are ported: they parse, and the
    # launcher refuses --online-retune without --plan or with --trace,
    # as the reference's does
    args = ap.parse_args(["--arch", "llama3.2-1b", "--metrics-out", "x",
                          "--online-retune"])
    assert args.metrics_out == "x" and args.online_retune
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama3.2-1b", "--online-retune"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama3.2-1b", "--online-retune", "--plan",
                    "p.json", "--trace", "poisson"])
    # --ckpt / --ckpt-step are ported: they parse and reach the restore
    args = ap.parse_args(["--arch", "llama3.2-1b", "--smoke", "--device",
                          "cpu", "--ckpt", str(tmp_path), "--ckpt-step",
                          "3"])
    assert (args.ckpt, args.ckpt_step) == (str(tmp_path), 3)
    with pytest.raises(FileNotFoundError, match="step_00000003"):
        serve.engine_from_args(args)
    # --placement is ported (with --placement-axes): it parses
    args = ap.parse_args(["--arch", "llama3.2-1b", "--placement", "auto",
                          "--placement-axes", "data=4,model=1"])
    assert (args.placement, args.placement_axes) == \
        ("auto", "data=4,model=1")
    args = ap.parse_args(["--arch", "llama3.2-1b", "--smoke", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "3"])
    cfg, eng = serve.engine_from_args(args)
    assert eng.device.type == "cpu" and cfg.name == "llama3.2-smoke"


def test_serve_launcher_activates_the_topology(capsys):
    from repro_torch.core import topology
    from repro_torch.launch import serve
    try:
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "4", "--new-tokens",
                    "1", "--topology", "pod:cxl,data:ici"])
        active = topology.get_active_topology()
        assert [(lv.axis, lv.fabric) for lv in active.levels] == \
            [("pod", "cxl"), ("data", "ici")]
    finally:
        topology.clear_active_topology()
    assert "llama3.2-smoke" in capsys.readouterr().out


def test_unported_arch_names_the_roadmap():
    """whisper-tiny and phi-3-vision-4.2b resolve, every reference id
    does, and an unknown id raises naming the known ones: no module of
    ROADMAP queue 1 is left to port, so the message names no item."""
    from repro.configs import ALL_IDS
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in ("whisper-tiny", "phi-3-vision-4.2b"):
        assert get_config(arch).name == arch
        assert get_config(arch, smoke=True).frontend != "text"
    for arch in ALL_IDS:
        get_config(arch)
    with pytest.raises(KeyError, match="unknown arch 'no-such-model'") \
            as err:
        get_config("no-such-model")
    assert "item" not in str(err.value)
    assert all(a in str(err.value) for a in ARCH_IDS)


def test_train_entry_points_without_device_refuse_cpu_fallback():
    """The training and collectives launchers default to the card: with
    no card and no ``--device cpu`` they raise before spawning a rank."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.launch import collectives, train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collectives.main(["--sizes-mb", "1"])


def test_train_launcher_rejects_unported_flags_and_tp():
    from repro_torch.launch import train
    ap = train.build_parser()
    with pytest.raises(SystemExit):
        ap.parse_args(["--arch", "llama3.2-1b", "--pp-stages", "x"])
    # online re-tuning is ported: its flags parse and reach the spec
    assert train.spec_from_args(ap.parse_args(
        ["--arch", "llama3.2-1b", "--device", "cpu", "--backend", "auto",
         "--plan", "plan.json", "--online-retune"])).obs.online_retune
    # resilience is ported: its flags parse and reach the run's spec, and
    # the pipeline refuses the two the reference refuses with it
    for extra, want in (
            (["--resilience"], train.ResilSpec(resilience=True)),
            (["--fault-plan", "rank_death@2:rank=1"],
             train.ResilSpec(fault_plan="rank_death@2:rank=1")),
            (["--pool-ckpt-interval", "2"],
             train.ResilSpec(pool_ckpt_interval=2))):
        assert train.spec_from_args(ap.parse_args(
            ["--arch", "llama3.2-1b", "--device", "cpu", *extra])).resil \
            == want
        if extra[0] != "--pool-ckpt-interval":
            with pytest.raises(SystemExit, match="--pp-stages > 1"):
                train.spec_from_args(ap.parse_args(
                    ["--arch", "llama3.2-1b", "--device", "cpu",
                     "--pp-stages", "2", *extra]))
    # --ckpt is ported: it parses and reaches the run's spec
    assert train.spec_from_args(ap.parse_args(
        ["--arch", "llama3.2-1b", "--ckpt", "ckpt_dir", "--device",
         "cpu"])).ckpt == "ckpt_dir"
    # --placement is ported: it parses
    assert ap.parse_args(["--arch", "llama3.2-1b", "--placement",
                          "auto"]).placement == "auto"
    args = ap.parse_args(["--arch", "llama3.2-1b", "--backend", "auto",
                          "--plan", "plan.json"])
    assert train.tcfg_from_args(args).plan_path == "plan.json"
    # TP > 1 reaches the spec (``--mesh DPxTP``); the batch splits over
    # the data ranks only, so 2 rows fit DP 2 whatever TP
    spec = train.spec_from_args(ap.parse_args(
        ["--arch", "llama3.2-1b", "--mesh", "2x2", "--batch", "2",
         "--device", "cpu"]))
    assert (spec.dp, spec.tp) == (2, 2)
    with pytest.raises(SystemExit):
        train.spec_from_args(ap.parse_args(
            ["--arch", "llama3.2-1b", "--mesh", "4x2", "--batch", "2",
             "--device", "cpu"]))


def test_train_launcher_topology_and_multi_pod_reach_the_spec():
    from repro_torch.launch import train
    ap = train.build_parser()
    spec = train.spec_from_args(ap.parse_args(
        ["--arch", "llama3.2-1b", "--mesh", "4x1", "--device", "cpu",
         "--multi-pod", "--topology", "pod:cxl,data:ici"]))
    assert spec.multi_pod and spec.dp == 4
    assert [(lv.axis, lv.fabric) for lv in spec.topology.levels] == \
        [("pod", "cxl"), ("data", "ici")]
    spec = train.spec_from_args(ap.parse_args(
        ["--arch", "llama3.2-1b", "--device", "cpu"]))
    assert not spec.multi_pod and spec.topology is None
    with pytest.raises(ValueError, match="even"):
        train.spec_from_args(ap.parse_args(
            ["--arch", "llama3.2-1b", "--mesh", "3x1", "--batch", "6",
             "--device", "cpu", "--multi-pod"]))
