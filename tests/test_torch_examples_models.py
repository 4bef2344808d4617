"""The port's examples that run a model (``repro_torch.examples.train_lm``,
``serve_lm``) and ``training.train_loop.train`` against the JAX package's
on the CPU (``device="cpu"``: the kernels' plain versions), from the
reference's params carried across (``models.model.params_from_numpy``).

* ``train()`` against the reference's ``train()`` on llama3.2-smoke, 3
  steps of the same ``SyntheticTokens``: the logged losses (4 decimals)
  within rtol 1e-4, the last step's loss too, the lr equal;
* ``serve_lm``'s greedy tokens equal the reference engine's, on
  llama3.2-smoke and on falcon-mamba-smoke with ``--window 64``;
* ``train_lm``: ``CFG_100M`` field for field and its parameter count; one
  step at full width (batch 2 x 16 tokens) at one rank and on 4 gloo
  ranks over (data, model) = (2, 2) under cxl, spawned once for the
  module, from the same seed-0 params: step-0 losses within rtol 1e-4,
  and both checkpoints (GLOBAL shapes) read by the reference's
  ``checkpoint.restore``."""
import dataclasses
import pathlib
import re
import runpy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.models import model as rmodel
from repro_torch.configs import get_config
from repro_torch.models import model

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOG = re.compile(r"^step +(\d+) loss (\S+) lr (\S+) \(\S+s\)$")


def _carried(arch: str, smoke: bool = True) -> tuple:
    """The reference's params of ``arch`` (key 0) and the same as the
    port's on the CPU."""
    rcfg, cfg = rget(arch, smoke=smoke), get_config(arch, smoke=smoke)
    rparams = rmodel.init_params(jax.random.key(0), rcfg, tp=1,
                                 dtype=jnp.float32)
    return cfg, rcfg, rparams, model.params_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu", cfg)


def test_train_matches_reference_train():
    from repro.data.pipeline import SyntheticTokens as RTokens
    from repro.training.train_loop import TrainConfig as RTC
    from repro.training.train_loop import train as rtrain
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.training import TrainConfig, train
    cfg, rcfg, rparams, params = _carried("llama3.2-1b")
    kw = dict(lr=1e-3, warmup=1, total_steps=3)
    mine, ref = [], []
    before = {k: v.clone() for k, v in params["embed"].items()}
    p, opt, m = train(cfg, TrainConfig(**kw),
                      iter(SyntheticTokens(cfg, batch=2, seq=16)), 3,
                      params=params, log_every=1, log_fn=mine.append,
                      device="cpu")
    _, _, rm = rtrain(rcfg, RTC(**kw), iter(RTokens(rcfg, batch=2, seq=16)),
                      3, params=rparams, log_every=1, log_fn=ref.append)
    got = [LOG.match(line).groups() for line in mine]
    want = [LOG.match(line).groups() for line in ref]
    assert [g[0] for g in got] == [w[0] for w in want] == ["0", "1", "2"]
    np.testing.assert_allclose([float(g[1]) for g in got],
                               [float(w[1]) for w in want], rtol=1e-4)
    assert [g[2] for g in got] == [w[2] for w in want]
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-4)
    assert float(m["lr"]) == float(rm["lr"])
    assert opt.step == 3
    # the caller's params are copied, not updated
    for k, v in params["embed"].items():
        assert torch.equal(v, before[k])
    assert not torch.equal(p["embed"]["tok"], before["tok"])
    # logged every log_every steps and at the last
    few: list = []
    train(cfg, TrainConfig(**kw), iter(SyntheticTokens(cfg, batch=2,
                                                       seq=16)),
          3, params=params, log_every=2, log_fn=few.append, device="cpu")
    assert [LOG.match(line).group(1) for line in few] == ["0", "2"]


def test_train_makes_params_from_a_generator_and_refuses_no_card():
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.training import TrainConfig, train
    cfg = get_config("llama3.2-1b", smoke=True)
    data = SyntheticTokens(cfg, batch=2, seq=8)
    runs = [train(cfg, TrainConfig(), iter(data), 1, log_fn=lambda s: None,
                  generator=torch.Generator().manual_seed(s),
                  device="cpu")[0] for s in (0, 0, 1)]
    assert torch.equal(runs[0]["embed"]["tok"], runs[1]["embed"]["tok"])
    assert not torch.equal(runs[0]["embed"]["tok"], runs[2]["embed"]["tok"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(cfg, TrainConfig(), iter(data), 1)


@pytest.mark.parametrize("arch,argv", [
    ("llama3.2-1b", []),
    ("falcon-mamba-7b", ["--window", "64"]),
    ("llama3.2-1b", ["--batch", "2", "--prompt-len", "9",
                     "--new-tokens", "5"])])
def test_serve_lm_greedy_tokens_match_reference_engine(arch, argv):
    from repro.serving import ServeConfig as RServeConfig
    from repro.serving import ServeEngine as RServeEngine
    from repro_torch.examples import serve_lm
    cfg, rcfg, rparams, params = _carried(arch)
    args = serve_lm.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", *argv])
    lines: list = []
    out = serve_lm.run(cfg, params, args, say=lines.append)
    eng = RServeEngine(rcfg, rparams, RServeConfig(
        max_seq=args.prompt_len + args.new_tokens + 8, window=args.window,
        temperature=args.temperature))
    batch = serve_lm.make_batch(cfg, args.batch, args.prompt_len)
    want = eng.generate({k: jnp.asarray(v) for k, v in batch.items()},
                        max_new_tokens=args.new_tokens)
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))
    assert out["tokens"].shape == (args.batch, args.new_tokens)
    assert lines[0] == (f"arch={cfg.name} batch={args.batch} prompt="
                        f"{args.prompt_len} new={args.new_tokens} "
                        f"window={args.window}")
    assert lines[2] == f"first request: {np.asarray(want)[0].tolist()}"


def _reference_cfg_100m():
    return runpy.run_path(str(ROOT / "examples" / "train_lm.py"))["CFG_100M"]


def test_cfg_100m_matches_reference():
    from repro_torch.examples import train_lm
    ref = _reference_cfg_100m()
    mine = train_lm.CFG_100M
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for tp in (1, 2, 4):
        assert mine.param_count(tp) == ref.param_count(tp)
    args = train_lm.build_parser().parse_args([])
    assert (args.steps, args.batch, args.seq, args.lr, args.backend,
            args.tp, args.dp, args.device) == (300, 8, 256, 3e-4, "ring",
                                               1, 1, "cuda")
    assert train_lm.train_config(args).warmup == 20


@pytest.fixture(scope="module")
def full_width_runs(tmp_path_factory):
    """``train_lm`` at full width, one step of 2 x 16 tokens, from the
    seed-0 params on the CPU: at one rank, and on 4 gloo ranks over
    (data, model) = (2, 2) under cxl (one spawn)."""
    from repro_torch.examples import train_lm
    tmp = tmp_path_factory.mktemp("train_lm")
    common = ["--device", "cpu", "--steps", "1", "--batch", "2", "--seq",
              "16"]
    one = train_lm.main([*common, "--ckpt", str(tmp / "one")])
    tp = train_lm.main([*common, "--backend", "cxl", "--tp", "2", "--dp",
                        "2", "--ckpt", str(tmp / "tp")])
    yield {"one": one, "tp": tp, "dir": tmp}
    shutil.rmtree(tmp)          # 0.5 GB of f32 params a checkpoint


def _reference_restore(path, cfg) -> dict:
    from repro.training import checkpoint as rckpt
    like = jax.eval_shape(lambda: rmodel.init_params(
        jax.random.key(0), cfg, tp=1, dtype=jnp.float32))
    return rckpt.restore(str(path), 1, {"params": like})["params"]


@pytest.mark.parametrize("run", ["one", "tp"])
def test_train_lm_checkpoint_is_read_by_the_reference(full_width_runs, run):
    """The GLOBAL params the run returns are what the reference's
    ``checkpoint.restore`` reads from its checkpoint, bitwise, in the
    reference's model's shapes."""
    from repro_torch.core import tree
    got = full_width_runs[run]
    restored = _reference_restore(full_width_runs["dir"] / run,
                                  _reference_cfg_100m())
    flat = jax.tree_util.tree_leaves_with_path(restored)
    assert len(flat) == len(tree.leaves(got["params"]))
    for path, leaf in flat:
        mine = tree.get(got["params"], tuple(p.key for p in path))
        if isinstance(mine, torch.Tensor):
            mine = mine.detach().numpy()
        np.testing.assert_array_equal(np.asarray(leaf), mine)
    assert got["ckpt"].endswith("step_00000001")
    assert got["lines"][-1] == (f"checkpoint written to "
                                f"{full_width_runs['dir'] / run}"
                                f"/step_00000001")


def test_train_lm_tp2_dp2_step0_loss_equals_one_rank(full_width_runs):
    one, tp = full_width_runs["one"], full_width_runs["tp"]
    ref = _reference_cfg_100m()
    for run in (one, tp):
        assert run["lines"][0] == (
            f"model: llama-100m ({ref.param_count() / 1e6:.1f}M params), "
            f"backend={'cxl' if run is tp else 'ring'}")
    assert len(tp["losses"]) == len(one["losses"]) == 1
    np.testing.assert_allclose(tp["losses"][0], one["losses"][0],
                               rtol=1e-4)
    # the sharded path logs as the reference's loop: step, loss, seconds
    assert re.match(r"^step +0 loss \d+\.\d{4} \(\d+\.\ds\)$",
                    tp["lines"][-2])
    assert len(tp["record"]["steps"]) == 1
    assert tp["record"]["steps"][0]["lr"] == 0.0
    # one step: no step after the first to time
    assert tp["mean_step_s"] is None and one["mean_step_s"] is None
