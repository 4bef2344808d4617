"""The port's disk checkpoints (``repro_torch.training.checkpoint``)
against the reference's (``repro.training.checkpoint``): the same
round trip, atomic save and mismatch behaviour, and checkpoints that
cross between the packages both ways, byte for byte, with identical
file names and ``tree.json`` paths.  Then the launchers: ``train
--ckpt`` on gloo CPU ranks at tp = 2 writes the GLOBAL params (the
ranks' final shards assembled), ``serve --ckpt`` restores a tp = 1
checkpoint (greedy tokens equal to an engine built from the trained
params), and both packages refuse a tp = 2 checkpoint whose vocabulary
was padded (Granite's odd vocabulary) in a tp = 1 serve."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.training import checkpoint


# -- the reference's cases (tests/test_substrates.py, test_resilience.py) --

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.float32)},
            "lst": [torch.zeros((2,)), torch.full((3,), 7.0)]}
    checkpoint.save(str(tmp_path), 42, tree, meta={"note": "x"})
    assert checkpoint.latest_step(str(tmp_path)) == 42
    like = {"a": torch.zeros((2, 3)), "nested": {"b": torch.zeros((4,))},
            "lst": [torch.zeros((2,)), torch.zeros((3,))]}
    restored = checkpoint.restore(str(tmp_path), 42, like)
    assert isinstance(restored["lst"], list)
    for a, b in ((tree["a"], restored["a"]),
                 (tree["nested"]["b"], restored["nested"]["b"]),
                 (tree["lst"][0], restored["lst"][0]),
                 (tree["lst"][1], restored["lst"][1])):
        np.testing.assert_array_equal(a.numpy(), b)
    assert checkpoint.load_meta(str(tmp_path), 42)["note"] == "x"


def test_checkpoint_structure_mismatch_raises(tmp_path):
    checkpoint.save(str(tmp_path), 0, {"a": torch.zeros((2,))})
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path), 0, {"a": torch.zeros((3,))})
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path), 0, {"b": torch.zeros((2,))})
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path), 0, {"a": torch.zeros((2,)),
                                              "b": torch.zeros((2,))})


def test_save_is_atomic_and_tmp_is_invisible(tmp_path):
    d = str(tmp_path)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    checkpoint.save(d, 4, tree, meta={"loss": 1.5})
    assert checkpoint.latest_step(d) == 4
    # an interrupted save leaves step_<n>.tmp: never a checkpoint
    (tmp_path / "step_00000009.tmp").mkdir()
    assert checkpoint.latest_step(d) == 4
    with pytest.raises(FileNotFoundError, match="interrupted"):
        checkpoint.restore(d, 9, tree)
    # a stale tmp from a process that died doesn't block a re-save
    checkpoint.save(d, 9, tree)
    assert checkpoint.latest_step(d) == 9
    got = checkpoint.restore(d, 9, tree)
    np.testing.assert_array_equal(got["w"], tree["w"])
    assert checkpoint.load_meta(d, 4)["loss"] == 1.5
    assert checkpoint.latest_step(str(tmp_path / "absent")) is None
    assert checkpoint._step_of("step_00000003.tmp") is None
    assert checkpoint._step_of("stranger") is None
    assert checkpoint._step_of("step_00000003") == 3


# -- interchange with the reference ---------------------------------------

def _reference_params(arch: str, tp: int, seed: int = 3):
    import jax

    from repro.configs import get_config
    from repro.models import model as jmodel
    return jmodel.init_params(jax.random.key(seed), get_config(arch,
                                                               smoke=True),
                              tp=tp)


def _files(path: str) -> dict:
    with open(os.path.join(path, "tree.json")) as f:
        paths = json.load(f)["paths"]
    with np.load(os.path.join(path, "arrays.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    return {"names": sorted(os.listdir(path)), "paths": paths,
            "arrays": arrays}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama3.2-1b",
                                  "zamba2-1.2b"])
def test_checkpoints_cross_between_the_packages(tmp_path, arch):
    """The reference's checkpoint of a model's params restores in the
    port byte for byte, and the port's restores through
    ``repro.training.checkpoint.restore``; both write the same file
    names, the same ``tree.json`` paths and the same arrays."""
    import jax

    from repro.training import checkpoint as jckpt
    from repro_torch.configs import get_config
    from repro_torch.models import model

    jparams = _reference_params(arch, 1)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(ref_dir, 7, {"params": jparams}, meta={"arch": arch})
    cfg = get_config(arch, smoke=True)
    params = model.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu", cfg, 1)
    checkpoint.save(port_dir, 7, {"params": params}, meta={"arch": arch})

    a = _files(os.path.join(ref_dir, "step_00000007"))
    b = _files(os.path.join(port_dir, "step_00000007"))
    assert a["names"] == b["names"] == ["arrays.npz", "meta.json",
                                        "tree.json"]
    assert a["paths"] == b["paths"]
    assert sorted(a["arrays"]) == sorted(b["arrays"])
    for k in a["arrays"]:
        assert a["arrays"][k].dtype == b["arrays"][k].dtype
        assert a["arrays"][k].tobytes() == b["arrays"][k].tobytes(), k
    assert checkpoint.load_meta(ref_dir, 7) == jckpt.load_meta(port_dir, 7)

    # the reference's checkpoint in the port, into the model's shapes
    got = checkpoint.restore(ref_dir, 7,
                             {"params": model.abstract_params(cfg, tp=1)})
    want = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in want:
        key = [p.key for p in path]
        arr = got["params"]
        for k in key:
            arr = arr[k]
        assert arr.tobytes() == np.asarray(leaf).tobytes(), key
    # the port's checkpoint in the reference
    back = jckpt.restore(port_dir, 7, {"params": jparams})
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


# -- the launchers -----------------------------------------------------------

def _assemble(cfg, tp: int, dp: int, per_rank: list) -> dict:
    """Rank r's shards (data r // tp, model r % tp) -> GLOBAL arrays by
    the port's param specs: model shards concatenated along the model
    dim inside data shards along the data dim."""
    from repro_torch.core import tree
    from repro_torch.models import model, sharding
    sharding.set_mesh_sizes({"data": dp, "model": tp})
    specs = sharding.param_specs(model.abstract_params(cfg, tp=tp), cfg,
                                 dp_axis="data")
    out = {}
    for path, spec in tree.leaves_with_paths(specs):
        key = "/".join(path)
        rows = []
        for d in range(dp):
            parts = [per_rank[d * tp + m][key] for m in range(tp)]
            rows.append(np.concatenate(parts, spec.index("model"))
                        if "model" in spec else parts[0])
        out[key] = np.concatenate(rows, spec.index("data")) \
            if "data" in spec else rows[0]
    return out


def _odd_vocab(arch: str):
    """The smoke model with an odd vocabulary, as Granite's 49155: at tp
    = 2 it pads to the next even size."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, vocab_size=cfg.vocab_size - 1)


def _train(tmp_path, cfg, tp: int, ckpt: str, steps: int = 2):
    from repro_torch.launch import train
    from repro_torch.training.train_loop import TrainConfig
    spec = train.RunSpec(
        arch=cfg.name, smoke=True, config=cfg,
        variants=(TrainConfig(lr=3e-4, warmup=0, total_steps=steps,
                              backend="cxl", clip_norm=None),
                  TrainConfig(lr=3e-4, warmup=0, total_steps=steps,
                              backend="ring", clip_norm=None)),
        steps=steps, batch=4, seq=16, dp=2, tp=tp, device="cpu",
        capture_params=True, ckpt=ckpt, timeout_s=120.0)
    return train.run_ranks(spec)


def test_train_ckpt_writes_the_global_params(tmp_path):
    """``train --ckpt`` at (data 2, model 2): the checkpoint at step
    ``steps`` holds the first variant's final shards assembled into the
    GLOBAL padded shapes of ``abstract_params(cfg, tp=2)``, bitwise."""
    from repro_torch.core import tree
    from repro_torch.models import model
    cfg = _odd_vocab("granite-moe-3b-a800m")
    ckpt = str(tmp_path / "ckpt")
    runs = _train(tmp_path, cfg, 2, ckpt)
    assert runs[0]["ckpt"] == os.path.join(ckpt, "step_00000002")
    assert checkpoint.latest_step(ckpt) == 2
    assert "ckpt" not in runs[1]
    want = _assemble(cfg, 2, 2, runs[0]["params"])
    like = {"params": model.abstract_params(cfg, tp=2)}
    got = checkpoint.restore(ckpt, 2, like)["params"]
    assert got["embed"]["tok"].shape[0] == cfg.vocab_size + 1
    for path, x in tree.leaves_with_paths(got):
        key = "/".join(path)
        assert x.tobytes() == want[key].tobytes(), key
        assert x.tobytes() == tree.get(runs[0]["global_params"],
                                       path).tobytes(), key
    # the other variant's params differ: the checkpoint is the first's
    other = _assemble(cfg, 2, 2, runs[1]["params"])
    assert any(not np.array_equal(other[k], want[k]) for k in want)


def test_serve_ckpt_restores_a_tp1_checkpoint(tmp_path):
    """``train --ckpt`` at (data 2, model 1), then ``serve --ckpt``:
    the engine's params are the checkpoint's, and its greedy tokens
    equal an engine's built from the trained params; ``--ckpt-step`` 0
    or unset takes the latest committed step, as the reference's
    ``args.ckpt_step or latest_step``."""
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b", smoke=True)
    ckpt = str(tmp_path / "ckpt")
    runs = _train(tmp_path, cfg, 1, ckpt)
    # an older step beside it, and a leftover of an interrupted save
    checkpoint.save(ckpt, 1, {"params": model.init_params(
        cfg, torch.Generator().manual_seed(1), "cpu")})
    (tmp_path / "ckpt" / "step_00000009.tmp").mkdir()
    trained = model.params_from_numpy(runs[0]["global_params"], "cpu",
                                      cfg, 1)
    ap = serve.build_parser()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    outs = []
    for step in (None, 0, 2):
        argv = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                "--ckpt", ckpt]
        if step is not None:
            argv += ["--ckpt-step", str(step)]
        _, eng = serve.engine_from_args(ap.parse_args(argv))
        for path, x in _leaves(eng.params):
            assert torch.equal(x, _get(trained, path)), path
        outs.append(eng.generate({"tokens": toks}, 4))
    want = ServeEngine(cfg, trained, ServeConfig(max_seq=20),
                       device="cpu").generate({"tokens": toks}, 4)
    for out in outs:
        np.testing.assert_array_equal(out, want)
    older = serve.restore_params(cfg, ckpt, 1, "cpu")
    assert any(not torch.equal(x, _get(trained, p))
               for p, x in _leaves(older))
    with pytest.raises(FileNotFoundError):
        serve.restore_params(cfg, str(tmp_path / "empty"), None, "cpu")


def _leaves(params):
    from repro_torch.core import tree
    return tree.leaves_with_paths(params)


def _get(params, path):
    from repro_torch.core import tree
    return tree.get(params, path)


def test_both_packages_refuse_a_tp2_checkpoint_in_a_tp1_serve(tmp_path):
    """A checkpoint trained at tp = 2 holds the vocabulary padded to a
    multiple of 2: restoring it into the unsharded model's shapes, as
    both serve launchers do, raises in both packages (no reshaping)."""
    import jax

    from repro.models import model as jmodel
    from repro.training import checkpoint as jckpt
    from repro_torch.launch import serve
    cfg = _odd_vocab("granite-moe-3b-a800m")
    ckpt = str(tmp_path / "ckpt")
    _train(tmp_path, cfg, 2, ckpt, steps=1)
    with pytest.raises(ValueError, match="shape"):
        serve.restore_params(cfg, ckpt, None, "cpu")
    from repro.configs import get_config as jget
    jcfg = dataclasses.replace(jget("granite-moe-3b-a800m", smoke=True),
                               vocab_size=cfg.vocab_size)
    like = {"params": jmodel.init_params(jax.random.key(0), jcfg, tp=1)}
    with pytest.raises(ValueError, match="shape"):
        jckpt.restore(ckpt, 1, like)


def test_full_granite_shapes_differ_between_tp1_and_tp2():
    """At full width Granite's 49155-token vocabulary pads to 49156 at tp
    = 2, so the card's tp = 2 checkpoint meets the same refusal; the
    parameter counts are the config's (which leaves out the norms' 2
    scales a row and the final one)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model
    cfg = get_config("granite-moe-3b")
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    count = {tp: sum(x.numel() for x in tree.leaves(
        model.abstract_params(cfg, tp=tp))) - norms for tp in (1, 2)}
    assert count == {1: 3_374_195_712, 2: 3_374_198_784}
    assert count == {tp: cfg.param_count(tp) for tp in (1, 2)}
    assert model.abstract_params(cfg, tp=2)["embed"]["tok"].shape == \
        (49156, 1536)
