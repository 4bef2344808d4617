"""The port's FSDP training path against the JAX reference: the same
numpy params and the same synthetic batches through
``repro_torch.launch.train.run_ranks`` (4 gloo CPU ranks, mesh 4x1) and
``repro.training.train_loop.make_sharded_train_step`` (shard_map over 4
forced host devices, run in a subprocess so the device count never leaks
into the test process).

Compared per variant (ring / cxl, with and without fused kernels, plus
microbatch accumulation and the per-leaf faithful-AllReduce path): the
loss of each of 3 steps (rtol 1e-4: two f32 stacks summing in different
orders, after two AdamW updates) and the synced grads of the first step
(rtol 1e-4, atol 1e-5).  The reference's synced grads are read back from
its first AdamW moment, mu = (1 - b1) * g from zero; comparing grads, not
post-AdamW params, keeps AdamW's sign-like first step from amplifying f32
ordering noise.

Also runnable as a script: ``python tests/test_torch_train.py
--reference OUT.npz PARAMS.npz`` writes the reference's numbers (what the
fixture does in its subprocess).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCH, STEPS, BATCH, SEQ, DP = "llama3.2-1b", 3, 8, 32, 4
B1 = 0.9
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

# name -> TrainConfig fields shared by both sides
VARIANTS = {
    "ring": dict(backend="ring"),
    "ring-fused": dict(backend="ring", fuse_kernels=True),
    "cxl": dict(backend="cxl"),
    "cxl-fused": dict(backend="cxl", fuse_kernels=True),
    "cxl-microbatches": dict(backend="cxl", microbatches=2),
    "cxl-per-leaf-faithful": dict(backend="cxl", bucket_mb=0.0, prefetch=0,
                                  allreduce_mode="faithful",
                                  slicing_factor=2),
}


def _tcfg_kwargs(fields: dict) -> dict:
    return dict(lr=3e-4, warmup=min(20, STEPS // 5), total_steps=STEPS,
                clip_norm=None, **fields)


def reference_main(out_path: str, params_path: str) -> None:
    """The reference side, in a process with 4 forced host devices."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data.pipeline import SyntheticTokens
    from repro.launch.mesh import dp_axes
    from repro.optim import adamw_init
    from repro.training.train_loop import (TrainConfig,
                                           make_sharded_train_step)

    cfg = get_config(ARCH, smoke=True)
    mesh = jax.make_mesh((DP, 1), ("data", "model"))
    with np.load(params_path) as f:
        flat = {k: f[k] for k in f.files}
    params0 = {}
    for k, v in flat.items():
        node = params0
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    out = {}
    for name, fields in VARIANTS.items():
        tcfg = TrainConfig(**_tcfg_kwargs(fields))
        step, _, _, _ = make_sharded_train_step(cfg, tcfg, mesh,
                                                dp_axis=dp_axes(mesh))
        params, opt = params0, adamw_init(params0)
        data = iter(SyntheticTokens(cfg, batch=BATCH, seq=SEQ))
        losses = []
        for i, b in zip(range(STEPS), data):
            b = {k: jnp.asarray(v) for k, v in b.items()}
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            if i == 0:
                for path, mu in jax.tree_util.tree_leaves_with_path(opt.mu):
                    key = "/".join(p.key for p in path)
                    out[f"{name}|grad|{key}"] = np.asarray(mu) / np.float32(
                        1 - B1)
        out[f"{name}|loss"] = np.asarray(losses)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import model as jax_model
    from repro_torch.launch import train
    from repro_torch.training.train_loop import TrainConfig

    tmp = tmp_path_factory.mktemp("torch_train")
    params_path = str(tmp / "params.npz")
    ref_path = str(tmp / "reference.npz")
    jparams = jax_model.init_params(jax.random.key(0),
                                    jax_get_config(ARCH, smoke=True), tp=1,
                                    dtype=jnp.float32)
    train.save_params_npz(jax.tree.map(np.asarray, jparams), params_path)

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", ref_path, params_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        spec = train.RunSpec(
            arch=ARCH, smoke=True,
            variants=tuple(TrainConfig(**_tcfg_kwargs(f))
                           for f in VARIANTS.values()),
            steps=STEPS, batch=BATCH, seq=SEQ, dp=DP, device="cpu",
            params_path=params_path, capture_grads=True, timeout_s=120.0)
        mine = dict(zip(VARIANTS, train.run_ranks(spec)))
        log, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with np.load(ref_path) as f:
        reference = {k: f[k] for k in f.files}
    return mine, reference


def _full_grads(run: dict) -> dict:
    """Every rank's step-0 grad shards -> full arrays via the specs."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, sharding

    cfg = get_config(ARCH, smoke=True)
    sharding.set_mesh_sizes({"data": DP, "model": 1})
    specs = sharding.param_specs(model.abstract_params(cfg), cfg,
                                 dp_axis="data")
    shards = [tree.from_paths([(tuple(k.split("/")), v)
                               for k, v in g.items()]) for g in run["grads"]]
    out = {}
    for path, spec in tree.leaves_with_paths(specs):
        parts = [tree.get(s, path) for s in shards]
        if "data" in spec:
            out["/".join(path)] = np.concatenate(parts,
                                                 axis=spec.index("data"))
        else:
            for p in parts[1:]:        # replicated: every rank agrees
                np.testing.assert_array_equal(p, parts[0])
            out["/".join(path)] = parts[0]
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_losses_match_reference(runs, variant):
    mine, reference = runs
    got = np.asarray([s["loss"] for s in mine[variant]["steps"]])
    want = reference[f"{variant}|loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]          # the loss falls over the steps


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_synced_grads_match_reference(runs, variant):
    mine, reference = runs
    got = _full_grads(mine[variant])
    prefix = f"{variant}|grad|"
    want = {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_cxl_moves_bytes_through_the_pool_and_ring_does_not(runs):
    mine, _ = runs
    for name, run in mine.items():
        pool = [s["pool_bytes"] for s in run["steps"]]
        if VARIANTS[name]["backend"] == "cxl":
            assert all(b > 0 for b in pool) and len(set(pool)) == 1, name
        else:
            assert pool == [0] * STEPS, name


def test_fused_variants_book_fused_gather_bytes(runs):
    """With fused kernels the matmul weights' gathers book into the
    ledger's fused split (as ``_mesh_runner.py`` checks for the
    reference); without, nothing does."""
    mine, _ = runs
    for name, run in mine.items():
        step = run["steps"][0]
        wire, fused = step["wire_bytes_rank0"], step["fused_bytes_rank0"]
        assert wire.get("all_gather", 0) > 0 and \
            wire.get("reduce_scatter", 0) > 0, name
        if VARIANTS[name].get("fuse_kernels"):
            assert 0 < fused.get("all_gather", 0) < wire["all_gather"], name
        else:
            assert not fused, name


def test_synthetic_batches_match_reference():
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import SyntheticTokens as JaxTokens
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens, local_batch

    ours = iter(SyntheticTokens(get_config(ARCH, smoke=True), BATCH, SEQ))
    theirs = iter(JaxTokens(jax_get_config(ARCH, smoke=True), BATCH, SEQ))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    rows = [local_batch(a, r, DP)["tokens"] for r in range(DP)]
    np.testing.assert_array_equal(np.concatenate(rows), a["tokens"])


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3])
    else:
        print(json.dumps({"usage": "--reference OUT.npz PARAMS.npz"}))
        sys.exit(2)
