"""The port's FSDP training of the SSM models against the JAX reference:
``repro_torch.launch.train.run_ranks`` on 4 gloo CPU ranks (mesh 4x1)
for ``zamba2-smoke`` (Mamba-2 rows and the shared attention block) and
``falcon-mamba-smoke`` (Mamba-1 rows), against the reference's unsharded
``repro.training.train_loop.make_train_step`` called directly on the
whole batch, from the same numpy params (made by the reference) and the
same synthetic batches.

Variants: ring, cxl, cxl with fused kernels and auto (a plan written by
``repro_torch.launch.tune --smoke --nranks 4``), each under the
double-buffered prefetch (1) and without it (0).  Per variant: the loss
of each of 3 steps (rtol 1e-4) and the step-0 synced grads over DP
(rtol 1e-4, atol 1e-5; the reference's from its first AdamW moment, mu
/ (1 - b1); see ``test_synced_grads_match_reference``); zamba2-smoke's
loss falls (falcon-mamba-smoke's does, or does not, as the reference's
does).  The FSDP gathers of ``shared_a`` a step are the reference's
gather sites (the hook's calls in its trace of ``loss_fn``: one a shared
group under prefetch 1, one a shared occurrence under prefetch 0), the
remat replay gathering again under prefetch 0; the data level's
reduce-scatters are the transposes of the forward's gathers, so their
bytes equal the all-gathers' less the replays'.
"""
import os

import numpy as np
import pytest

ARCHS = ("zamba2-1.2b", "falcon-mamba-7b")
DP, STEPS, BATCH, SEQ = 4, 3, 4, 32
B1 = 0.9
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TUNED = "<the tuned plan>"     # stands for the fixture's plan path
VARIANTS = {f"{name}-p{p}": dict(fields, prefetch=p)
            for p in (1, 0) for name, fields in (
                ("ring", dict(backend="ring")),
                ("cxl", dict(backend="cxl")),
                ("cxl-fused", dict(backend="cxl", fuse_kernels=True)),
                ("auto", dict(backend="auto", plan_path=TUNED)))}
CASES = [(arch, v) for arch in ARCHS for v in VARIANTS]


def _tcfg_kwargs(fields: dict, plan_path: str) -> dict:
    """The launcher's TrainConfig (warm-up min(20, steps // 5), no
    clipping) with the variant's fields."""
    return dict(lr=3e-4, warmup=min(20, STEPS // 5), total_steps=STEPS,
                clip_norm=None, **{k: plan_path if v == TUNED else v
                                   for k, v in fields.items()})


def _reference(arch: str) -> dict:
    """The reference's unsharded step on the whole batch: losses, step-0
    grads, and its gather sites of ``shared_a`` per prefetch."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data.pipeline import SyntheticTokens
    from repro.models import model as jax_model
    from repro.models.pcontext import UNSHARDED
    from repro.optim import adamw_init
    from repro.training.train_loop import TrainConfig, make_train_step

    cfg = get_config(arch, smoke=True)
    params0 = jax_model.init_params(jax.random.key(7), cfg, tp=1,
                                    dtype=jnp.float32)
    step = jax.jit(make_train_step(cfg, TrainConfig(**_tcfg_kwargs(
        {}, ""))))
    params, opt = params0, adamw_init(params0)
    losses, grads = [], None
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for _, b in zip(
        range(STEPS), SyntheticTokens(cfg, batch=BATCH, seq=SEQ))]
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {"/".join(p.key for p in path):
                     np.asarray(mu) / np.float32(1 - B1)
                     for path, mu in jax.tree_util.tree_leaves_with_path(
                         opt.mu)}
    sites = {}
    for prefetch in (0, 1):
        seen = []

        def gather(key, p):
            seen.append(key)
            return p
        jax.eval_shape(lambda p: jax_model.loss_fn(
            p, batches[0], cfg, UNSHARDED, gather_fn=gather,
            prefetch=prefetch)[0], params0)
        sites[prefetch] = seen.count("shared_a")
    return {"params": jax.tree.map(np.asarray, params0),
            "losses": np.asarray(losses), "grads": grads, "sites": sites}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import train, tune
    from repro_torch.training.train_loop import TrainConfig

    tmp = str(tmp_path_factory.mktemp("torch_train_ssm"))
    plan_path = os.path.join(tmp, "plan.json")
    tune.main(["--smoke", "--nranks", str(DP), "--quiet", "--out",
               plan_path])
    mine, reference = {}, {}
    for arch in ARCHS:
        reference[arch] = _reference(arch)
        params_path = os.path.join(tmp, f"{arch}.npz")
        train.save_params_npz(reference[arch]["params"], params_path)
        spec = train.RunSpec(
            arch=arch, smoke=True,
            variants=tuple(TrainConfig(**_tcfg_kwargs(f, plan_path))
                           for f in VARIANTS.values()),
            steps=STEPS, batch=BATCH, seq=SEQ, dp=DP, device="cpu",
            params_path=params_path, capture_grads=True, timeout_s=300.0)
        for name, got in zip(VARIANTS, train.run_ranks(spec)):
            mine[arch, name] = got
    return mine, reference


def _full(arch: str, per_rank: list) -> dict:
    """Every rank's synced grad shards -> the GLOBAL arrays, by the
    launcher's own assembly."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import train
    from repro_torch.models import model, sharding
    cfg = get_config(arch, smoke=True)
    sharding.set_mesh_sizes({"data": DP, "model": 1})
    specs = sharding.param_specs(model.abstract_params(cfg), cfg,
                                 dp_axis="data")
    layouts = [{"specs": {"/".join(p): s
                          for p, s in tree.leaves_with_paths(specs)},
                "dp_axis": "data", "tp_axis": "model", "dp_index": r,
                "n_dp": DP, "tp_index": 0, "tp": 1} for r in range(DP)]
    full = train.assemble_params(per_rank, layouts)
    return {"/".join(p): x for p, x in tree.leaves_with_paths(full)}


@pytest.mark.parametrize("arch,variant", CASES)
def test_losses_match_reference(runs, arch, variant):
    mine, reference = runs
    got = np.asarray([s["loss"] for s in mine[arch, variant]["steps"]])
    want = reference[arch]["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # zamba2-smoke's loss falls over the 3 steps; falcon-mamba-smoke's
    # rises on its third batch in both packages (6.7198 -> 6.7603)
    assert (got[-1] < got[0]) == (want[-1] < want[0])
    if arch == "zamba2-1.2b":
        assert got[-1] < got[0]


@pytest.mark.parametrize("arch,variant", CASES)
def test_synced_grads_match_reference(runs, arch, variant):
    """The sharded step's synced grads, as the reference's own sharded
    step forms them, are the sum over the DP ranks of each rank's
    gradient of its rows' mean loss (the loss's dp mean hands every rank
    the whole cotangent): DP times the unsharded gradient of the whole
    batch's mean loss.  Divided by DP (exact in f32) they are held to
    the unsharded step's."""
    mine, reference = runs
    got = _full(arch, mine[arch, variant]["grads"])
    want = reference[arch]["grads"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k] / DP, want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("arch,variant", CASES)
def test_gathers_follow_the_reference_sites(runs, arch, variant):
    """``shared_a``'s gathers a step are the reference's sites (twice
    under prefetch 0: the remat replay gathers again); every gather of
    the forward transposes into one reduce-scatter of equal wire bytes,
    so the data level's reduce-scatter bytes are the all-gathers' less
    the replays'."""
    mine, reference = runs
    prefetch = VARIANTS[variant]["prefetch"]
    for s in mine[arch, variant]["steps"]:
        gathers = s["gathers_rank0"]
        sites = reference[arch]["sites"][prefetch]
        assert gathers.get("shared_a", 0) == sites * (2 - prefetch)
        if arch == "zamba2-1.2b":
            assert sites == 1
        wire = s["wire_bytes_rank0"]
        ag, rs = wire["all_gather"], wire["reduce_scatter"]
        if prefetch:
            assert ag == rs
        else:
            assert rs < ag < 2 * rs
