"""The port's Mamba rows at tp > 1 against the JAX reference.

Module parity: ``models.ssm.mamba1_forward`` (``falcon-mamba-smoke``)
and ``mamba2_forward`` (``zamba2-smoke``) on a model axis of 2 and of 4
gloo CPU ranks, each rank holding its Megatron shards of one row
(``sharding.param_specs`` / ``shard_params``), under ``ring`` and
``cxl``.  The inputs are numpy arrays made from a seed.  Held to:

* the reference's UNSHARDED function (``repro.models.ssm``, one device):
  every rank's output (rtol 1e-4, atol 1e-5, as
  ``tests/test_torch_ssm.py`` holds the tp = 1 block: f32 matmul stacks
  and an associative scan against a sequential one, and here the
  row-parallel sums split in tp partial sums), and the gradients of
  ``sum(y * ct)`` (rtol 1e-4, atol 1e-5) - a sharded leaf's shards
  concatenated, a replicated leaf's (Mamba-2's ``in_bc``, ``conv_bc``)
  and the input's summed over the ranks, all divided by tp: each rank
  differentiates its own copy of the replicated output, and the
  transpose of the row-parallel AllReduce sums the tp cotangents;
* for Mamba-1, also the reference's ``shard_map``'d function on the same
  shards, rank by rank (a subprocess with forced host devices), at the
  same tolerances (the scans still differ).

The reference's sharded Mamba-2 is another function than its unsharded
one: its gated norm reduces over a rank's d_inner / tp channels
(``src/repro/models/ssm.py:219``).  ``test_reference_mamba2_sharded_
forward_differs`` measures that on the reference alone (each shard's
row through ``mamba2_forward``, summed as the model axis' AllReduce
would); the port's gated norm spans d_inner at every tp (ROADMAP queue
3).  Also: the GLOBAL param shapes and the decode-state shapes of both
packages at tp 2 and 4, and ``ssm_scan``'s launch geometry at the per-rank
shapes of Zamba2-1.2B and Falcon-Mamba-7B at tp 2.

Also runnable as a script: ``python tests/test_torch_ssm_tp.py
--reference OUT.npz`` writes the reference's results.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = {"1": "falcon-mamba-7b", "2": "zamba2-1.2b"}
B, L = 2, 16
ROW_RTOL, ROW_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TPS = (2, 4)
BACKENDS = ("ring", "cxl")
# the reference's sharded Mamba-2 against its unsharded one, as a share
# of the output's largest magnitude: above GAP_MIN with the gated norm,
# below NO_NORM_MAX with the norm replaced by ``x * scale``
GAP_MIN, NO_NORM_MAX = 0.1, 1e-5


def _row_params(kind: str, seed: int) -> dict:
    """One Mamba row's GLOBAL params (numpy f32, seeded): the smoke
    configs' shapes, every leaf away from its init constant so a wrong
    shard shows."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCHS[kind], smoke=True)
    s = cfg.ssm
    rng = np.random.default_rng(seed)
    d, di, n, k = cfg.d_model, s.expand * cfg.d_model, s.d_state, s.d_conv

    def dense(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)

    def near(shape, at, spread):
        return (at + spread * rng.standard_normal(shape)).astype(np.float32)

    if kind == "1":
        r = -(-d // 16)
        return {
            "in_x": dense(d, di), "in_z": dense(d, di),
            "conv_w": dense(di, k) * np.float32(np.sqrt(di / k)),
            "x_proj": dense(di, r + 2 * n), "dt_proj": dense(r, di),
            "dt_bias": near((di,), 0.0, 0.1),
            "A_log": (np.log(np.arange(1, n + 1, dtype=np.float32))[None]
                      + near((di, n), 0.0, 0.1)).astype(np.float32),
            "D": near((di,), 1.0, 0.1), "out_proj": dense(di, d)}
    nh = di // s.headdim
    return {
        "in_x": dense(d, di), "in_z": dense(d, di),
        "in_bc": dense(d, 2 * n), "in_dt": dense(d, nh),
        "conv_x": dense(di, k) * np.float32(np.sqrt(di / k)),
        "conv_bc": dense(2 * n, k) * np.float32(np.sqrt(2 * n / k)),
        "A_log": near((nh,), 0.0, 0.5), "D": near((nh,), 1.0, 0.1),
        "norm": near((di,), 1.0, 0.1), "out_proj": dense(di, d)}


def _inputs(kind: str) -> dict:
    """The row's params, its input x (B, L, d_model) and the cotangent
    ct of its output (seeded)."""
    from repro_torch.configs import get_config
    d = get_config(ARCHS[kind], smoke=True).d_model
    rng = np.random.default_rng(50 + int(kind))
    return {"params": _row_params(kind, 60 + int(kind)),
            "x": rng.standard_normal((B, L, d)).astype(np.float32),
            "ct": (rng.standard_normal((B, L, d)) / 8).astype(np.float32)}


# ---------------------------------------------------------------------- #
# the reference side (a subprocess with 4 forced host devices)
# ---------------------------------------------------------------------- #

def reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core.api import Communicator
    from repro.models import sharding, ssm
    from repro.models.pcontext import UNSHARDED, ParallelContext

    out = {}
    for kind, arch in ARCHS.items():
        cfg = get_config(arch, smoke=True)
        a = _inputs(kind)
        p = {k: jnp.asarray(v) for k, v in a["params"].items()}
        x, ct = jnp.asarray(a["x"]), jnp.asarray(a["ct"])
        fwd = ssm.mamba1_forward if kind == "1" else ssm.mamba2_forward

        def loss(pp, xx, pc, fwd=fwd, cfg=cfg, ct=ct):
            return jnp.sum(fwd(pp, xx, cfg, pc) * ct)

        y = fwd(p, x, cfg, UNSHARDED)
        gp, gx = jax.grad(loss, argnums=(0, 1))(p, x, UNSHARDED)
        out[f"{kind}|unsharded|y"] = np.asarray(y)
        out[f"{kind}|unsharded|gx"] = np.asarray(gx)
        for k, g in gp.items():
            out[f"{kind}|unsharded|g|{k}"] = np.asarray(g)
        if kind != "1":
            continue
        for tp in TPS:
            mesh = jax.make_mesh((tp,), ("model",),
                                 devices=jax.devices()[:tp])
            pc = ParallelContext(tp_axis="model", tp=tp,
                                 comm=Communicator(backend="ring"))
            sharding.set_mesh_sizes({"model": tp})
            specs = sharding.param_specs({"mamba": p}, cfg,
                                         fsdp=False)["mamba"]

            def body(pp, xx, pc=pc, fwd=fwd, cfg=cfg, loss=loss):
                yy = fwd(pp, xx, cfg, pc)
                g = jax.grad(loss, argnums=(0, 1))(pp, xx, pc)
                return jax.tree.map(lambda t: t[None], (yy, g))

            f = jax.jit(jax.shard_map(body, mesh=mesh,
                                      in_specs=(specs, P()),
                                      out_specs=P("model"),
                                      check_vma=False))
            ys, (gps, gxs) = jax.tree.map(np.asarray, f(p, x))
            for r in range(tp):
                key = f"{kind}|tp{tp}|{r}"
                out[f"{key}|y"] = ys[r]
                out[f"{key}|gx"] = gxs[r]
                for k, g in gps.items():
                    out[f"{key}|g|{k}"] = g[r]
    np.savez(out_path, **out)


# ---------------------------------------------------------------------- #
# the port's side (gloo CPU ranks)
# ---------------------------------------------------------------------- #

def _specs(kind: str, tp: int, params) -> dict:
    """The row's specs at ``tp`` (no FSDP), by ``sharding.param_specs``
    on the model tree's names."""
    from repro_torch.configs import get_config
    from repro_torch.models import sharding
    sharding.set_mesh_sizes({"model": tp})
    cfg = get_config(ARCHS[kind], smoke=True)
    return sharding.param_specs({"mamba": params}, cfg,
                                fsdp=False)["mamba"]


def port_rank(ctx, tp: int) -> dict:
    """Both rows on this rank of a model axis of ``tp`` ranks, under
    each backend: the output, and the gradients of ``sum(y * ct)`` with
    respect to this rank's param shards and the input."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.api import Communicator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding, ssm
    from repro_torch.models.pcontext import ParallelContext

    mesh = make_host_mesh((("model", tp),), ctx)
    out = {}
    for backend in BACKENDS:
        pc = ParallelContext(tp_axis="model", tp=tp, comm=Communicator(
            backend=backend, axes=mesh))
        for kind, arch in ARCHS.items():
            cfg = get_config(arch, smoke=True)
            a = _inputs(kind)
            full = {k: torch.from_numpy(v) for k, v in a["params"].items()}
            p = sharding.shard_params(full, _specs(kind, tp, full), None, 0,
                                      1, tp_axis="model",
                                      tp_rank=pc.tp_index(), tp=tp)
            for leaf in p.values():
                leaf.requires_grad_(True)
            x = torch.from_numpy(a["x"]).requires_grad_(True)
            fwd = ssm.mamba1_forward if kind == "1" else ssm.mamba2_forward
            y = fwd(p, x, cfg, pc)
            (y * torch.from_numpy(a["ct"])).sum().backward()
            key = f"{backend}|{kind}"
            out[f"{key}|y"] = y.detach().numpy()
            out[f"{key}|gx"] = x.grad.numpy()
            for k, leaf in p.items():
                out[f"{key}|g|{k}"] = leaf.grad.numpy()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch import ranks

    tmp = str(tmp_path_factory.mktemp("torch_ssm_tp"))
    ref_path = os.path.join(tmp, "reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", ref_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        mine = {tp: ranks.spawn(port_rank, tp, (tp,), device="cpu",
                                partition_bytes=1 << 20, timeout_s=120.0)
                for tp in TPS}
        log, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with np.load(ref_path) as f:
        reference = {k: f[k] for k in f.files}
    return mine, reference


def _rank_grads(rank_out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rank_out.items()
            if k.startswith(prefix)}


CASES = [(tp, backend, kind) for tp in TPS for backend in BACKENDS
         for kind in ARCHS]


@pytest.mark.parametrize("tp,backend,kind", CASES)
def test_forward_matches_unsharded_reference(results, tp, backend, kind):
    """Every rank's output is the reference's unsharded row's: Mamba-1
    through its row-parallel ``x_proj``, Mamba-2 through the gated norm
    over the whole d_inner."""
    mine, reference = results
    want = reference[f"{kind}|unsharded|y"]
    for r in range(tp):
        np.testing.assert_allclose(mine[tp][r][f"{backend}|{kind}|y"], want,
                                   rtol=ROW_RTOL, atol=ROW_ATOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("tp,backend,kind", CASES)
def test_grads_match_unsharded_reference(results, tp, backend, kind):
    """The ranks' gradients, assembled (a model-sharded leaf's shards
    concatenated along its model dim; a replicated leaf's and the
    input's summed over the ranks) and divided by tp, are ``jax.grad``
    of the reference's unsharded row."""
    mine, reference = results
    a = _inputs(kind)
    specs = _specs(kind, tp, a["params"])
    per_rank = [_rank_grads(mine[tp][r], f"{backend}|{kind}|g|")
                for r in range(tp)]
    want = _rank_grads(reference, f"{kind}|unsharded|g|")
    assert sorted(per_rank[0]) == sorted(want)
    for k in want:
        spec = specs[k]
        if "model" in spec:
            got = np.concatenate([g[k] for g in per_rank],
                                 axis=spec.index("model"))
        else:
            got = np.sum([g[k] for g in per_rank], axis=0)
        assert got.shape == want[k].shape, k
        np.testing.assert_allclose(got / tp, want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    gx = np.sum([mine[tp][r][f"{backend}|{kind}|gx"] for r in range(tp)],
                axis=0)
    np.testing.assert_allclose(gx / tp, reference[f"{kind}|unsharded|gx"],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("tp,backend", [(tp, b) for tp in TPS
                                        for b in BACKENDS])
def test_mamba1_matches_sharded_reference(results, tp, backend):
    """Mamba-1 rank by rank against the reference's ``shard_map``'d row
    on the same shards: output, param-shard and input gradients."""
    mine, reference = results
    for r in range(tp):
        pre = f"1|tp{tp}|{r}|"
        np.testing.assert_allclose(mine[tp][r][f"{backend}|1|y"],
                                   reference[pre + "y"], rtol=ROW_RTOL,
                                   atol=ROW_ATOL, err_msg=f"rank {r}")
        got = _rank_grads(mine[tp][r], f"{backend}|1|g|")
        want = _rank_grads(reference, pre + "g|")
        assert sorted(got) == sorted(want)
        got["x"] = mine[tp][r][f"{backend}|1|gx"]
        want["x"] = reference[pre + "gx"]
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg=f"rank {r} {k}")


def _reference_mamba2_by_shard(tp: int, norm=None) -> tuple:
    """The reference's Mamba-2 row on the zamba2-smoke inputs: unsharded,
    and sharded over ``tp`` as its ``shard_map`` computes it (each
    rank's row on its shards of ``in_x``, ``in_z``, ``in_dt``,
    ``conv_x``, ``A_log``, ``D``, ``norm`` and ``out_proj`` and the
    replicated ``in_bc`` and ``conv_bc``, its ``tp_all_reduce`` the sum
    of the rank's outputs).  ``norm`` replaces the reference's
    ``layers.rms_norm`` for the call."""
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import layers, ssm
    from repro.models.pcontext import UNSHARDED

    cfg = get_config(ARCHS["2"], smoke=True)
    a = _inputs("2")
    p, x = a["params"], jnp.asarray(a["x"])
    saved = layers.rms_norm
    if norm is not None:
        layers.rms_norm = norm
    try:
        whole = np.asarray(ssm.mamba2_forward(
            {k: jnp.asarray(v) for k, v in p.items()}, x, cfg, UNSHARDED))
        shard_dim = {"in_x": 1, "in_z": 1, "in_dt": 1, "conv_x": 0,
                     "A_log": 0, "D": 0, "norm": 0, "out_proj": 0}
        parts = []
        for r in range(tp):
            pr = {k: jnp.asarray(np.split(v, tp, axis=shard_dim[k])[r]
                                 if k in shard_dim else v)
                  for k, v in p.items()}
            parts.append(np.asarray(ssm.mamba2_forward(pr, x, cfg,
                                                       UNSHARDED)))
    finally:
        layers.rms_norm = saved
    return whole, np.sum(parts, axis=0)


@pytest.mark.parametrize("tp", TPS)
def test_reference_mamba2_sharded_forward_differs(tp):
    """A reference-side fault, measured on the reference alone: its
    sharded Mamba-2 row differs from its unsharded one by more than
    ``GAP_MIN`` of the output's largest magnitude, and with the gated
    norm replaced by ``x * scale`` the two agree within
    ``NO_NORM_MAX``: the norm over d_inner / tp channels alone makes the
    difference (ROADMAP queue 3)."""
    whole, sharded = _reference_mamba2_by_shard(tp)
    scale = float(np.max(np.abs(whole)))
    gap = float(np.max(np.abs(sharded - whole))) / scale
    assert gap > GAP_MIN, gap
    whole, sharded = _reference_mamba2_by_shard(
        tp, norm=lambda x, s, eps=1e-5: x * s)
    assert float(np.max(np.abs(sharded - whole))) / float(
        np.max(np.abs(whole))) < NO_NORM_MAX


@pytest.mark.parametrize("tp", TPS)
def test_port_mamba2_equals_reference_unsharded_not_sharded(results, tp):
    """The port's Mamba-2 row at tp 2 and 4 (ring) is the reference's
    unsharded row (within the row tolerance) and not its sharded
    one: the port's gated norm is the same function at every tp."""
    mine, _ = results
    whole, sharded = _reference_mamba2_by_shard(tp)
    scale = float(np.max(np.abs(whole)))
    for r in range(tp):
        got = mine[tp][r]["ring|2|y"]
        np.testing.assert_allclose(got, whole, rtol=ROW_RTOL, atol=ROW_ATOL)
        assert float(np.max(np.abs(got - sharded))) / scale > GAP_MIN


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("kind", list(ARCHS))
def test_global_and_state_shapes_match_reference(tp, kind):
    """``init_mamba1`` / ``init_mamba2`` through the whole model's
    GLOBAL params at ``tp`` (``model.abstract_params``) and
    ``mamba_state_shapes`` (a rank's decode state) equal the
    reference's, for the smoke and the full configs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import model as jax_model
    from repro.models import ssm as jax_ssm
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, ssm

    for smoke in (True, False):
        cfg = get_config(ARCHS[kind], smoke=smoke)
        jcfg = jax_get_config(ARCHS[kind], smoke=smoke)
        for batch in (1, 3):
            assert ssm.mamba_state_shapes(cfg, tp, batch, int(kind)) == \
                jax_ssm.mamba_state_shapes(jcfg, tp, batch, int(kind))
        if not smoke:
            continue
        want = jax.eval_shape(lambda: jax_model.init_params(
            jax.random.key(0), jcfg, tp=tp, dtype=jnp.float32))
        want = {"/".join(k.key for k in path): tuple(x.shape)
                for path, x in jax.tree_util.tree_leaves_with_path(want)}
        got = {"/".join(p): tuple(x.shape) for p, x in
               tree.leaves_with_paths(model.abstract_params(cfg, tp=tp))}
        assert got == want


@pytest.mark.parametrize("shape,headdim,want", [
    # Zamba2-1.2B at (data 2, model 2): a rank's 2 rows x its 32 heads of
    # 64 channels; 2 x 64 blocks of 32 channels fill 128 of 132 SMs
    ((2, 1024, 2048, 64), 64, (2, 4, 32, 256, 64, 2, 64, 1,
                               4096 / 132 / 32)),
    # Falcon-Mamba-7B's per-channel backward at tp 2: 4096 channels a rank
    ((2, 1024, 4096, 16), None, (2, 2, 32, 128, 128, 2, 128, 0,
                                 8192 / 132 / 64))])
def test_ssm_bwd_geometry_at_the_tp_shapes(shape, headdim, want):
    """The backward kernel's launch at the per-rank shapes of the SSM
    rows at tp 2 (``ssm_bwd_geometry``, as ``csrc/ssm_scan.cu`` sets
    it), and the forward's (``ssm_geometry``): the lanes a thread and
    the warps an SM it gives."""
    from repro_torch.kernels import ssm_scan as ss
    geo = ss.ssm_bwd_geometry(*shape, headdim)
    keys = ("k", "m", "channels", "threads", "blocks", "cluster", "grid",
            "head_slots", "fill")
    assert tuple(geo[k] for k in keys) == pytest.approx(want)
    # the forward: 4 lanes a thread; a rank's 2 rows of d channels give
    # the SMs the warps of the tp = 1 path's one row of 2 d
    b, l, d, n = shape
    fwd = ss.ssm_geometry(b, l, d, n)
    assert fwd["k"] == 4
    assert fwd == ss.ssm_geometry(1, l, 2 * d, n)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2])
    else:
        print("usage: --reference OUT.npz")
        sys.exit(2)
