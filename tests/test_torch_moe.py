"""The port's Mixture-of-Experts layer and ``e`` rows against the JAX
reference (``repro.models.moe``, ``repro.models.blocks``).

* Unsharded (tp = 1, in this process): ``moe_forward`` of
  ``granite-moe-smoke`` and ``arctic-smoke`` (its dense residual MLP) on
  the same numpy params and input - output and auxiliary loss at rtol
  1e-5, the drop mask equal to the one the reference's routing gives
  (``jax.lax.top_k`` over its softmax, its capacity and cumsum rule) -
  and ``jax.grad`` of ``sum(out * ct) + aux`` against autograd; the
  whole model's loss and aux; prefill and drop-free decode of ``e`` rows
  (capacity = tokens x top_k) against the reference's, logits and caches
  at rtol 1e-4, atol 1e-5 (as ``tests/test_torch_model.py``).
* Expert parallel (tp = 2 and 4): each rank of the port's model axis
  (gloo CPU ranks, under ring and cxl) holds its experts and routes its
  own token slice; its output, aux and gradients against the
  reference's ``moe_forward`` inside ``shard_map`` over forced host
  devices (a subprocess), rank by rank.
* ``Communicator.all_to_all`` is differentiable: its gradient equals the
  explicit transpose (the exchange of the cotangent), under ring and
  cxl, with both directions booked in the ledger.

Also runnable as a script: ``python tests/test_torch_moe.py --reference
OUT.npz`` writes the reference's expert-parallel results.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = ("granite-moe-3b-a800m", "arctic-480b")
TPS = (2, 4)
BACKENDS = ("ring", "cxl")
B, L = 2, 16
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# the whole model's logits and caches, as tests/test_torch_model.py holds
# them (two stacks of f32 products summed in other orders)
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
A2A_ROWS = 6          # rows of each rank's all_to_all segment


def _inputs(arch: str, tp: int) -> dict:
    """Global numpy params of one MoE layer at ``tp`` (experts padded),
    its input and the output cotangent, from a seed."""
    from repro.configs import get_config
    cfg = get_config(arch, smoke=True)
    m = cfg.moe
    rng = np.random.default_rng(300 + tp + 10 * ARCHS.index(arch))
    d, f, e = cfg.d_model, m.expert_d_ff, m.padded_experts(tp)
    f32 = np.float32
    p = {"router": (rng.standard_normal((d, e)) / 16).astype(f32),
         "wg": (rng.standard_normal((e, d, f)) / 16).astype(f32),
         "wu": (rng.standard_normal((e, d, f)) / 16).astype(f32),
         "wd": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(f32)}
    if m.dense_residual_d_ff:
        g = m.dense_residual_d_ff
        p["dense"] = {
            "wg": (rng.standard_normal((d, g)) / 16).astype(f32),
            "wu": (rng.standard_normal((d, g)) / 16).astype(f32),
            "wd": (rng.standard_normal((g, d)) / np.sqrt(g)).astype(f32)}
    # a direction shared by every token that the router favours expert
    # 0 along: an unbalanced load, so the capacity drops pairs
    v = 0.1 * rng.standard_normal(d)
    p["router"][:, 0] += (v / 4).astype(f32)
    return {"params": p,
            "x": (rng.standard_normal((B, L, d)) + v).astype(f32),
            "ct": (rng.standard_normal((B, L, d)) / 8).astype(f32)}


def _reference_keep(xt, router, cfg, e_pad: int, capacity=None):
    """The drop mask of the reference's routing of tokens ``xt``: its
    softmax and ``jax.lax.top_k``, then its capacity and cumsum rule
    (``repro/models/moe.py:83-113``)."""
    import jax
    import jax.numpy as jnp
    m = cfg.moe
    t, k = xt.shape[0], m.top_k
    logits = jnp.asarray(xt) @ jnp.asarray(router)
    if e_pad != m.num_experts:
        logits = jnp.where(jnp.arange(e_pad)[None] >= m.num_experts,
                           -jnp.inf, logits)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    if capacity is None:
        capacity = max(1, int(t * k * m.capacity_factor) // e_pad)
    oh = jax.nn.one_hot(top_e, e_pad, dtype=jnp.int32).reshape(t * k, e_pad)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    return np.asarray(pos < capacity)


def _tree(jtree) -> dict:
    import jax
    return jax.tree.map(np.asarray, jtree)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------- #
# the reference's expert-parallel side (a subprocess, 8 host devices)
# ---------------------------------------------------------------------- #

def reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core.api import Communicator
    from repro.models import moe, sharding
    from repro.models.pcontext import ParallelContext

    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        for tp in TPS:
            a = _inputs(arch, tp)
            params = jax.tree.map(jnp.asarray, a["params"])
            x, ct = jnp.asarray(a["x"]), jnp.asarray(a["ct"])
            mesh = jax.make_mesh((tp,), ("model",),
                                 devices=jax.devices()[:tp])
            pc = ParallelContext(tp_axis="model", tp=tp,
                                 comm=Communicator(backend="ring"))
            sharding.set_mesh_sizes({"model": tp})
            pspecs = sharding.param_specs({"moe": params}, cfg,
                                          fsdp=False)["moe"]

            def body(p, xx):
                def f(pp, z):
                    y, aux = moe.moe_forward(pp, z, cfg, pc)
                    return jnp.sum(y * ct) + aux, (y, aux)
                (_, (y, aux)), (gp, gx) = jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True)(p, xx)
                return jax.tree.map(lambda t: t[None], (y, aux, gp, gx))

            fn = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(pspecs, P()),
                out_specs=P("model"), check_vma=False))
            y, aux, gp, gx = _tree(fn(params, x))
            for r in range(tp):
                key = f"{arch}|tp{tp}|{r}"
                out[f"{key}|y"] = y[r]
                out[f"{key}|aux"] = aux[r]
                out[f"{key}|gx"] = gx[r]
                for k, v in _flat(gp).items():
                    out[f"{key}|g|{k}"] = v[r]
                # the drop mask of this rank's token slice
                t = B * L // tp
                xt = a["x"].reshape(B * L, -1)[r * t:(r + 1) * t]
                out[f"{key}|keep"] = _reference_keep(
                    xt, a["params"]["router"], cfg,
                    cfg.moe.padded_experts(tp))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------- #
# the port's side (gloo CPU ranks)
# ---------------------------------------------------------------------- #

def _a2a_input(n: int, rank: int) -> np.ndarray:
    rng = np.random.default_rng(40 + 10 * n + rank)
    return rng.integers(-8, 8, (n * A2A_ROWS, 3)).astype(np.float32)


def _a2a_ct(n: int, rank: int) -> np.ndarray:
    rng = np.random.default_rng(80 + 10 * n + rank)
    return rng.integers(-8, 8, (n * A2A_ROWS, 3)).astype(np.float32)


def port_rank(ctx, tp: int) -> dict:
    """Every arch's MoE layer on this rank of a model axis of ``tp``
    ranks, under each backend, and the all_to_all's gradient."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import ledger
    from repro_torch.core import tree as tree_mod
    from repro_torch.core.api import Communicator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe, sharding
    from repro_torch.models.pcontext import ParallelContext

    mesh = make_host_mesh((("model", tp),), ctx)
    sharding.set_mesh_sizes({"model": tp})
    out = {}
    for backend in BACKENDS:
        comm = Communicator(backend=backend, axes=mesh)
        pc = ParallelContext(tp_axis="model", tp=tp, comm=comm)
        rank = pc.tp_index()
        for arch in ARCHS:
            cfg = get_config(arch, smoke=True)
            a = _inputs(arch, tp)
            full = {"moe": tree_mod.map_with_path(
                lambda _p, v: torch.from_numpy(v), a["params"])}
            specs = sharding.param_specs(full, cfg, fsdp=False)
            p = sharding.shard_params(full, specs, None, 0, 1,
                                      tp_axis="model", tp_rank=rank,
                                      tp=tp)["moe"]
            leaves = tree_mod.leaves_with_paths(p)
            for _, v in leaves:
                v.requires_grad_(True)
            x = torch.from_numpy(a["x"]).requires_grad_(True)
            y, aux = moe.moe_forward(p, x, cfg, pc)
            ((y * torch.from_numpy(a["ct"])).sum() + aux).backward()
            key = f"{backend}|{arch}"
            out[f"{key}|y"] = y.detach().numpy()
            out[f"{key}|aux"] = aux.detach().numpy()
            out[f"{key}|gx"] = x.grad.numpy()
            for path, v in leaves:
                out[f"{key}|g|" + "/".join(path)] = v.grad.numpy()
            t = B * L // tp
            xt = torch.from_numpy(a["x"]).reshape(B * L, -1)
            out[f"{key}|keep"] = moe.route(
                xt[rank * t:(rank + 1) * t], p["router"], cfg,
                cfg.moe.padded_experts(tp))["keep"].numpy()
        # the all_to_all and its autograd transpose
        x = torch.from_numpy(_a2a_input(tp, rank)).requires_grad_(True)
        ledger.reset()
        y = comm.all_to_all(x, "model")
        (y * torch.from_numpy(_a2a_ct(tp, rank))).sum().backward()
        out[f"{backend}|a2a|y"] = y.detach().numpy()
        out[f"{backend}|a2a|gx"] = x.grad.numpy()
        out[f"{backend}|a2a|wire"] = ledger.snapshot()["wire_bytes"]
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch import ranks

    tmp = str(tmp_path_factory.mktemp("torch_moe"))
    ref_path = os.path.join(tmp, "reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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


EP_CASES = [(arch, tp, backend) for arch in ARCHS for tp in TPS
            for backend in BACKENDS]


@pytest.mark.parametrize("arch,tp,backend", EP_CASES)
def test_expert_parallel_forward_matches_reference(results, arch, tp,
                                                   backend):
    """Every rank's output (its token slice gathered back: the whole
    (B, L, d)), aux (over its own slice) and drop mask equal the
    reference's rank's."""
    mine, reference = results
    for r in range(tp):
        got, pre = mine[tp][r], f"{arch}|tp{tp}|{r}"
        np.testing.assert_allclose(got[f"{backend}|{arch}|y"],
                                   reference[f"{pre}|y"], rtol=FWD_RTOL,
                                   atol=FWD_ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{backend}|{arch}|aux"],
                                   reference[f"{pre}|aux"], rtol=FWD_RTOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[f"{backend}|{arch}|keep"],
                                      reference[f"{pre}|keep"])
    # the capacity drops some (token, slot) pairs at this size
    assert not all(mine[tp][r][f"{backend}|{arch}|keep"].all()
                   for r in range(tp))


@pytest.mark.parametrize("arch,tp,backend", EP_CASES)
def test_expert_parallel_grads_match_reference(results, arch, tp, backend):
    """Gradients of sum(out * ct) + aux with respect to every rank's
    expert shards, its replicated router (and dense residual shards) and
    its input, through the AllToAlls' and the AllGather's transposes."""
    mine, reference = results
    for r in range(tp):
        pre = f"{backend}|{arch}|g|"
        got = {k[len(pre):]: v for k, v in mine[tp][r].items()
               if k.startswith(pre)}
        rpre = f"{arch}|tp{tp}|{r}|g|"
        want = {k[len(rpre):]: v for k, v in reference.items()
                if k.startswith(rpre)}
        assert sorted(got) == sorted(want)
        got["x"] = mine[tp][r][f"{backend}|{arch}|gx"]
        want["x"] = reference[f"{arch}|tp{tp}|{r}|gx"]
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("tp,backend", [(tp, b) for tp in TPS
                                        for b in BACKENDS])
def test_all_to_all_gradient_is_its_transpose(results, tp, backend):
    """y = all_to_all(x): rank q's segment p of y is rank p's segment q
    of x, so d sum(y * ct) / dx on rank q, segment p, is rank p's ct
    segment q - the exchange of the cotangent.  Both directions book
    s (n - 1) / n wire bytes each."""
    mine, _ = results
    xs = [np.split(_a2a_input(tp, r), tp) for r in range(tp)]
    cts = [np.split(_a2a_ct(tp, r), tp) for r in range(tp)]
    s = tp * A2A_ROWS * 3 * 4
    for q in range(tp):
        got = mine[tp][q]
        np.testing.assert_array_equal(
            got[f"{backend}|a2a|y"],
            np.concatenate([xs[p][q] for p in range(tp)]))
        np.testing.assert_array_equal(
            got[f"{backend}|a2a|gx"],
            np.concatenate([cts[p][q] for p in range(tp)]))
        assert got[f"{backend}|a2a|wire"] == {
            "all_to_all": 2 * s * (tp - 1) / tp}


# ---------------------------------------------------------------------- #
# unsharded (tp = 1), in this process
# ---------------------------------------------------------------------- #

def _both(arch: str):
    import torch

    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    a = _inputs(arch, 1)
    tparams = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                   {kk: torch.from_numpy(vv) for kk, vv in v.items()})
               for k, v in a["params"].items()}
    return jget(arch, smoke=True), get_config(arch, smoke=True), a, tparams


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_forward_and_grads_match_reference(arch):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import moe as jmoe
    from repro.models.pcontext import ParallelContext as JPC
    from repro_torch.core import tree as tree_mod
    from repro_torch.models import moe
    from repro_torch.models.pcontext import UNSHARDED

    jcfg, cfg, a, p = _both(arch)
    jp = jax.tree.map(jnp.asarray, a["params"])
    ct = jnp.asarray(a["ct"])

    def f(pp, z):
        y, aux = jmoe.moe_forward(pp, z, jcfg, JPC())
        return jnp.sum(y * ct) + aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(a["x"]))

    for _, v in tree_mod.leaves_with_paths(p):
        v.requires_grad_(True)
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    ty, taux = moe.moe_forward(p, x, cfg, UNSHARDED)
    ((ty * torch.from_numpy(a["ct"])).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(float(taux.detach()), float(aux), rtol=FWD_RTOL)
    keep = moe.route(x.detach().reshape(B * L, -1), p["router"].detach(),
                     cfg, cfg.moe.num_experts)["keep"].numpy()
    want_keep = _reference_keep(a["x"].reshape(B * L, -1),
                                a["params"]["router"], jcfg,
                                jcfg.moe.num_experts)
    np.testing.assert_array_equal(keep, want_keep)
    assert not keep.all()      # some pairs dropped at capacity 1.25
    want = _flat(_tree(gp))
    got = {"/".join(k): v.grad.numpy()
           for k, v in tree_mod.leaves_with_paths(p)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _model_pair(arch: str):
    import jax

    from repro.configs import get_config as jget
    from repro.models import model as jmodel
    from repro_torch.configs import get_config
    from repro_torch.models import model
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    jparams = jmodel.init_params(jax.random.key(5), jcfg, tp=1)
    params = model.params_from_numpy(_tree(jparams), "cpu", cfg, 1)
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_with_aux_matches_reference(arch):
    """``loss_fn`` returns xent + aux with the reference's aux dict, the
    rows' router losses summed once each (remat on, as in training), and
    the same gradient of the whole loss."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import model as jmodel
    from repro.models.pcontext import ParallelContext as JPC
    from repro_torch.core import tree as tree_mod
    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED

    jcfg, cfg, jparams, params = _model_pair(arch)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, L)),
             "labels": rng.integers(0, cfg.vocab_size, (B, L))}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, jcfg, JPC()),
        has_aux=True)(jparams)
    for _, v in tree_mod.leaves_with_paths(params):
        v.requires_grad_(True)
    loss, aux = model.loss_fn(params, {k: torch.from_numpy(v) for k, v in
                                       batch.items()}, cfg, UNSHARDED,
                              remat=True)
    loss.backward()
    assert sorted(aux) == sorted(jaux) == ["aux", "xent"]
    for k in ("aux", "xent"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=FWD_RTOL)
    assert float(aux["aux"]) > 0
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_RTOL)
    want = _flat(_tree(jg))
    for path, v in tree_mod.leaves_with_paths(params):
        np.testing.assert_allclose(v.grad.numpy(), want["/".join(path)],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_drop_free_decode_match_reference(arch):
    """``e`` rows at serving time: prefill (the configs' capacity) and 3
    decode steps (drop-free, capacity = tokens x top_k) against the
    reference's logits and caches."""
    import jax.numpy as jnp
    import torch

    from repro.models import model as jmodel
    from repro.models.pcontext import ParallelContext as JPC
    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED

    jcfg, cfg, jparams, params = _model_pair(arch)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, L))
    max_seq = L + 4
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                            JPC(), max_seq, cache_dtype=jnp.float32)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                           UNSHARDED, max_seq, cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1:],
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)
    for i in range(3):
        nxt = np.full((B, 1), 3 + i)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt),
                                    jnp.asarray(L + i), jcfg, JPC())
        tl, tc = model.decode_step(params, tc, torch.from_numpy(nxt),
                                   torch.tensor(L + i), cfg, UNSHARDED)
        np.testing.assert_allclose(tl.numpy(),
                                   np.asarray(jl)[..., :cfg.vocab_size],
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[0][k].numpy(), np.asarray(jc[0][k]),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_decode_capacity_is_drop_free():
    """At decode every (token, slot) pair is kept even when all of them
    pick one expert: the capacity is tokens x top_k."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    t, k, e = 4, cfg.moe.top_k, cfg.moe.num_experts
    router = torch.zeros((cfg.d_model, e))
    router[:, 0] = 1.0           # every token's first pick: expert 0
    xt = torch.ones((t, cfg.d_model))
    r = moe.route(xt, router, cfg, e, capacity=t * k)
    assert r["capacity"] == t * k and bool(r["keep"].all())
    # at the training capacity the same tokens overflow expert 0
    assert not bool(moe.route(xt, router, cfg, e)["keep"].all())


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2])
    else:
        print("usage: --reference OUT.npz")
        sys.exit(2)
