"""The port's Mamba-1 path (kernels/ssm_scan.py, models/ssm.py, the
kind-``1`` rows, Falcon-Mamba serving) against the JAX package on the
same numpy inputs and params.

Tolerances: the scan against the Pallas kernel (interpret mode) and
``ref.ssm_scan_ref`` at rtol/atol 1e-4, as tests/test_kernels.py holds
the Pallas kernel; the Mamba block and the SMOKE model at rtol 1e-4 /
atol 1e-5 (f32 matmul stacks and an associative scan against a
sequential one, summed in other orders).  Greedy tokens and evicted
cache images are compared exactly.  The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py, on a card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.kernels import ops, ref
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.models.pcontext import UNSHARDED as JAX_UNSHARDED
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import kvcache as jax_kvcache
from repro_torch.configs import get_config
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import blocks, model, ssm
from repro_torch.models.pcontext import UNSHARDED
from repro_torch.serving import ServeConfig, ServeEngine, kvcache

ARCH = "falcon-mamba-7b"
RTOL, ATOL = 1e-4, 1e-5
RNG = np.random.default_rng(0)
_TIGHT = dict(decode_slots=2, kv_block_tokens=4, hbm_budget_blocks=6)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_model.init_params(jax.random.key(0), jcfg, tp=1,
                                    dtype=jnp.float32)
    npp = jax.tree.map(np.asarray, jparams)
    params = model.params_from_numpy(npp, "cpu")
    return get_config(ARCH, smoke=True), jcfg, jparams, npp, params


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _scan_inputs(rng, b, l, d, n):
    """x, dt, A, B, C, D as in tests/test_kernels.py (numpy f32)."""
    return (rng.standard_normal((b, l, d)).astype(np.float32),
            (np.abs(rng.standard_normal((b, l, d))) * 0.1)
            .astype(np.float32),
            -np.abs(rng.standard_normal((d, n))).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((d,)).astype(np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# -- the scan ------------------------------------------------------------- #

@pytest.mark.parametrize("b,l,d,n", [(2, 256, 256, 16), (1, 128, 512, 8),
                                     (2, 64, 128, 4)])
def test_ssm_scan_plain_vs_pallas_and_ref(b, l, d, n):
    inputs = _scan_inputs(RNG, b, l, d, n)
    got = ss.ssm_scan(*_t(*inputs))                 # CPU: plain version
    j = [jnp.asarray(a) for a in inputs]
    pallas = ops.ssm_scan(*j, block_d=128, block_l=64)
    _close(got, pallas, 1e-4, 1e-4)
    _close(got, ref.ssm_scan_ref(*j), 1e-4, 1e-4)


def test_ssm_scan_state_carries_like_pallas_blocks():
    """The reference's carry case: the Pallas kernel split into four L
    blocks must keep its state, and the plain scan equals it."""
    b, l, d, n = 1, 128, 128, 8
    x = RNG.standard_normal((b, l, d)).astype(np.float32)
    dt = (np.abs(RNG.standard_normal((b, l, d))) * 0.1).astype(np.float32)
    a = -np.ones((d, n), np.float32)
    bs = np.ones((b, l, n), np.float32)
    cs = np.ones((b, l, n), np.float32)
    dres = np.zeros((d,), np.float32)
    four = ops.ssm_scan(*(jnp.asarray(v) for v in (x, dt, a, bs, cs, dres)),
                        block_d=128, block_l=32)
    _close(ss.ssm_scan(*_t(x, dt, a, bs, cs, dres)), four, 1e-4, 1e-4)


def test_ssm_scan_h0_and_h_last_split_run():
    """L = 100 taken as 37 + 63: the second call starts from the first
    one's h_last and the pieces equal the whole."""
    x, dt, a, bs, cs, dres = _t(*_scan_inputs(RNG, 2, 100, 64, 16))
    y, h = ss.ssm_scan(x, dt, a, bs, cs, dres, return_state=True)
    y1, h1 = ss.ssm_scan(x[:, :37], dt[:, :37], a, bs[:, :37], cs[:, :37],
                         dres, return_state=True)
    y2, h2 = ss.ssm_scan(x[:, 37:], dt[:, 37:], a, bs[:, 37:], cs[:, 37:],
                         dres, h0=h1, return_state=True)
    _close(torch.cat([y1, y2], dim=1), y, 1e-4, 1e-4)
    _close(h2, h, 1e-4, 1e-4)
    assert h.shape == (2, 64, 16) and h.dtype == torch.float32


def _emulate_kernel(x, dt, a, bs, cs, dres, h0, k):
    """csrc/ssm_scan.cu's order of operations in torch f32 with ``k``
    lanes a thread: one pass over L, the state's fused multiply-add
    (``step_h``), a thread's k lanes summed in order
    into y, the N / k threads of a channel reduce-scattered (lane
    t % (N / k) keeps step t).  Returns (y, h_last)."""
    b, l, d = x.shape
    n = a.shape[1]
    g = n // k
    lanes = torch.arange(g)
    h = torch.zeros(b, d, n) if h0 is None else h0
    ys = []
    for t in range(l):
        dv = dt[:, t]
        # fma(exp(dt*A), h, (dt*x)*B): one rounding of the sum (a product
        # of two f32 values is exact in f64)
        h = (torch.exp(dv[..., None] * a).double() * h.double() +
             ((dv * x[:, t])[..., None] * bs[:, t, None, :]).double()
             ).float()
        part = (h * cs[:, t, None, :]).reshape(b, d, g, k)
        acc = part[..., 0]
        for j in range(1, k):
            acc = acc + part[..., j]
        # reduce-scatter over the g lanes of a channel: lane t % g keeps
        # step t's sum, own half plus partner's
        off = g // 2
        while off:
            acc = acc + acc[..., lanes ^ off]
            off //= 2
        ys.append(acc[..., t % g] + dres * x[:, t])
    return torch.stack(ys, dim=1), h


@jax.jit
def _jax_scan_with_state(x, dt, a, bs, cs, dres, h0):
    """ref.ssm_scan_ref's decay and drive through the reference model's
    ``linear_scan``, which takes a starting state: (y, h_last)."""
    decay = jnp.exp(dt[..., None] * a[None, None])
    drive = (dt * x)[..., None] * bs[:, :, None, :]
    hs, h_last = jax_ssm.linear_scan(decay, drive, h0)
    return jnp.sum(hs * cs[:, :, None, :], axis=-1) + dres * x, h_last


@pytest.mark.parametrize("b,l,d,n,with_h0", [
    (2, 256, 256, 16, False), (1, 128, 512, 8, False),
    (2, 64, 128, 4, False),                      # the JAX test shapes
    (1, 2048, 128, 16, False),                   # long L
    (1, 4096, 32, 16, True),                     # L = 4096, from a state
    (2, 300, 64, 16, True),                      # ragged L from a state
    (1, 63, 64, 16, False), (1, 129, 64, 16, True),  # across ring stages
    (1, 97, 32, 32, True), (1, 40, 16, 2, False),    # N = 32, N = 2
    (1, 33, 70, 1, True),                        # N = 1, ragged D
    (1, 128, 256, 64, False),                    # N = 64 (Zamba2's)
    (1, 97, 64, 64, True), (2, 33, 100, 64, True)])  # 32-step stages
def test_kernel_order_vs_pallas_and_ref(b, l, d, n, with_h0):
    """The kernel's arithmetic (emulated) with the lanes a thread that
    ssm_geometry picks, against the Pallas kernel (interpret mode) and
    ref.ssm_scan_ref at rtol/atol 1e-4, as tests/test_kernels.py holds
    the Pallas kernel; from a random h0 against the reference's
    linear_scan; h_last against linear_scan's final state."""
    rng = np.random.default_rng(b * 7919 + l * 31 + d + n)
    inputs = _scan_inputs(rng, b, l, d, n)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) \
        if with_h0 else None
    y, h = _emulate_kernel(*_t(*inputs), None if h0 is None
                           else torch.as_tensor(h0),
                           ss.ssm_geometry(b, l, d, n)["k"])
    j = [jnp.asarray(v) for v in inputs]
    want_y, want_h = _jax_scan_with_state(
        *j, jnp.zeros((b, d, n)) if h0 is None else jnp.asarray(h0))
    _close(y, want_y, 1e-4, 1e-4)
    _close(h, want_h, 1e-4, 1e-4)
    if h0 is None:
        _close(y, ref.ssm_scan_ref(*j), 1e-4, 1e-4)
        if l % 64 == 0 and d % 128 == 0:
            _close(y, ops.ssm_scan(*j, block_d=128, block_l=64), 1e-4, 1e-4)


@pytest.mark.parametrize("shape,want", [
    ((1, 1024, 8192, 16), (4, 1024 / 132)),      # Falcon prefill
    ((4, 1, 8192, 16), (4, 4096 / 132)),         # Falcon decode step
    ((2, 300, 8192, 16), (4, 2048 / 132)),       # ragged L
    ((1, 4096, 8192, 16), (4, 1024 / 132)),
    ((1, 1024, 1024, 16), (4, 128 / 132)),       # narrow D
    ((2, 300, 512, 16), (4, 128 / 132)),         # Falcon SMOKE widths
    ((3, 77, 100, 32), (4, 96 / 132)),           # ragged D, N = 32
    ((2, 64, 128, 4), (4, 8 / 132)),
    ((1, 40, 130, 2), (2, 5 / 132)),
    ((1, 33, 70, 1), (1, 3 / 132))])
def test_ssm_geometry_pins(shape, want):
    """ssm_geometry's (lanes a thread, warps per SM) per shape on the
    H100's 132 SMs: 4 lanes (N below 4), and L never changes it."""
    geo = ss.ssm_geometry(*shape)
    assert (geo["k"], geo["warps_per_sm"]) == pytest.approx(want)
    assert geo == ss.ssm_geometry(shape[0], 1, *shape[2:])


def test_ssm_scan_wrapper_refusals():
    x, dt, a, bs, cs, dres = _t(*_scan_inputs(RNG, 1, 8, 16, 4))
    with pytest.raises(ValueError, match="state size"):       # N = 3
        ss.ssm_scan(x, dt, a[:, :3], bs[..., :3], cs[..., :3], dres)
    wide = _t(*_scan_inputs(RNG, 1, 8, 16, 128))
    with pytest.raises(ValueError, match="state size"):       # N = 128
        ss.ssm_scan(*wide)
    with pytest.raises(ValueError, match="disagree"):
        ss.ssm_scan(x, dt, a, bs[:, :4], cs, dres)
    with pytest.raises(ValueError, match="disagree"):
        ss.ssm_scan(x, dt, a, bs, cs, dres, h0=torch.zeros(1, 16, 3))
    with pytest.raises(ValueError, match="L >= 1"):
        ss.ssm_scan(x[:, :0], dt[:, :0], a, bs[:, :0], cs[:, :0], dres)
    with pytest.raises(TypeError):
        ss.ssm_scan(x.half(), dt.half(), a, bs.half(), cs.half(), dres)
    with pytest.raises(TypeError):
        ss.ssm_scan(x, dt.bfloat16(), a, bs, cs, dres)
    with pytest.raises(TypeError):
        ss.ssm_scan(x, dt, a.double(), bs, cs, dres)
    # a meta tensor takes the plain version's shape-only path (the
    # dry-run's trace); a CUDA tensor launches the kernel or raises
    out = ss.ssm_scan(*(t.to("meta") for t in (x, dt, a, bs, cs, dres)))
    assert out.device.type == "meta" and out.shape == x.shape


def test_ssm_scan_plain_is_differentiable_on_cpu():
    """On the CPU the wrapper's plain version keeps autograd history (on
    the card the backward kernel takes its place)."""
    inputs = [t.requires_grad_() for t in
              _t(*_scan_inputs(RNG, 1, 12, 16, 4))]
    ss.ssm_scan(*inputs).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in inputs)


def test_linear_scan_matches_reference():
    a = RNG.uniform(0.5, 1.0, (2, 20, 8, 4)).astype(np.float32)
    b = RNG.standard_normal((2, 20, 8, 4)).astype(np.float32)
    h0 = RNG.standard_normal((2, 8, 4)).astype(np.float32)
    for init in (None, h0):
        want = jax_ssm.linear_scan(jnp.asarray(a), jnp.asarray(b),
                                   None if init is None
                                   else jnp.asarray(init))
        got = ssm.linear_scan(torch.as_tensor(a), torch.as_tensor(b),
                              None if init is None
                              else torch.as_tensor(init))
        for g, w in zip(got, want):
            _close(g, w, 1e-5, 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    x = RNG.standard_normal((2, 7, 12)).astype(np.float32)
    w = RNG.standard_normal((12, 4)).astype(np.float32)
    st = RNG.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    want = jax_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    got = ssm.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                            None if st is None else torch.as_tensor(st))
    for g, wv in zip(got, want):
        assert tuple(g.shape) == wv.shape
        _close(g, wv, 1e-5, 1e-6)


def test_softplus_agrees_with_jax_above_torch_threshold():
    """F.softplus returns x itself above its threshold of 20, where
    jax.nn.softplus stays exact (x + log1p(exp(-x))); there the two
    agree within f32 rounding of x, and below it within 1e-6."""
    v = np.linspace(-30.0, 60.0, 9001).astype(np.float32)
    got = F.softplus(torch.as_tensor(v)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=np.finfo(np.float32).eps,
                               atol=1e-6)


# -- the Mamba-1 block ---------------------------------------------------- #

def _row0(tree):
    """Layer 0 of a stacked group (either framework, as numpy)."""
    return {k: np.array(v[0]) for k, v in tree.items()}


def test_mamba1_forward_and_decode_match_reference(setup):
    cfg, jcfg, _jparams, npp, _params = setup
    p_np = _row0(npp["g0"]["mamba"])
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.as_tensor(v) for k, v in p_np.items()}
    x = RNG.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jout, (jconv, jh) = jax_ssm.mamba1_forward(
        jp, jnp.asarray(x), jcfg, JAX_UNSHARDED, return_state=True)
    tout, (tconv, th) = ssm.mamba1_forward(tp, torch.as_tensor(x), cfg,
                                           UNSHARDED, return_state=True)
    for g, w in ((tout, jout), (tconv, jconv), (th, jh)):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    for _ in range(2):
        tok = RNG.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, (jconv, jh) = jax_ssm.mamba1_decode(
            jp, jnp.asarray(tok), (jconv, jh), jcfg, JAX_UNSHARDED)
        tout, (tconv, th) = ssm.mamba1_decode(
            tp, torch.as_tensor(tok), (tconv, th), cfg, UNSHARDED)
        for g, w in ((tout, jout), (tconv, jconv), (th, jh)):
            _close(g, w)


def test_mamba2_rows_name_the_roadmap(setup):
    """Mamba rows run at every tp (tests/test_torch_ssm_tp.py), and since
    cross attention is ported (ROADMAP queue 1, item 8) a model with an
    encoder no longer raises.  At tp 1 and tp 2 each row kind of such a
    config has the reference's params (a Mamba-1 or Mamba-2 row no cross
    attention, an ``a`` row ``norm_x`` and ``xattn`` of ``attn``'s
    shapes) and specs (``xattn`` sharded as ``attn``); at tp 1 every
    kind's forward with an encoder output equals the reference's (the
    Mamba rows ignore it)."""
    from repro.models import blocks as jax_blocks
    from repro.models import sharding as jax_sharding
    from repro.models.config import EncoderConfig as JaxEncoderConfig
    from repro_torch.core import tree
    from repro_torch.models import sharding
    from repro_torch.models.config import EncoderConfig
    enc = dataclasses.replace(get_config("zamba2-1.2b", smoke=True),
                              encoder=EncoderConfig(n_layers=1,
                                                    source_len=4))
    jenc = dataclasses.replace(jax_get_config("zamba2-1.2b", smoke=True),
                               encoder=JaxEncoderConfig(n_layers=1,
                                                        source_len=4))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 6, enc.d_model)).astype(np.float32)
    src = rng.standard_normal((1, 4, enc.d_model)).astype(np.float32)
    for tp in (1, 2):
        for kind in ("1", "2", "a"):
            jrow = jax_blocks.init_row(jax.random.key(3), kind, jenc, tp,
                                       jnp.float32, cross=True)
            row = blocks.init_row(torch.Generator().manual_seed(3), kind,
                                  enc, tp, torch.float32, "cpu", 1,
                                  cross=kind == "a")
            want = {"/".join(k.key for k in p): tuple(v.shape)
                    for p, v in jax.tree_util.tree_leaves_with_path(jrow)}
            got = {"/".join(p): tuple(v.shape[1:])
                   for p, v in tree.leaves_with_paths(row)}
            assert got == want, (tp, kind)
            assert ("xattn" in row) == (kind == "a")
            sizes = {"data": 1, "model": tp}
            sharding.set_mesh_sizes(sizes)
            jax_sharding.set_mesh_sizes(sizes)
            specs = sharding.param_specs({"g0": row}, enc, dp_axis="data")
            jstacked = {"g0": jax.tree.map(lambda a: a[None], jrow)}
            jspecs = jax_sharding.param_specs(jstacked, jenc,
                                              dp_axis="data")
            assert {"/".join(p): s for p, s in tree.leaves_with_paths(
                specs)} == {
                "/".join(k.key for k in p): tuple(s) for (p, _), s in zip(
                    jax.tree_util.tree_leaves_with_path(jstacked),
                    jax.tree.leaves(jspecs, is_leaf=lambda s: isinstance(
                        s, jax.sharding.PartitionSpec)))}
            if kind == "a":
                for leaf in ("wq", "wk", "wv", "wo"):
                    assert tree.get(specs, ("g0", "xattn", leaf)) == \
                        tree.get(specs, ("g0", "attn", leaf))
                assert "model" in tree.get(specs, ("g0", "xattn", "wq"))
            if tp > 1:
                continue
            trow = model._layer(model.params_from_numpy(
                jax.tree.map(lambda a: np.asarray(a)[None], jrow), "cpu"),
                0)
            wout, _ = jax_blocks.row_forward(
                jrow, jnp.asarray(x), kind, jenc, JAX_UNSHARDED,
                jnp.arange(6), encoder_out=jnp.asarray(src))
            out, _ = blocks.row_forward(trow, torch.as_tensor(x), kind, enc,
                                        UNSHARDED, torch.arange(6),
                                        torch.as_tensor(src))
            _close(out, wout)


# -- the model ------------------------------------------------------------ #

def test_param_count_matches_reference():
    assert get_config(ARCH).param_count() == \
        jax_get_config(ARCH).param_count() == 7_271_350_272


def test_params_layout_and_numpy_round_trip(setup):
    cfg, _jcfg, _jparams, npp, params = setup
    ref_leaves = jax.tree_util.tree_leaves_with_path(npp)
    mine = model.params_to_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert [(p, a.shape, a.dtype) for p, a in ref_leaves] == \
        [(p, a.shape, a.dtype)
         for p, a in jax.tree_util.tree_leaves_with_path(mine)]
    back = jax.tree_util.tree_leaves_with_path(model.params_to_numpy(params))
    assert [p for p, _ in back] == [p for p, _ in ref_leaves]
    for (_, a), (_, b) in zip(ref_leaves, back):
        np.testing.assert_array_equal(a, b)
    assert "head" in npp["embed"]                # untied lm head


def test_prefill_and_vector_pos_decode_match_reference(setup):
    cfg, jcfg, jparams, _npp, params = setup
    tokens = RNG.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jc = jax_model.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                               jcfg, JAX_UNSHARDED, 32,
                               cache_dtype=jnp.float32)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(tokens)},
                           cfg, UNSHARDED, 32, cache_dtype=torch.float32)
    _close(tl, jl)

    def caches_close():
        assert len(tc) == len(jc)
        for k in ("conv", "ssm"):
            assert tuple(tc[0][k].shape) == jc[0][k].shape
            _close(tc[0][k], jc[0][k])

    caches_close()
    pos = np.array([9, 9], np.int32)
    for _ in range(3):
        tok = RNG.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jc = jax_model.decode_step(jparams, jc, jnp.asarray(tok),
                                         jnp.asarray(pos), jcfg,
                                         JAX_UNSHARDED)
        tlog, tc = model.decode_step(params, tc, torch.as_tensor(tok),
                                     torch.as_tensor(pos), cfg, UNSHARDED)
        _close(tlog, jlog)
        caches_close()
        pos = pos + 1


def test_loss_and_grads_match_reference(setup):
    """The training forward (kind-``1`` ``row_forward`` with remat) and
    its gradients through the CPU plain scan against ``jax.grad`` of the
    reference's ``loss_fn`` (loss rtol 1e-5; grads rtol 1e-4 and atol
    2e-5 of the leaf's largest entry: a sequential against an
    associative scan and other sum orders leave f32 noise of a few 1e-6
    of each leaf's scale, e.g. 6.6e-6 on the embedding's 2.78)."""
    cfg, jcfg, jparams, _npp, params = setup
    toks = RNG.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, jgrads = jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                    jcfg, JAX_UNSHARDED)[0])(jparams)
    tparams = jax.tree.map(lambda t: t.clone().requires_grad_(), params)
    loss, _ = model.loss_fn(tparams, {k: torch.as_tensor(v).long()
                                      for k, v in batch.items()},
                            cfg, UNSHARDED)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=1e-5)
    got = jax.tree.map(lambda t: t.grad.numpy(), tparams)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=2e-5 * np.abs(w).max(),
                                   err_msg=str(path))


def test_decode_leaves_inactive_slot_bitwise(setup):
    cfg, params = setup[0], setup[4]
    caches = model.init_cache(cfg, UNSHARDED, 2, 16, torch.float32,
                              device="cpu")
    gen = torch.Generator().manual_seed(1)
    for c in caches:
        for t in c.values():
            t.normal_(generator=gen)
    before = [{k: t.clone() for k, t in c.items()} for c in caches]
    for _ in range(3):
        model.decode_step(params, caches, torch.tensor([[3], [4]]),
                          torch.tensor([5, 9]), cfg, UNSHARDED,
                          active=torch.tensor([True, False]))
    for c, b in zip(caches, before):
        for k in ("conv", "ssm"):
            assert torch.equal(c[k][:, 1], b[k][:, 1])
            assert not torch.equal(c[k][:, 0], b[k][:, 0])


# -- serving -------------------------------------------------------------- #

def _engine(setup, **kw):
    cfg, params = setup[0], setup[4]
    return ServeEngine(cfg, params, ServeConfig(max_seq=64, **kw),
                       device="cpu")


def test_engine_greedy_matches_reference(setup):
    cfg, jcfg, jparams = setup[0], setup[1], setup[2]
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    want = JaxServeEngine(jcfg, jparams, JaxServeConfig(max_seq=64)) \
        .generate({"tokens": jnp.asarray(toks)}, max_new_tokens=6)
    eng = _engine(setup)
    assert not eng.layout.block_sharable
    got = eng.generate({"tokens": toks}, max_new_tokens=6)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


def test_whole_image_eviction_restores_bitwise(setup):
    """The mirror of tests/test_serving.py's SSM eviction check: the
    state has no token axis, so an eviction stores the whole slot image
    and the restored run's greedy tokens equal the roomy run's."""
    cfg = setup[0]
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    eng = _engine(setup, kv_placement="pool", **_TIGHT)
    out = eng.generate({"tokens": toks}, 6)
    assert eng.counters["evictions"] > 0 and eng.counters["restores"] > 0
    assert eng.counters["replays"] == 0
    roomy = _engine(setup, decode_slots=2, kv_block_tokens=4)
    np.testing.assert_array_equal(out, roomy.generate({"tokens": toks}, 6))
    assert roomy.counters["evictions"] == 0


def test_ssm_cache_images_byte_identical_to_reference(setup):
    cfg, jcfg = setup[0], setup[1]
    jc = jax_model.init_cache(jcfg, JAX_UNSHARDED, 3, 24,
                              cache_dtype=jnp.float32)
    vals = [RNG.standard_normal(x.shape).astype(np.float32)
            for x in jax.tree.leaves(jc)]
    jc = jax.tree.unflatten(jax.tree.structure(jc),
                            [jnp.asarray(v) for v in vals])
    tc = model.init_cache(cfg, UNSHARDED, 3, 24, torch.float32,
                          device="cpu")
    for leaf, v in zip(kvcache.cache_leaves(tc), vals):
        leaf.copy_(torch.as_tensor(v))
    jl = jax_kvcache.CacheLayout(jcfg, JAX_UNSHARDED, 3, 24, jnp.float32)
    tl = kvcache.CacheLayout(cfg, UNSHARDED, 3, 24, torch.float32)
    assert [(s.shape, s.batch_axis, s.seq_axis) for s in tl.leaves] == \
        [(s.shape, s.batch_axis, s.seq_axis) for s in jl.leaves]
    assert all(s.seq_axis is None for s in tl.leaves)
    for slot, ntok in ((0, 24), (2, 7), (1, 0)):
        assert tl.extract_slot(tc, slot, ntok) == \
            jl.extract_slot(jc, slot, ntok)
        assert tl.bytes_for(ntok) == jl.bytes_for(ntok)
    img = jl.extract_slot(jc, 2, 9)
    tl.insert_slot(tc, 0, 9, img)
    want = jl.insert_slot(jc, 0, 9, img)
    for a, b in zip(kvcache.cache_leaves(tc), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("extra", [
    [], ["--trace", "poisson", "--requests", "4", "--prompt-reuse", "0.5",
         "--hbm-budget-blocks", "6", "--kv-placement", "pool"]])
def test_serve_launcher_runs_falcon_smoke_on_cpu(extra, capsys):
    """``--prompt-reuse`` asks for prefix sharing; a cache without a
    token axis turns it off, as in the reference."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "12", "--new-tokens", "3",
                "--decode-slots", "2", "--kv-block-tokens", "4"] + extra)
    out = capsys.readouterr().out
    assert "falcon-mamba-smoke" in out
    if extra:
        assert "4 requests" in out and "prefix hits 0" in out
