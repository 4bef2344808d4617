"""The port's public kernel API (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels.ops``, Pallas in interpret mode on the CPU,
as ``tests/test_fused_kernels.py`` runs it), on the same numpy inputs.

On CPU tensors each port function takes its kernel's plain version, so
this holds the arithmetic that the CUDA kernels are held to on the card
(``tests/test_torch_cuda.py``).  Shapes and tolerances are those of
``tests/test_fused_kernels.py``: fp32 differs only in f32 summation
order (rtol 1e-6, atol 1e-7), bf16 in half-precision rounding (rtol
2e-2, atol 1e-2).  ``kernels.ref`` names the same plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.fused_collectives import ROW_TILE, SEG_TILE
from repro_torch.kernels import fused_collectives as fc
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(0)


def _t(x) -> torch.Tensor:
    """A JAX array as a CPU tensor of the same dtype (bf16 via f32,
    exactly)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


def _shards(n, t, d, dtype=jnp.float32):
    return jnp.asarray(RNG.normal(size=(n, t, d)), jnp.float32).astype(dtype)


# -- reduce_scatter + rmsnorm --------------------------------------------- #

@pytest.mark.parametrize("n,t,d", [
    (2, ROW_TILE, 64),        # exactly one row tile
    (4, 2 * ROW_TILE, 32),    # multi-tile
    (3, 37, 48),              # odd rows: padded grid, ragged shard count
    (8, 1, 16),               # single row
])
def test_rs_rmsnorm_matches_reference_fp32(n, t, d):
    shards = _shards(n, t, d)
    scale = jnp.asarray(RNG.normal(size=(d,)), jnp.float32)
    want = rops.reduce_scatter_rmsnorm(shards, scale)
    got = ops.reduce_scatter_rmsnorm(_t(shards), _t(scale))
    assert tuple(got.shape) == (t, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        _np(ref.reduce_scatter_rmsnorm_ref(_t(shards), _t(scale))),
        np.asarray(rref.reduce_scatter_rmsnorm_ref(shards, scale)),
        rtol=1e-6, atol=1e-7)


def test_rs_rmsnorm_matches_reference_bf16():
    shards = _shards(4, 96, 64, jnp.bfloat16)
    scale = jnp.asarray(RNG.normal(size=(64,)), jnp.bfloat16)
    want = rops.reduce_scatter_rmsnorm(shards, scale)
    got = ops.reduce_scatter_rmsnorm(_t(shards), _t(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=1e-2)


def test_rs_rmsnorm_eps_and_single_source():
    """eps reaches the norm; one source is plain rmsnorm."""
    shards = _shards(1, 5, 8) * 1e-3
    scale = jnp.ones((8,), jnp.float32)
    for eps in (1e-5, 1e-2):
        want = rops.reduce_scatter_rmsnorm(shards, scale, eps=eps)
        got = ops.reduce_scatter_rmsnorm(_t(shards), _t(scale), eps=eps)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(
        _np(ops.reduce_scatter_rmsnorm(_t(shards), _t(scale))),
        _np(ops.rms_norm(_t(shards)[0], _t(scale))), rtol=1e-6, atol=1e-7)


def test_rs_rmsnorm_refuses_bad_shapes():
    with pytest.raises(ValueError, match="n_src, T, D"):
        ops.reduce_scatter_rmsnorm(torch.zeros(4, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="n_src, T, D"):
        ops.reduce_scatter_rmsnorm(torch.zeros(2, 4, 8), torch.zeros(7))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        ops.reduce_scatter_rmsnorm(torch.zeros(2, 4, 8, dtype=torch.int32),
                                   torch.zeros(8))


# -- reduce_scatter + AdamW ----------------------------------------------- #

def _adamw_inputs(n, length, dtype=jnp.float32):
    g = jnp.asarray(RNG.normal(size=(n, length)), jnp.float32)
    p = jnp.asarray(RNG.normal(size=(length,)), jnp.float32).astype(dtype)
    m = jnp.asarray(RNG.normal(size=(length,)) * 0.1, jnp.float32)
    v = jnp.asarray(RNG.random(size=(length,)) * 0.01, jnp.float32)
    return g, p, m, v


@pytest.mark.parametrize("n,length,wd", [
    (2, SEG_TILE, 0.0),           # one tile
    (4, 3 * SEG_TILE, 0.1),       # multi-tile + weight decay
    (3, 1000, 0.0),               # odd length: padded grid
    (6, 7, 0.01),                 # shorter than any tile
])
def test_rs_adamw_matches_reference(n, length, wd):
    g, p, m, v = _adamw_inputs(n, length)
    hyper = (3e-3, 1.0 - 0.9 ** 3, 1.0 - 0.95 ** 3)
    want = rops.reduce_scatter_adamw(g, p, m, v, *hyper, weight_decay=wd)
    got = ops.reduce_scatter_adamw(_t(g), _t(p), _t(m), _t(v), *hyper,
                                   weight_decay=wd)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(ref.reduce_scatter_adamw_ref(
            _t(g), _t(p), _t(m), _t(v), *hyper, weight_decay=wd),
            rref.reduce_scatter_adamw_ref(g, p, m, v, *hyper,
                                          weight_decay=wd)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_rs_adamw_padding_leaves_tail_untouched():
    """No padding in the port: the outputs have exactly L elements, the
    inputs are left as they were, and the last (ragged-tile) elements
    are the reference's."""
    g, p, m, v = _adamw_inputs(2, SEG_TILE + 17)
    tg, tp, tm, tv = (_t(a) for a in (g, p, m, v))
    keep = [x.clone() for x in (tg, tp, tm, tv)]
    got = ops.reduce_scatter_adamw(tg, tp, tm, tv, 1e-3, 0.1, 0.05)
    want = rops.reduce_scatter_adamw(g, p, m, v, 1e-3, 0.1, 0.05)
    assert all(tuple(x.shape) == (SEG_TILE + 17,) for x in got)
    assert all(torch.equal(a, b) for a, b in zip(keep, (tg, tp, tm, tv)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a)[-17:], np.asarray(b)[-17:],
                                   rtol=1e-6, atol=1e-7)


def test_rs_adamw_bf16_params_and_tensor_hypers():
    """A bf16 param (f32 moments) and 0-d tensor hypers, as a schedule
    hands them over."""
    g, p, m, v = _adamw_inputs(4, 999, jnp.bfloat16)
    want = rops.reduce_scatter_adamw(g, p, m, v, jnp.float32(2e-3),
                                     jnp.float32(0.19), jnp.float32(0.0975),
                                     weight_decay=0.1)
    got = ops.reduce_scatter_adamw(_t(g), _t(p), _t(m), _t(v),
                                   torch.tensor(2e-3), torch.tensor(0.19),
                                   torch.tensor(0.0975), weight_decay=0.1)
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0], np.float32),
                               rtol=2e-2, atol=1e-2)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_rs_adamw_matches_the_port_optimizer():
    """One source is the port's own AdamW step (``optim.adamw_update``)
    on the same state."""
    from repro_torch.optim import adamw_init, adamw_update
    g, p, m, v = (_t(a) for a in _adamw_inputs(1, 300))
    params = {"w": p.clone()}
    state = adamw_init(params)
    state.mu["w"].copy_(m)
    state.nu["w"].copy_(v)
    new, st = adamw_update(params, {"w": g[0].clone()}, state, 1e-3)
    b1, b2 = 0.9, 0.95
    step = int(st.step)
    got = ops.reduce_scatter_adamw(g, p, m, v, 1e-3, 1 - b1 ** step,
                                   1 - b2 ** step)
    for a, b in zip(got, (new["w"], st.mu["w"], st.nu["w"])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_rs_adamw_refuses_bad_inputs():
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="n_src, L"):
        ops.reduce_scatter_adamw(torch.zeros(2, 7), z, z, z, 1e-3, 0.1, 0.1)
    with pytest.raises(TypeError, match="float32 moments"):
        ops.reduce_scatter_adamw(torch.zeros(2, 8), z, z.double(), z, 1e-3,
                                 0.1, 0.1)


# -- the rest of the API: the same names, layouts and arithmetic ----------- #

@pytest.mark.parametrize("n,t,ks,nout", [
    (2, ROW_TILE, 32, 48), (4, 200, 16, 64), (8, 64, 8, 128)])
def test_all_gather_matmul_matches_reference(n, t, ks, nout):
    x = jnp.asarray(RNG.normal(size=(t, n * ks)), jnp.float32)
    w = jnp.asarray(RNG.normal(size=(n, ks, nout)), jnp.float32)
    want = rops.all_gather_matmul(x, w)
    np.testing.assert_allclose(_np(ops.all_gather_matmul(_t(x), _t(w))),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ops.fused_dense(_t(x), _t(w))),
                               np.asarray(rops.fused_dense(x, w)),
                               rtol=1e-5, atol=1e-5)


def test_other_kernels_match_reference_through_ops():
    x = jnp.asarray(RNG.normal(size=(4, 1000)), jnp.float32)
    np.testing.assert_allclose(_np(ops.chunked_reduce(_t(x))),
                               np.asarray(rops.chunked_reduce(x)),
                               rtol=1e-6, atol=1e-6)
    h = jnp.asarray(RNG.normal(size=(16, 64)), jnp.float32)
    s = jnp.asarray(RNG.normal(size=(64,)), jnp.bfloat16)
    np.testing.assert_allclose(_np(ops.rms_norm(_t(h), _t(s))),
                               np.asarray(rops.rms_norm(h, s)), rtol=1e-5,
                               atol=1e-5)
    q, k, v = (jnp.asarray(RNG.normal(size=(2, 64, 32)), jnp.float32)
               for _ in range(3))
    for window in (None, 24):
        want = rops.flash_attention(q, k, v, True, window, block_q=32,
                                    block_k=32)
        got = ops.flash_attention(_t(q), _t(k), _t(v), True, window)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(
            _np(ref.flash_attention_ref(_t(q), _t(k), _t(v), True, window)),
            np.asarray(rref.flash_attention_ref(q, k, v, True, window)),
            rtol=1e-4, atol=1e-5)
    b, l, d, n = 2, 16, 16, 4
    xs = jnp.asarray(RNG.normal(size=(b, l, d)), jnp.float32)
    dt = jnp.asarray(np.abs(RNG.normal(size=(b, l, d))) * 0.1, jnp.float32)
    a = -jnp.asarray(np.abs(RNG.normal(size=(d, n))), jnp.float32)
    bs, cs = (jnp.asarray(RNG.normal(size=(b, l, n)), jnp.float32)
              for _ in range(2))
    dres = jnp.asarray(RNG.normal(size=(d,)), jnp.float32)
    want = rops.ssm_scan(xs, dt, a, bs, cs, dres, block_d=16, block_l=8)
    got = ops.ssm_scan(*(_t(z) for z in (xs, dt, a, bs, cs, dres)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_wrappers_count_only_kernel_launches():
    """CPU tensors take the plain versions: no launch is counted."""
    before = (fc.reduce_scatter_rmsnorm.launches,
              fc.reduce_scatter_adamw.launches)
    ops.reduce_scatter_rmsnorm(torch.ones(2, 3, 4), torch.ones(4))
    z = torch.ones(5)
    ops.reduce_scatter_adamw(torch.ones(2, 5), z, z, z, 1e-3, 0.1, 0.1)
    assert (fc.reduce_scatter_rmsnorm.launches,
            fc.reduce_scatter_adamw.launches) == before
