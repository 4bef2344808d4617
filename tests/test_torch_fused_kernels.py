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
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.fused_collectives import ROW_TILE, SEG_TILE
from repro.models.flash import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
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


# -- the tensor-core kernels' 3xTF32 arithmetic and launch geometry -------- #
#
# The card runs all_gather_matmul and float32 flash_attention as 3xTF32 on
# the tensor cores.  These emulate that arithmetic on the CPU, so that the
# precision scheme is held to the card tests' unchanged tolerances here.

AGM_SLAB = 32        # all_gather_matmul.cu's K slab (BK)
FLASH_TILE = 64      # flash_attention.cu's kv tile (BKV)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 (10 explicit mantissa bits) to nearest, ties away
    from zero, on the bit pattern, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple:
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in 3xTF32: small*big + big*small + big*big, every
    product of two tf32 values exact in f32, the sums in f32."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _agm_3xtf32(x: torch.Tensor, w_shards: torch.Tensor) -> torch.Tensor:
    """The kernel's sum: each 32-deep K slab in 3xTF32 from zero, added
    to the running f32 sum in K order."""
    n, ks, nout = w_shards.shape
    w = w_shards.reshape(n * ks, nout)
    acc = torch.zeros((x.shape[0], nout), dtype=torch.float32)
    for k0 in range(0, n * ks, AGM_SLAB):
        acc += _mm3(x[:, k0:k0 + AGM_SLAB], w[k0:k0 + AGM_SLAB])
    return acc


def _flash_3xtf32(q, k, v, causal, window, q_offset):
    """The kernel's online softmax over 64-key tiles, with Q K^T and
    P V in 3xTF32 (P unnormalised, rescaled per tile)."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    lq, lk = qh.shape[2], kh.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    m = torch.full(qh.shape[:3] + (1,), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for k0 in range(0, lk, FLASH_TILE):
        kt, vt = kh[:, :, k0:k0 + FLASH_TILE], vh[:, :, k0:k0 + FLASH_TILE]
        s = _mm3(qh, kt.transpose(-1, -2)) * scale
        mask = fa.attention_mask(lq, kt.shape[2], causal, window,
                                 q_offset - k0, lk - k0)
        s = s.masked_fill(~mask, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm3(p, vt)
        m = m_new
    return (acc / l.clamp(min=1e-20)).permute(0, 2, 1, 3)


def test_tf32_rounding_is_round_to_nearest_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10),
            1.0, 3.0]
    assert _tf32(x).tolist() == want
    big, small = _split(torch.tensor([math.pi], dtype=torch.float32))
    assert abs(float(big + small) - math.pi) < 2.0 ** -21 * math.pi


@pytest.mark.parametrize("n,ks", [(4, 512), (4, 2048)])   # K 2048, 8192
def test_3xtf32_matmul_meets_the_card_tolerance(n, ks):
    """The kernel's 3xTF32 sum against the JAX kernel (interpret mode)
    within the card test's unchanged f32 tolerance (rtol 1e-4, atol
    8 * K * 2^-24); one plain TF32 product misses it, which is why the
    kernel splits each operand."""
    t, nout = 128, 256
    x = RNG.standard_normal((t, n * ks)).astype(np.float32)
    w = RNG.standard_normal((n, ks, nout)).astype(np.float32)
    want = np.asarray(rops.all_gather_matmul(jnp.asarray(x), jnp.asarray(w)))
    rtol, atol = 1e-4, 8 * n * ks * 2.0 ** -24
    got = _agm_3xtf32(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    one = _tf32(torch.from_numpy(x)) @ _tf32(torch.from_numpy(w)
                                              .reshape(n * ks, nout))
    assert not np.allclose(one.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("b,lq,lk,h,d,causal,window,q_offset", [
    (1, 256, 256, 2, 64, True, None, 0),
    (1, 100, 300, 2, 64, True, 70, 200),
    (2, 128, 128, 2, 32, False, None, 0),
    (1, 192, 192, 2, 128, True, 96, 0)])
def test_3xtf32_flash_meets_the_card_tolerance(b, lq, lk, h, d, causal,
                                               window, q_offset):
    """The flash kernel's f32 arithmetic (3xTF32 scores and P V, the
    online softmax over 64-key tiles) against repro.models.flash within
    the card test's rtol 1e-4, atol 2e-5."""
    q = RNG.standard_normal((b, lq, h, d)).astype(np.float32)
    k, v = (RNG.standard_normal((b, lk, h, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, window, q_offset))
    got = _flash_3xtf32(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                        window, q_offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("t,n,ks,nout,tile,blocks", [
    (1024, 4, 512, 8192, 0, 512),    # wg, wu
    (1024, 4, 512, 2048, 0, 128),    # wq
    (1024, 4, 512, 512, 1, 256)])    # wk, wv
def test_agm_geometry_fills_the_card_on_the_training_path(t, n, ks, nout,
                                                          tile, blocks):
    """Every training-path shape gives at least 90% of the H100's 132
    SMs a block (wq's 128 blocks of 128 x 128 ran faster on the card
    than any tile that gives all 132 a block)."""
    geo = fc.agm_geometry(t, n, ks, nout)
    assert geo["tile"] == tile and geo["vec"]
    assert geo["grid"][0] * geo["grid"][1] == blocks
    assert blocks >= fc.AGM_FILL * fc.H100_SMS


@pytest.mark.parametrize("t,n,ks,nout", [
    (1024, 4, 512, 8192), (1024, 4, 512, 2048), (1024, 4, 512, 512),
    (1024, 4, 2048, 2048), (100, 3, 37, 130), (1, 1, 1, 1),
    (4000, 2, 64, 96)])
def test_agm_geometry_covers_the_output_once(t, n, ks, nout):
    geo = fc.agm_geometry(t, n, ks, nout)
    (bm, bn), (gm, gn) = geo["block"], geo["grid"]
    assert geo["block"] == fc.AGM_TILES[geo["tile"]]
    cover = np.zeros((gm * bm, gn * bn), np.int64)
    for i in range(gm):
        for j in range(gn):
            cover[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += 1
    assert (cover == 1).all()
    assert (gm - 1) * bm < t <= gm * bm and (gn - 1) * bn < nout <= gn * bn
    assert geo["vec"] == ((n * ks) % 4 == 0 and nout % 4 == 0)
