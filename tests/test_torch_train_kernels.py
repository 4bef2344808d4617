"""The training slice's kernels, plain versions and autograd Functions of
the port against the JAX package on the same numpy inputs (CPU).

* ``chunked_reduce``: the plain version vs the Pallas kernel in
  interpret mode, at ``tests/test_kernels.py``'s shapes.  Both sum in
  f32 in another order: f32 agrees to a few ulps of sums of at most 16
  unit normals (rtol 1e-6, atol 1e-5); bf16 outputs to one bf16 ulp
  (rtol / atol 8e-3).
* ``all_gather_matmul`` / ``fused_dense``: the plain version and the
  autograd Function vs the Pallas kernel and ``jax.grad`` at
  ``tests/test_fused_kernels.py``'s shapes (f32, another summation
  order: rtol 1e-5 / atol 1e-5 forward, rtol 1e-4 / atol 1e-5 grads,
  the reference test's own tolerances).
* The ``rms_norm`` and ``flash_attention`` autograd Functions vs
  ``jax.grad`` of ``layers.rms_norm`` and of ``models/flash.py``'s
  recompute VJP (f32; rtol 1e-5 / atol 1e-5 for the norm, rtol 1e-4 /
  atol 1e-5 for attention, whose blocked backward sums over kv blocks in
  another order; the backward the card runs for attention too).  The
  norm's backward kernel runs only on the card; its order of sums is
  emulated here and held against ``jax.grad`` at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.fused_collectives import ROW_TILE
from repro.models import flash as jflash
from repro.models import layers as jlayers
from repro_torch.kernels import chunked_reduce as cr
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_collectives as fc
from repro_torch.kernels import rmsnorm as rn

RNG = np.random.default_rng(0)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(*shape) -> np.ndarray:
    return RNG.standard_normal(shape).astype(np.float32)


def _t(a: np.ndarray, requires_grad: bool = False) -> torch.Tensor:
    return torch.tensor(a, requires_grad=requires_grad)


# -- chunked_reduce --------------------------------------------------------- #

@pytest.mark.parametrize("n_src", [2, 6, 16])
@pytest.mark.parametrize("length", [512, 4096, 9999])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_reduce_plain_vs_pallas(n_src, length, dtype):
    jdt, tdt = DTYPES[dtype]
    x = _normal(n_src, length)
    want = np.asarray(ops.chunked_reduce(jnp.asarray(x, jdt), tile=512),
                      np.float32)
    xt = torch.tensor(x).to(tdt)
    before = cr.chunked_reduce.launches
    got = cr.chunked_reduce(xt)          # a CPU tensor: the plain version
    assert cr.chunked_reduce.launches == before
    assert got.dtype == tdt and got.shape == (length,)
    tol = (1e-6, 1e-5) if dtype == "float32" else (8e-3, 8e-3)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol[0],
                               atol=tol[1])


def test_chunked_reduce_wrapper_checks():
    with pytest.raises(ValueError, match="n_src, L"):
        cr.chunked_reduce(torch.zeros(8))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        cr.chunked_reduce(torch.zeros((2, 8), dtype=torch.float64))


# -- all_gather_matmul / fused_dense ---------------------------------------- #

@pytest.mark.parametrize("n,t,ks,nout", [
    (2, ROW_TILE, 32, 48),    # one row tile
    (4, 200, 16, 64),         # odd rows: padded grid in the reference
    (8, 64, 8, 128),          # many shards
])
def test_all_gather_matmul_plain_vs_pallas(n, t, ks, nout):
    x, w = _normal(t, n * ks), _normal(n, ks, nout)
    want = np.asarray(ops.all_gather_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = fc.all_gather_matmul(_t(x), _t(w))
    assert got.shape == (t, nout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_all_gather_matmul_rejects_contraction_mismatch():
    x = torch.zeros((8, 48))
    w = torch.zeros((4, 16, 8))               # 4*16 != 48
    with pytest.raises(ValueError, match="contraction mismatch"):
        fc.all_gather_matmul(x, w)
    with pytest.raises(ValueError, match="contraction mismatch"):
        fc.fused_dense(x, w)


def test_fused_dense_forward_and_grads_vs_jax():
    n, ks, nout = 4, 16, 24
    x, w = _normal(2, 5, n * ks), _normal(n, ks, nout)

    def fused(x, w):
        return jnp.sum(jnp.sin(ops.fused_dense(x, w)))

    want = float(fused(jnp.asarray(x), jnp.asarray(w)))
    gx_want, gw_want = jax.grad(fused, argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    loss = torch.sin(fc.fused_dense(xt, wt)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_want),
                               rtol=1e-4, atol=1e-5)


def test_fused_dense_grad_flows_through_a_strided_stack():
    """The fused FSDP gather hands ``fused_dense`` a strided view of the
    gathered bucket; its grad must land in the bucket's slice."""
    n, ks, nout, extra = 4, 8, 12, 5
    bucket = _t(_normal(n, extra + ks * nout), True)
    x = _normal(3, n * ks)
    w = bucket[:, extra:].reshape(n, ks, nout)
    torch.sin(fc.fused_dense(_t(x), w)).sum().backward()

    def f(b):
        return jnp.sum(jnp.sin(jnp.asarray(x)
                               @ b[:, extra:].reshape(n * ks, nout)))
    want = jax.grad(f)(jnp.asarray(bucket.detach().numpy()))
    np.testing.assert_allclose(bucket.grad.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


# -- rms_norm and flash_attention autograd ---------------------------------- #

def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """The kernel's ``warp_sum`` over the last axis (32 lanes): xor
    shuffles 16, 8, 4, 2, 1; every lane ends with the same f32 sum."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v


def _emulate_rms_backward(x, s, g, eps, geo):
    """The backward kernel's order of f32 operations (``csrc/rmsnorm.cu``)
    at the launch ``geo``: per row, each thread's sequential sums of x^2
    and g*s*x over its vectors, a warp butterfly, the row's warp partials
    by a second butterfly; dx; each block's dscale partial summed over
    its grid-stride rows in order; then the second launch's fixed order
    (32 contiguous ranges of partials, a butterfly over them)."""
    rows, d = x.shape
    tpr, v, vec, grid = geo["tpr"], geo["v"], geo["vec"], geo["grid"]
    width = v * tpr * vec

    def slices(a):       # (rows, tpr, v * vec): thread t's elements in order
        a = torch.nn.functional.pad(a, (0, width - d))
        return a.reshape(-1, v, tpr, vec).transpose(1, 2).reshape(
            -1, tpr, v * vec)

    xs, gs, ss = slices(x), slices(g), slices(s[None])
    a = torch.zeros(rows, tpr)
    b = torch.zeros(rows, tpr)
    for e in range(v * vec):
        a = a + xs[..., e] * xs[..., e]
        b = b + (gs[..., e] * ss[..., e]) * xs[..., e]
    wpr = tpr // 32
    sums = []
    for acc in (a, b):
        acc = _butterfly(acc.reshape(rows, wpr, 32))[..., 0]
        if wpr > 1:
            acc = _butterfly(torch.nn.functional.pad(acc, (0, 32 - wpr)))[
                ..., 0]
        sums.append(acc.reshape(rows, 1))
    inv_d = torch.tensor(1.0 / d, dtype=torch.float32)
    r = torch.rsqrt(sums[0] * inv_d + eps)
    c = (r * r) * (sums[1] * inv_d)
    dx = r * (g * s - x * c)
    term = (g * x) * r
    part = torch.zeros(grid, d)
    for row in range(rows):             # block row % grid, rows in order
        part[row % grid] = part[row % grid] + term[row]
    per = -(-grid // 32)
    ranges = torch.zeros(32, d)
    for w in range(32):
        for p in range(w * per, min(grid, (w + 1) * per)):
            ranges[w] = ranges[w] + part[p]
    return dx, _butterfly(ranges.T)[:, 0]


@pytest.mark.parametrize("t,d", [(7, 64), (128, 384), (37, 96)])
def test_rms_norm_grads_vs_jax(t, d):
    """The autograd Function on the CPU (the plain backward) and an
    emulation of the backward kernel's order of sums, at the H100's
    launch and at one SM's (16 rows a block at (128, 384); at (37, 96) 37
    rows over 16 blocks, a ragged walk), against jax.grad of
    layers.rms_norm."""
    x, s, g = _normal(t, d), _normal(d), _normal(t, d)

    def f(x, s):
        return jnp.sum(jlayers.rms_norm(x, s) * g)

    gx_want, gs_want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(s))
    xt, st = _t(x, True), _t(s, True)
    (rn.rms_norm(xt, st) * _t(g)).sum().backward()
    got = [(xt.grad, st.grad)]
    for sms in (rn.H100_SMS, 1):
        geo = rn.rms_geometry(t, d, 4, sms, backward=True)
        got.append(_emulate_rms_backward(_t(x), _t(s), _t(g), 1e-5, geo))
    for gx, gs in got:
        np.testing.assert_allclose(gx.numpy(), np.asarray(gx_want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gs.numpy(), np.asarray(gs_want),
                                   rtol=1e-5, atol=1e-5)


def test_rms_norm_backward_is_the_autograd_of_the_plain_version():
    x, s, g = _normal(16, 32), _normal(32), _normal(16, 32)
    res = []
    for fn in (rn.rms_norm, rn.rms_norm_plain):
        xt, st = _t(x, True), _t(s, True)
        (fn(xt, st) * _t(g)).sum().backward()
        res.append((xt.grad, st.grad))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _flash_case(lq, lk, h, d):
    return (_normal(1, lq, h, d), _normal(1, lk, h, d), _normal(1, lk, h, d),
            _normal(1, lq, h, d))


def _jax_flash_grads(q, k, v, g, causal, window, q_offset, block):
    def f(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, causal, window,
                                              q_offset, block) * g)
    return [np.asarray(a) for a in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("l,causal,window", [(256, True, None),
                                             (300, True, 64),
                                             (128, False, None)])
def test_flash_train_grads_vs_jax(l, causal, window):
    """The autograd Function on the CPU: plain forward (keeping m, l)
    and the recompute VJP, against the reference's custom VJP."""
    q, k, v, g = _flash_case(l, l, 2, 32)
    want = _jax_flash_grads(q, k, v, g, causal, window, 0, 128)
    qt, kt, vt = (_t(a, True) for a in (q, k, v))
    out = fa.flash_attention_train(qt, kt, vt, causal, window)
    (out * _t(g)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lq,lk,window,q_offset,block", [
    (256, 256, None, 0, 64),     # blocks above the diagonal skipped
    (200, 200, 48, 0, 64),       # ragged edge, blocks below the window
    (64, 192, None, 128, 32)])   # q_offset: queries at the end
def test_flash_blocked_backward_vs_jax(lq, lk, window, q_offset, block):
    q, k, v, g = _flash_case(lq, lk, 2, 32)
    want = _jax_flash_grads(q, k, v, g, True, window, q_offset, block)
    o, m, l = fa.flash_attention_plain(_t(q), _t(k), _t(v), True, window,
                                       q_offset, return_stats=True)
    got = fa.flash_attention_backward(_t(q), _t(k), _t(v), o, m, l, _t(g),
                                      True, window, q_offset, lk,
                                      block=block)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-5)


def test_flash_train_without_grad_is_the_serving_call():
    q, k, v, _ = _flash_case(64, 64, 2, 32)
    with torch.no_grad():
        a = fa.flash_attention_train(_t(q), _t(k), _t(v))
    b = fa.flash_attention(_t(q), _t(k), _t(v))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
