"""The port's Mamba-2 / Zamba2 path (the N = 64 scan and its backward,
models/ssm.py's Mamba-2 half, the kind-``2`` and shared-attention rows,
``shared_a``, the hybrid decode cache, Zamba2 serving) against the JAX
package on the same numpy inputs and params.

Tolerances: the scan against the Pallas kernel (interpret mode) and
``ref.ssm_scan_ref`` at rtol/atol 1e-4, as tests/test_kernels.py holds
the Pallas kernel; the backward (plain and the kernel's order emulated)
against ``jax.vjp`` of the reference's scan at rtol/atol 1e-4 (a
sequential against an associative scan, sums in other orders); the
Mamba-2 block and the SMOKE model at rtol 1e-4 / atol 1e-5 (f32 matmul
stacks, other sum orders), grads at rtol 1e-4 and atol 2e-5 of the
leaf's largest entry.  Greedy tokens and evicted cache images are
compared exactly.  The CUDA kernels themselves are held against the
plain versions in tests/test_torch_cuda.py, on a card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.models import model, ssm
from repro_torch.models.pcontext import UNSHARDED
from repro_torch.serving import ServeConfig, ServeEngine, kvcache

ARCH = "zamba2-1.2b"
RTOL, ATOL = 1e-4, 1e-5
RNG = np.random.default_rng(23)
_TIGHT = dict(decode_slots=2, kv_block_tokens=4, hbm_budget_blocks=6)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_model.init_params(jax.random.key(0), jcfg, tp=1,
                                    dtype=jnp.float32)
    npp = jax.tree.map(np.asarray, jparams)
    params = model.params_from_numpy(npp, "cpu", get_config(ARCH, True))
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
    return [None if a is None else torch.as_tensor(a) for a in arrays]


# -- the scan at N = 64 ---------------------------------------------------- #

@pytest.mark.parametrize("b,l,d,n", [(1, 128, 256, 64), (2, 64, 128, 64)])
def test_ssm_scan_plain_at_n64_vs_pallas_and_ref(b, l, d, n):
    inputs = _scan_inputs(RNG, b, l, d, n)
    got = ss.ssm_scan(*_t(*inputs))                 # CPU: plain version
    j = [jnp.asarray(a) for a in inputs]
    _close(got, ops.ssm_scan(*j, block_d=128, block_l=64), 1e-4, 1e-4)
    _close(got, ref.ssm_scan_ref(*j), 1e-4, 1e-4)


@pytest.mark.parametrize("shape,want", [
    ((1, 1024, 4096, 64), (4, 2048 / 132)),      # Zamba2 prefill/training
    ((4, 1, 4096, 64), (4, 8192 / 132)),         # Zamba2 decode step
    ((1, 4096, 4096, 64), (4, 2048 / 132)),      # L = 4096
    ((2, 300, 512, 16), (4, 128 / 132)),         # zamba2-smoke widths
    ((1, 77, 100, 64), (4, 64 / 132))])          # ragged D at N = 64
def test_ssm_geometry_pins_zamba2(shape, want):
    """At N = 64 a channel takes 16 threads of 4 lanes, a block of 32
    channels 512 threads: (lanes a thread, warps per SM) on 132 SMs."""
    geo = ss.ssm_geometry(*shape)
    assert (geo["k"], geo["warps_per_sm"]) == pytest.approx(want)
    assert ss.CHANNELS * shape[3] // geo["k"] == \
        (512 if shape[3] == 64 else 128)


def test_checkpoint_count():
    """The forward writes the state before every 16th step under grad."""
    assert [ss.checkpoint_count(l) for l in (1, 15, 16, 17, 1024)] == \
        [1, 1, 1, 2, 64]


# -- the backward ---------------------------------------------------------- #

def _fma(a, b, c):
    """a * b + c rounded once to f32 (a product of two f32 values is exact
    in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _step(h, dv, a, dx, bv):
    """csrc/ssm_scan.cu's ``step_h``: fma(exp(dt*A), h, (dt*x)*B)."""
    return _fma(torch.exp(dv[..., None] * a), h, dx[..., None] * bv[:, None])


def _tree(vals):
    """The reduce-scatter's order over a channel group's lanes: lane j
    adds lane j + G/2's value, then j + G/4's, ... (a halving tree)."""
    while len(vals) > 1:
        h = len(vals) // 2
        vals = [vals[i] + vals[i + h] for i in range(h)]
    return vals[0]


def _in_order(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return acc


def _fma_chain(a, b, dim):
    """sum over ``dim`` of a * b as the kernel's in-thread fma chain,
    from the first product."""
    acc = a.select(dim, 0) * b.select(dim, 0)
    for i in range(1, a.shape[dim]):
        acc = _fma(a.select(dim, i), b.select(dim, i), acc)
    return acc


def _emulate_backward(x, dt, a, bs, cs, dres, dy, h0, dh_last, geo,
                      headdim=None):
    """The backward kernel's algorithm in torch f32, per channel or per
    head of ``headdim`` channels, with the launch ``geo`` (an
    ``ssm_bwd_geometry``): the forward's states kept only before every
    16th step; each 16-step chunk, from the last, recomputed from its
    checkpoint with the forward's step (per head from one decay a (t,
    head)) and walked back.  A thread holds k lanes of m channels: the
    lane sums (g B; g h_{t-1}, or g h e A per channel) are fma chains
    over its k lanes, then the reduce-scatter's tree over the channel
    group's N / k threads; dB and dC are fma chains over its m channels,
    then the block's channel groups, the cluster's blocks and the
    clusters, each in order.  Per head, a block's share of each head's
    sum_d x (g B), S and sum_d dy x (channels in order), the blocks in
    order, ddt = fma(A e, S, X), and dA, dD over the (b, t) rows as the
    column-sum kernel takes them (256 strided partials, then a tree);
    a block's share of a head: a lane's channels (every 32nd) in order,
    then a tree over the warp's lanes;
    per channel dA and dD over the batch in order.  Returns (dx, ddt, dA,
    dB, dC, dD, dh0)."""
    b, l, d = x.shape
    n = bs.shape[-1]
    k, m, cb, cl = geo["k"], geo["m"], geo["channels"], geo["cluster"]
    grp, dpad = n // k, geo["grid"] * cb
    head = headdim is not None
    if head:
        nh = d // headdim
        dt_ch = dt.repeat_interleave(headdim, -1)
        a_ch = a.repeat_interleave(headdim)[:, None].expand(d, n)
        d_ch = dres.repeat_interleave(headdim)
    else:
        dt_ch, a_ch, d_ch = dt, a, dres
    pad = dpad - d

    def padc(v):                     # (b, d, ...) -> (b, dpad, ...)
        return torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) +
                                       (0, pad))

    def decay(t):                    # (b, d, n): per head formed once
        if head:
            e = torch.exp(dt[:, t] * a)                   # (b, nh)
            return e.repeat_interleave(headdim, -1)[..., None].expand(
                b, d, n)
        return torch.exp(dt_ch[:, t, :, None] * a_ch)

    def step(h, t):                  # the forward's step_h
        return _fma(decay(t), h, (dt_ch[:, t] * x[:, t])[..., None] *
                    bs[:, t, None, :])

    ck = []
    h = torch.zeros(b, d, n) if h0 is None else h0.clone()
    for t in range(l):
        if t % ss.CKPT == 0:
            ck.append(h)
        h = step(h, t)

    def lane_sum(v):                 # (b, d, n) -> (b, d)
        part = _fma_chain(v[0].reshape(b, d, grp, k),
                          v[1].reshape(b, d, grp, k), 3)
        return _tree([part[..., j] for j in range(grp)])

    def channel_sum(u, w):           # sum_d u[d, n] w[d] -> (b, n)
        u = padc(u).reshape(b, dpad // m, m, n)
        w = padc(w).reshape(b, dpad // m, m)[..., None].expand(u.shape)
        part = _fma_chain(u, w, 2).reshape(b, dpad // cb, cb // m, n)
        blk = _in_order([part[:, :, q] for q in range(cb // m)])
        blk = blk.reshape(b, -1, cl, n)
        clu = _in_order([blk[:, :, r] for r in range(cl)])
        return _in_order([clu[:, q] for q in range(clu.shape[1])])

    gr = torch.zeros(b, d, n) if dh_last is None else dh_last.clone()
    dx, sx_all, st_all = (torch.zeros(b, l, d) for _ in range(3))
    d_b, d_c = torch.zeros(b, l, n), torch.zeros(b, l, n)
    da = torch.zeros(b, d, n)
    dd = torch.zeros(b, d)
    for c in range(len(ck) - 1, -1, -1):
        t0 = c * ss.CKPT
        hist = [ck[c]]
        for t in range(t0, min(t0 + ss.CKPT, l)):
            hist.append(step(hist[-1], t))
        for t in range(min(t0 + ss.CKPT, l) - 1, t0 - 1, -1):
            u = t - t0
            dv, xv, dyv = dt_ch[:, t], x[:, t], dy[:, t]
            e = decay(t)
            gr = _fma(cs[:, t, None, :], dyv[..., None], gr)
            d_b[:, t] = channel_sum(gr, _fma(dv, xv, torch.zeros(())))
            d_c[:, t] = channel_sum(hist[u + 1], dyv)
            sx = lane_sum((gr, bs[:, t, None, :].expand(b, d, n)))
            if head:
                st = lane_sum((gr, hist[u]))
            else:
                w = gr * hist[u] * e
                st = lane_sum((w, a_ch.expand(b, d, n)))
                da = _fma(w, dv[..., None], da)
                dd = _fma(dyv, xv, dd)
            gr = gr * e
            sx_all[:, t], st_all[:, t] = sx, st
            dx[:, t] = _fma(sx, dt_ch[:, t], d_ch * dyv)
    if not head:
        ddt = _fma(sx_all, x, st_all)
        return dx, ddt, _in_order(list(da)), d_b, d_c, _in_order(list(dd)), \
            (gr if h0 is not None else None)
    # per head: blocks' shares, the row kernel, the column sums
    cols = torch.zeros(b * l, 2 * nh)
    ddt = torch.zeros(b, l, nh)
    for h in range(nh):
        shares = []
        for blk in range(h * headdim // cb, ((h + 1) * headdim - 1) // cb + 1):
            lo, hi = max(h * headdim, blk * cb), min((h + 1) * headdim,
                                                     blk * cb + cb, d)
            # a lane's channels (every 32nd) in order, then the lanes' tree
            lanes = [[torch.zeros(b, l)] * 3 for _ in range(32)]
            for ch in range(lo, hi):
                ln = (ch - blk * cb) % 32
                lanes[ln] = [lanes[ln][0] + x[..., ch] * sx_all[..., ch],
                             lanes[ln][1] + st_all[..., ch],
                             lanes[ln][2] + dy[..., ch] * x[..., ch]]
            shares.append([_tree([v[i] for v in lanes]) for i in range(3)])
        X, S, Q = (_in_order([sh[i] for sh in shares]) for i in range(3))
        e = torch.exp(dt[..., h] * a[h])
        ddt[..., h] = _fma(a[h] * e, S, X)
        cols[:, h] = (dt[..., h] * e * S).reshape(-1)
        cols[:, nh + h] = Q.reshape(-1)
    rows = cols.shape[0]
    part = [_in_order([cols[r] for r in range(j, rows, 256)])
            if j < rows else torch.zeros(2 * nh) for j in range(256)]
    tot = _tree(part)
    return dx, ddt, tot[:nh], d_b, d_c, tot[nh:], \
        (gr if h0 is not None else None)


def _jax_vjp(inputs, h0, dy, dh_last):
    """jax.vjp of ``ref.ssm_scan_ref``'s arithmetic through the reference
    model's ``linear_scan`` (an associative scan) from ``h0``, with the
    final state as a second output."""
    def f(x, dt, a, bs, cs, dres, h0):
        decay = jnp.exp(dt[..., None] * a[None, None])
        drive = (dt * x)[..., None] * bs[:, :, None, :]
        hs, h_last = jax_ssm.linear_scan(decay, drive, h0)
        return jnp.sum(hs * cs[:, :, None, :], axis=-1) + dres * x, h_last
    j = [jnp.asarray(v) for v in inputs] + [jnp.asarray(h0)]
    _, vjp = jax.vjp(f, *j)
    return vjp((jnp.asarray(dy), jnp.asarray(dh_last)))


@pytest.mark.parametrize("b,l,d,n,with_h0", [
    (2, 50, 40, 16, True), (1, 37, 64, 64, True), (2, 33, 70, 64, False),
    (1, 64, 32, 16, False), (2, 20, 33, 4, True)])
def test_backward_plain_and_kernel_order_vs_jax_vjp(b, l, d, n, with_h0):
    """``ssm_scan_backward_plain`` and the backward kernel's algorithm
    (emulated, with the launch ssm_bwd_geometry picks) against
    ``jax.vjp`` of the reference's scan, from a random ``h0`` or zero,
    with a cotangent on the final state; ragged L and D cross the
    16-step chunks and the 32-channel blocks."""
    rng = np.random.default_rng(b * 7919 + l * 31 + d + n)
    inputs = _scan_inputs(rng, b, l, d, n)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) if with_h0 \
        else np.zeros((b, d, n), np.float32)
    dy = rng.standard_normal((b, l, d)).astype(np.float32)
    dh_last = rng.standard_normal((b, d, n)).astype(np.float32)
    want = [np.asarray(w) for w in _jax_vjp(inputs, h0, dy, dh_last)]
    t_in = _t(*inputs)
    t_h0 = torch.as_tensor(h0) if with_h0 else None
    plain = ss.ssm_scan_backward_plain(*t_in, torch.as_tensor(dy), t_h0,
                                       torch.as_tensor(dh_last))
    emu = _emulate_backward(*t_in, torch.as_tensor(dy), t_h0,
                            torch.as_tensor(dh_last),
                            ss.ssm_bwd_geometry(b, l, d, n))
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
    for got in (plain, emu):
        for name, g, w in zip(names, got, want):
            if name == "dh0" and not with_h0:
                assert g is None
                continue
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                       err_msg=name)


def _head_inputs(rng, b, l, nh, hd, n):
    """x, dt, A, B, C, D of the per-head scan (numpy f32), drawn as
    ``_scan_inputs`` draws the per-channel ones."""
    return (rng.standard_normal((b, l, nh * hd)).astype(np.float32),
            (np.abs(rng.standard_normal((b, l, nh))) * 0.1)
            .astype(np.float32),
            -np.abs(rng.standard_normal((nh,))).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((nh,)).astype(np.float32))


def _jax_heads_vjp(inputs, hd, h0, dy, dh_last):
    """jax.vjp of the reference's per-head Mamba-2 arithmetic
    (``repro.models.ssm.mamba2_forward``'s scan: one decay a (t, head),
    ``linear_scan`` over (B, L, nh, headdim, N), the einsum with C, the
    skip D per head) from ``h0``, with the final state as a second
    output."""
    def f(x, dt, a, bs, cs, dres, h0):
        b, l, d = x.shape
        nh, n = a.shape[0], bs.shape[-1]
        xh = x.reshape(b, l, nh, hd)
        decay = jnp.exp(dt * a[None, None])
        bu = (dt[..., None] * xh)[..., None] * bs[:, :, None, None, :]
        hs, h_last = jax_ssm.linear_scan(decay[..., None, None], bu,
                                         h0.reshape(b, nh, hd, n))
        y = jnp.einsum("blhdn,bln->blhd", hs, cs) + \
            dres[None, None, :, None] * xh
        return y.reshape(b, l, d), h_last.reshape(b, d, n)
    j = [jnp.asarray(v) for v in inputs] + [jnp.asarray(h0)]
    _, vjp = jax.vjp(f, *j)
    return vjp((jnp.asarray(dy), jnp.asarray(dh_last)))


@pytest.mark.parametrize("b,l,nh,hd,n,with_h0,with_dh", [
    (2, 50, 3, 48, 16, True, True),   # heads across blocks and clusters
    (1, 37, 2, 64, 64, True, False),  # Zamba2's widths, ragged L
    (2, 33, 5, 7, 8, False, True),    # headdim 7: heads inside threads
    (1, 20, 6, 16, 4, False, False),
    (1, 40, 9, 32, 16, True, True)])  # 9 heads: 5 clusters of 2, padded
def test_heads_backward_plain_and_kernel_order_vs_jax_vjp(
        b, l, nh, hd, n, with_h0, with_dh):
    """``ssm_scan_heads_backward_plain`` and the backward kernel's head
    mode (emulated with the launch ssm_bwd_geometry picks: one decay a
    (t, head), the factorised ddt / dA, the heads' shares over blocks and
    clusters) against ``jax.vjp`` of the reference's per-head scan, from
    a random ``h0`` or zero, with and without a cotangent on the final
    state; ragged L crosses the 16-step chunks."""
    rng = np.random.default_rng(b * 7919 + l * 31 + nh * hd + n)
    inputs = _head_inputs(rng, b, l, nh, hd, n)
    d = nh * hd
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) if with_h0 \
        else np.zeros((b, d, n), np.float32)
    dy = rng.standard_normal((b, l, d)).astype(np.float32)
    dh_last = rng.standard_normal((b, d, n)).astype(np.float32) \
        if with_dh else np.zeros((b, d, n), np.float32)
    want = [np.asarray(w) for w in _jax_heads_vjp(inputs, hd, h0, dy,
                                                    dh_last)]
    t_in = _t(*inputs)
    t_h0 = torch.as_tensor(h0) if with_h0 else None
    t_dh = torch.as_tensor(dh_last) if with_dh else None
    plain = ss.ssm_scan_heads_backward_plain(*t_in, torch.as_tensor(dy), hd,
                                             t_h0, t_dh)
    geo = ss.ssm_bwd_geometry(b, l, d, n, hd)
    emu = _emulate_backward(*t_in, torch.as_tensor(dy), t_h0, t_dh, geo, hd)
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
    for got in (plain, emu):
        for name, g, w in zip(names, got, want):
            if name == "dh0" and not with_h0:
                assert g is None
                continue
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                       err_msg=name)


def test_head_decay_equals_lane_decay_bitwise():
    """The head mode's one decay a (t, head), exp(dt_h A_h), is bitwise
    the decay the forward forms per (channel, lane) from the repeated
    values: the same two f32 operands, the same product and exp."""
    rng = np.random.default_rng(5)
    _x, dt, a, _bs, _cs, dres = _t(*_head_inputs(rng, 2, 40, 6, 8, 16))
    dt_ch, a_ch, _ = ss._expand_heads(dt, a, dres, 8, 16)
    per_head = torch.exp(dt * a)                               # (B, L, nh)
    per_lane = torch.exp(dt_ch[..., None] * a_ch)              # (B,L,D,N)
    want = per_head.repeat_interleave(8, -1)[..., None].expand_as(per_lane)
    assert torch.equal(per_lane, want)


def test_heads_entry_on_cpu_is_the_plain_path():
    """``ssm_scan_heads`` on CPU tensors is the expanded plain scan,
    differentiated by autograd into per-head grads that
    ``ssm_scan_heads_backward_plain`` matches; ``ssm_scan_heads_vjp``
    counts nothing there; shapes that disagree raise."""
    rng = np.random.default_rng(8)
    inputs = _t(*_head_inputs(rng, 2, 21, 3, 5, 8))
    h0 = torch.as_tensor(rng.standard_normal((2, 15, 8)).astype(np.float32))
    leaves = [v.clone().requires_grad_() for v in inputs + [h0]]
    fwd, bwd = ss.ssm_scan.launches, ss.ssm_scan_vjp.launches
    y, h = ss.ssm_scan_heads(*leaves[:6], 5, h0=leaves[6], return_state=True)
    dt_ch, a_ch, d_ch = ss._expand_heads(inputs[1], inputs[2], inputs[5], 5,
                                         8)
    wy, wh = ss.ssm_scan_plain(inputs[0], dt_ch, a_ch, *inputs[3:5], d_ch,
                               h0, return_state=True)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    dy, dh = torch.randn_like(y), torch.randn_like(h)
    torch.autograd.backward((y, h), (dy, dh))
    got = ss.ssm_scan_heads_vjp(*inputs, None, dy, 5, h0, dh)
    assert (ss.ssm_scan.launches, ss.ssm_scan_vjp.launches) == (fwd, bwd)
    for g, leaf in zip(got, leaves):
        assert g.shape == leaf.grad.shape
        _close(g, leaf.grad, 1e-4, 1e-5)
    with pytest.raises(ValueError, match="disagree"):
        ss.ssm_scan_heads(*inputs, 4)


@pytest.mark.parametrize("shape,headdim,want", [
    # Zamba2's training row: 2 lanes x 4 channels a thread, 32 channels
    # (256 threads) a block, clusters of 2; 31.03 channels an SM on
    # average, 32 on the busiest: the best whole channels can do
    ((1, 1024, 4096, 64), 64, (2, 4, 32, 256, 128, 2, 128, 1, 4096 / 132 /
                                32)),
    ((1, 4096, 1024, 64), 64, (2, 4, 32, 256, 32, 2, 32, 1, 1024 / 132 /
                                32)),
    ((2, 300, 4096, 64), 64, (2, 4, 32, 256, 128, 2, 128, 1, 8192 / 132 /
                               64)),
    # Falcon-Mamba per channel: 2 x 2 a thread, 128 threads a block
    ((1, 1024, 8192, 16), None, (2, 2, 32, 128, 256, 2, 256, 0, 8192 /
                                 132 / 64)),
    # per channel at N = 64: 16 channels a block; a ragged D pads the
    # grid to whole clusters
    ((1, 77, 100, 64), None, (2, 2, 16, 256, 7, 2, 8, 0, 100 / 132 / 16)),
    # heads of 48 across blocks of 32: two slots a block
    ((2, 50, 144, 16), 48, (2, 4, 32, 64, 5, 2, 6, 2, 288 / 132 / 32)),
    ((1, 33, 70, 1), None, (1, 2, 64, 32, 2, 2, 2, 0, 70 / 132 / 64))])
def test_ssm_bwd_geometry_pins(shape, headdim, want):
    geo = ss.ssm_bwd_geometry(*shape, headdim)
    keys = ("k", "m", "channels", "threads", "blocks", "cluster", "grid",
            "head_slots", "fill")
    assert tuple(geo[k] for k in keys) == pytest.approx(want)


def test_plain_backward_equals_autograd_of_plain_forward():
    """The explicit reverse scan is what autograd of ``ssm_scan_plain``
    computes (f32, within summation-order noise)."""
    b, l, d, n = 2, 21, 24, 64
    inputs = _t(*_scan_inputs(RNG, b, l, d, n))
    h0 = torch.randn(b, d, n, generator=torch.Generator().manual_seed(3))
    leaves = [t.clone().requires_grad_() for t in inputs + [h0]]
    y, h = ss.ssm_scan_plain(*leaves[:6], h0=leaves[6], return_state=True)
    dy, dh = torch.randn_like(y), torch.randn_like(h)
    torch.autograd.backward((y, h), (dy, dh))
    got = ss.ssm_scan_backward_plain(*inputs, dy, h0, dh)
    for g, leaf in zip(got, leaves):
        _close(g, leaf.grad, 1e-4, 1e-5)


def test_vjp_wrapper_takes_the_plain_backward_on_cpu():
    """``ssm_scan_vjp`` on CPU tensors is ``ssm_scan_backward_plain``
    (no checkpoints needed, no count), grads in their inputs' dtypes."""
    inputs = _t(*_scan_inputs(RNG, 2, 20, 16, 4))
    dy = torch.randn(2, 20, 16, generator=torch.Generator().manual_seed(4))
    h0 = torch.zeros(2, 16, 4)
    before = ss.ssm_scan_vjp.launches
    got = ss.ssm_scan_vjp(*inputs, None, dy, h0=h0)
    want = ss.ssm_scan_backward_plain(*inputs, dy, h0)
    assert ss.ssm_scan_vjp.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got16 = ss.ssm_scan_vjp(*(t.bfloat16() if i in (0, 1, 3, 4) else t
                              for i, t in enumerate(inputs)), None, dy)
    assert [g.dtype for g in got16[:6]] == [torch.bfloat16] * 2 + \
        [torch.float32] + [torch.bfloat16] * 2 + [torch.float32]
    assert got16[6] is None


# -- the Mamba-2 block ----------------------------------------------------- #

def _row0(tree):
    return {k: np.array(v[0]) for k, v in tree.items()}


def test_mamba2_forward_and_decode_match_reference(setup):
    """The row's forward with its state, then three decode steps from
    that state, against ``mamba2_forward`` / ``mamba2_decode``."""
    cfg, jcfg, _jparams, npp, _params = setup
    p_np = _row0(npp["g0"]["mamba"])
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.as_tensor(v) for k, v in p_np.items()}
    x = RNG.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    jout, jst = jax_ssm.mamba2_forward(jp, jnp.asarray(x), jcfg,
                                       JAX_UNSHARDED, return_state=True)
    tout, tst = ssm.mamba2_forward(tp, torch.as_tensor(x), cfg, UNSHARDED,
                                   return_state=True)
    for g, w in zip((tout,) + tst, (jout,) + jst):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w)
    for _ in range(3):
        tok = RNG.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = jax_ssm.mamba2_decode(jp, jnp.asarray(tok), jst, jcfg,
                                          JAX_UNSHARDED)
        tout, tst = ssm.mamba2_decode(tp, torch.as_tensor(tok), tst, cfg,
                                      UNSHARDED)
        for g, w in zip((tout,) + tst, (jout,) + jst):
            _close(g, w)


def test_mamba2_state_shapes_match_reference(setup):
    cfg, jcfg = setup[0], setup[1]
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    for c, jc in ((cfg, jcfg), (full, jfull)):
        for version in (1, 2):
            assert ssm.mamba_state_shapes(c, 1, 3, version) == \
                jax_ssm.mamba_state_shapes(jc, 1, 3, version)
    assert ssm.mamba_state_shapes(full, 1, 4, 2)[2] == (4, 64, 64, 64)


# -- the model ------------------------------------------------------------- #

def test_config_matches_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke)) == \
            dataclasses.asdict(jax_get_config(ARCH, smoke))
    assert get_config(ARCH).param_count(1) == 1_016_745_984
    assert get_config(ARCH).layer_pattern == "22222a" * 6 + "22"


def test_params_layout_and_numpy_round_trip(setup):
    """``shared_a`` (one un-stacked ``a`` row) and the Mamba-2 leaves in
    the reference's tree; the numpy round trip is exact."""
    cfg, _jcfg, _jparams, npp, params = setup
    ref_leaves = jax.tree_util.tree_leaves_with_path(npp)
    mine = model.params_to_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert [(p, a.shape, a.dtype) for p, a in ref_leaves] == \
        [(p, a.shape, a.dtype)
         for p, a in jax.tree_util.tree_leaves_with_path(mine)]
    assert sorted(npp) == ["embed", "final_norm", "g0", "g2", "shared_a"]
    assert npp["shared_a"]["attn"]["wq"].ndim == 2
    back = jax.tree_util.tree_leaves_with_path(model.params_to_numpy(params))
    for (pa, a), (pb, b) in zip(ref_leaves, back):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    full = model.abstract_params(get_config(ARCH))
    assert sum(x.numel() for x in jax.tree.leaves(full)) == 1_016_817_664


def test_prefill_and_decode_match_reference(setup):
    """Prefill fills the hybrid cache (the shared block's KV, the Mamba-2
    rows' conv, conv_bc and state); three decode steps at per-slot
    positions follow."""
    cfg, jcfg, jparams, _npp, params = setup
    tokens = RNG.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc = jax_model.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                               jcfg, JAX_UNSHARDED, 32,
                               cache_dtype=jnp.float32)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(tokens)},
                           cfg, UNSHARDED, 32, cache_dtype=torch.float32)
    _close(tl, jl)

    def caches_close():
        got, want = kvcache.cache_leaves(tc), jax.tree.leaves(jc)
        assert len(got) == len(want) == 2 * 3 + 2
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)

    caches_close()
    pos = np.array([11, 11], np.int32)
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
    """The training forward (remat rows, ``shared_a`` applied at its
    occurrence) and its grads through the CPU plain scan against
    ``jax.grad`` of the reference's ``loss_fn``."""
    cfg, jcfg, jparams, _npp, params = setup
    toks = RNG.integers(0, cfg.vocab_size, (2, 14)).astype(np.int32)
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


def test_shared_groups_count_one_gather_each(setup):
    """The FSDP hook sees ``shared_a`` where the reference's does: its
    trace of ``loss_fn`` calls ``gather_fn("shared_a", ...)`` once per
    shared occurrence without prefetch and once per shared group with
    it, and so does the port's forward (identity gathers, no remat)."""
    cfg, jcfg, jparams, _npp, params = setup
    toks = RNG.integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for prefetch in (0, 1):
        seen = {"jax": [], "torch": []}

        def gather(side):
            def fn(key, p):
                seen[side].append(key)
                return p
            return fn

        jax_model.loss_fn(jparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg,
                          JAX_UNSHARDED, remat=False,
                          gather_fn=gather("jax"), prefetch=prefetch)
        model.loss_fn(params, {k: torch.as_tensor(v).long()
                               for k, v in batch.items()}, cfg, UNSHARDED,
                      remat=False, gather_fn=gather("torch"),
                      prefetch=prefetch)
        assert seen["torch"].count("shared_a") == \
            seen["jax"].count("shared_a") == 1
        # the reference traces a stacked group's body once (lax.scan)
        assert set(seen["torch"]) == set(seen["jax"])


def test_decode_leaves_inactive_slot_bitwise(setup):
    cfg, params = setup[0], setup[4]
    caches = model.init_cache(cfg, UNSHARDED, 2, 16, torch.float32,
                              device="cpu")
    gen = torch.Generator().manual_seed(1)
    for leaf in kvcache.cache_leaves(caches):
        leaf.normal_(generator=gen)
    before = [t.clone() for t in kvcache.cache_leaves(caches)]
    for _ in range(3):
        model.decode_step(params, caches, torch.tensor([[3], [4]]),
                          torch.tensor([5, 9]), cfg, UNSHARDED,
                          active=torch.tensor([True, False]))
    layout = kvcache.CacheLayout(cfg, UNSHARDED, 2, 16, torch.float32)
    for leaf, b, sp in zip(kvcache.cache_leaves(caches), before,
                           layout.leaves):
        assert torch.equal(leaf.select(sp.batch_axis, 1),
                           b.select(sp.batch_axis, 1))
        assert not torch.equal(leaf.select(sp.batch_axis, 0),
                               b.select(sp.batch_axis, 0))


# -- serving --------------------------------------------------------------- #

def _engine(setup, **kw):
    cfg, params = setup[0], setup[4]
    return ServeEngine(cfg, params, ServeConfig(max_seq=64, **kw),
                       device="cpu")


def test_hybrid_layout_is_not_block_sharable(setup):
    """The shared block's KV leaves have a token axis, the Mamba-2 rows'
    none: prefix sharing turns itself off, as in the reference."""
    cfg, jcfg = setup[0], setup[1]
    tl = kvcache.CacheLayout(cfg, UNSHARDED, 3, 24, torch.float32)
    jl = jax_kvcache.CacheLayout(jcfg, JAX_UNSHARDED, 3, 24, jnp.float32)
    assert not tl.block_sharable and not jl.block_sharable
    assert sum(s.seq_axis is not None for s in tl.leaves) == 2
    assert _engine(setup, prefix_sharing=True)._share is False


def test_engine_greedy_matches_reference(setup):
    cfg, jcfg, jparams = setup[0], setup[1], setup[2]
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    want = JaxServeEngine(jcfg, jparams, JaxServeConfig(max_seq=64)) \
        .generate({"tokens": jnp.asarray(toks)}, max_new_tokens=6)
    got = _engine(setup).generate({"tokens": toks}, max_new_tokens=6)
    np.testing.assert_array_equal(got, want)


def test_whole_image_eviction_restores_bitwise(setup):
    """An eviction stores the whole hybrid slot image (the KV up to the
    slot's tokens, the SSM state whole); the restored run's greedy
    tokens equal the roomy run's."""
    cfg = setup[0]
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    eng = _engine(setup, kv_placement="pool", **_TIGHT)
    out = eng.generate({"tokens": toks}, 6)
    assert eng.counters["evictions"] > 0 and eng.counters["restores"] > 0
    assert eng.counters["replays"] == 0
    roomy = _engine(setup, decode_slots=2, kv_block_tokens=4)
    np.testing.assert_array_equal(out, roomy.generate({"tokens": toks}, 6))
    assert roomy.counters["evictions"] == 0


def test_hybrid_cache_images_byte_identical_to_reference(setup):
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
def test_serve_launcher_runs_zamba2_smoke_on_cpu(extra, capsys):
    """``serve --arch zamba2-1.2b --smoke``; ``--prompt-reuse`` asks for
    prefix sharing, which the hybrid cache turns off."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "12", "--new-tokens", "3",
                "--decode-slots", "2", "--kv-block-tokens", "4"] + extra)
    out = capsys.readouterr().out
    assert "zamba2-smoke" in out
    if extra:
        assert "4 requests" in out and "prefix hits 0" in out


def test_train_and_serve_ckpt_round_trip_shared_a(tmp_path):
    """``train --ckpt`` of zamba2-smoke on 2 gloo ranks writes the GLOBAL
    params (``shared_a`` and the Mamba-2 leaves in the reference's
    layout, restorable by ``repro.training.checkpoint``), and ``serve
    --ckpt`` restores them: its greedy tokens equal an engine's built
    from the trained params."""
    from repro.training import checkpoint as jckpt
    from repro_torch.launch import serve, train
    from repro_torch.training.train_loop import TrainConfig
    cfg = get_config(ARCH, smoke=True)
    ckpt = str(tmp_path / "ckpt")
    spec = train.RunSpec(
        arch=ARCH, smoke=True,
        variants=(TrainConfig(lr=3e-4, warmup=0, total_steps=2,
                              backend="cxl", clip_norm=None),),
        steps=2, batch=4, seq=16, dp=2, device="cpu", capture_params=True,
        ckpt=ckpt, timeout_s=120.0)
    run = train.run_ranks(spec)[0]
    trained = model.params_from_numpy(run["global_params"], "cpu", cfg, 1)
    like = jax.tree.map(np.asarray, jax_model.init_params(
        jax.random.key(0), jax_get_config(ARCH, smoke=True), tp=1))
    back = jckpt.restore(ckpt, 2, {"params": like})["params"]
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(
                model.params_to_numpy(trained))):
        assert pa == pb and np.asarray(a).tobytes() == b.tobytes(), pa
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "4", "--ckpt", ckpt]
    _, eng = serve.engine_from_args(serve.build_parser().parse_args(argv))
    toks = RNG.integers(0, cfg.vocab_size, (2, 8))
    want = ServeEngine(cfg, trained, ServeConfig(max_seq=20),
                       device="cpu").generate({"tokens": toks}, 4)
    np.testing.assert_array_equal(eng.generate({"tokens": toks}, 4), want)


def test_long_scan_f32_error_at_n64():
    """At N = 64 and L = 4096 both f32 scans drift from an f64
    evaluation of the same function, the plain version (two roundings a
    step) and the kernel's order (one fused rounding a step, emulated),
    each by about the whole (1e-4, 1e-4) band of the short shapes; each
    stays within (2e-4, 2e-4) of it, so the two against each other
    within (4e-4, 4e-4), the band ``chip_smoke.py`` holds the kernel to
    against the plain version there."""
    b, l, d, n = 1, 4096, 128, 64
    gen = torch.Generator().manual_seed(1234)
    x = torch.randn(b, l, d, generator=gen)
    dt = torch.randn(b, l, d, generator=gen).abs() * 0.1
    a = -torch.randn(d, n, generator=gen).abs()
    bs, cs = (torch.randn(b, l, n, generator=gen) for _ in range(2))
    dres = torch.randn(d, generator=gen)
    h = torch.zeros(b, d, n, dtype=torch.float64)
    ys = []
    for t in range(l):
        dv = dt[:, t].double()
        h = torch.exp(dv[..., None] * a.double()) * h + \
            (dv * x[:, t].double())[..., None] * bs[:, t, None, :].double()
        ys.append((h * cs[:, t, None, :].double()).sum(-1))
    exact = torch.stack(ys, 1) + dres.double() * x.double()
    plain = ss.ssm_scan_plain(x, dt, a, bs, cs, dres).double()
    h = torch.zeros(b, d, n)
    ys = []
    for t in range(l):
        h = _step(h, dt[:, t], a, dt[:, t] * x[:, t], bs[:, t])
        ys.append((h * cs[:, t, None, :]).sum(-1))
    kernel = (torch.stack(ys, 1) + dres * x).double()

    def band(got, want, tol):
        return float(((got - want).abs() / (tol + tol * want.abs())).max())
    drift = [band(v, exact, 1e-4) for v in (plain, kernel)]
    assert max(drift) > 0.5                  # the short shapes' band, used
    assert all(band(v, exact, 2e-4) <= 1 for v in (plain, kernel))
    assert band(kernel, plain, 4e-4) <= 1
