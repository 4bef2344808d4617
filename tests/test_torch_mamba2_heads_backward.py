"""The backward of the per-head (Mamba-2) scan against ``jax.vjp`` of
the reference's: ``ssm_scan_heads_backward_plain`` and the backward
kernel's head mode (its order of operations emulated, from
tests/test_torch_mamba2.py) at rtol/atol 1e-4 (a sequential against an
associative scan, sums in other orders).  A file of its own so that a
run that hands whole files to its workers spreads these cases apart
from the rest of the Mamba-2 tests."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.kernels import ssm_scan as ss

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mamba2 import (_emulate_backward, _head_inputs,  # noqa: E402
                               _t)


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
