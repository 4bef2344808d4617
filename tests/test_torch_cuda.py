"""The hand-written CUDA kernels against their plain PyTorch versions, and
the port's model and engine on the card against the same code on the
CPU.  Needs an NVIDIA GPU with nvcc: every test is marked ``cuda`` and
skips without a card.  Imports no JAX, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import model
from repro_torch.models.pcontext import UNSHARDED
from repro_torch.serving import ServeConfig, ServeEngine

RNG = np.random.default_rng(0)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device):
    return torch.as_tensor(RNG.standard_normal(shape).astype(np.float32)) \
        .to(dtype).to(device)


@pytest.mark.parametrize("t,d", [(4, 2048), (1024, 2048), (300, 384),
                                 (5, 100), (1024, 4096), (4, 4096),
                                 (1, 2048), (1000, 2048), (2048, 1536),
                                 (1500, 384), (1600, 3072)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernel_vs_plain(cuda, t, d, dtype):
    """Each launch ``rms_geometry`` chooses: the paths' widths at prefill
    and decode; (5, 100): bf16 rows not 16-byte aligned take one element
    at a time; (300, 384): columns past D predicated off; (1000, 2048): a
    row count that no rows-per-block choice divides; (2048, 1536):
    Granite-3.0-MoE's width, a rank's 2 x 1024 tokens; (1500, 384):
    whisper-tiny's encoder (8 rows a block, a ragged last block);
    (1600, 3072): Phi-3-vision's 576 + 1024 tokens (a row a block)."""
    x = _randn((t, d), DTYPES[dtype], cuda)
    s = _randn((d,), torch.float32, cuda)
    before = rn.rms_norm.launches
    got = rn.rms_norm(x, s)
    torch.cuda.synchronize()
    assert rn.rms_norm.launches == before + 1
    tol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(),
                               rn.rms_norm_plain(x, s).float(),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("b,lq,lk,h,d,causal,window,q_offset", [
    (1, 1024, 1024, 32, 64, True, None, 0),
    (2, 200, 200, 4, 64, True, None, 0),       # ragged edges
    (1, 256, 256, 4, 128, True, 96, 0),        # window, D = 128
    (1, 64, 300, 4, 64, True, None, 236),      # q_offset, ragged kv
    (1, 130, 130, 8, 32, True, 50, 0),         # D = 32 (smoke model)
    (1, 128, 128, 2, 64, False, None, 0),
    # Lq not a multiple of the 64-row q tile, q_offset > 0, and a window
    # whose lower edge crosses a kv tile
    (1, 100, 300, 4, 64, True, 70, 200),
    (2, 77, 141, 3, 128, True, 40, 64),
    # whisper-tiny: the encoder (non-causal, 1500 = 23 x 64 + 28: the
    # last q and kv tiles ragged) and cross attention (lq != lk)
    (4, 1500, 1500, 6, 64, False, None, 0),
    (4, 1024, 1500, 6, 64, False, None, 0),
    # Phi-3-vision: head_dim 96, 576 + 1024 tokens, and D = 96 ragged
    (1, 1600, 1600, 32, 96, True, None, 0),
    (2, 77, 141, 3, 96, True, 40, 64),
    (1, 100, 300, 4, 96, False, None, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_vs_plain(cuda, b, lq, lk, h, d, causal, window,
                               q_offset, dtype):
    q = _randn((b, lq, h, d), DTYPES[dtype], cuda)
    k, v = (_randn((b, lk, h, d), DTYPES[dtype], cuda) for _ in range(2))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal, window, q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal, window, q_offset)
    tol = (1e-4, 2e-5) if dtype == "float32" else (2e-2, 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_stats_vs_plain(cuda, d, dtype):
    """The (m, l) the training backward reads: each row's max score and
    normaliser, f32 in both dtypes (bf16 products are exact in f32), at
    the f32 tolerance; o at its dtype's."""
    q = _randn((2, 200, 3, d), DTYPES[dtype], cuda)
    k, v = (_randn((2, 264, 3, d), DTYPES[dtype], cuda) for _ in range(2))
    got = fa._launch(q, k, v, True, 90, 64, 250, True)
    want = fa.flash_attention_plain(q, k, v, True, 90, 64, 250,
                                    return_stats=True)
    tol = (1e-4, 2e-5) if dtype == "float32" else (2e-2, 2e-2)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol[0],
                               atol=tol[1])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_repeats_bitwise(cuda, dtype):
    """No atomics, a fixed order of every sum: a repeat is bitwise equal."""
    q, k, v = (_randn((1, 1024, 32, 64), DTYPES[dtype], cuda)
               for _ in range(3))
    outs = [fa._launch(q, k, v, True, None, 0, 1024, True)
            for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_flash_kernel_kv_len(cuda):
    q, k, v = (_randn((1, 100, 2, 64), torch.float32, cuda)
               for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=False, kv_len=70)
    want = fa.flash_attention_plain(q[:, :], k[:, :70], v[:, :70],
                                    causal=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)


def test_smoke_model_on_card_matches_cpu(cuda):
    """Prefill at L = 1100 (the flash kernel) and three decode steps, the
    card against the CPU with the same params (cuBLAS and the CPU BLAS
    sum in different orders: rtol 2e-4, atol 2e-5)."""
    cfg = get_config("llama3.2-1b", smoke=True)
    cpu = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = model.params_from_numpy(model.params_to_numpy(cpu), cuda)
    toks = RNG.integers(0, cfg.vocab_size, (1, 1100))
    outs = []
    for params, dev in ((cpu, torch.device("cpu")), (gpu, cuda)):
        before = fa.flash_attention.launches
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(toks, device=dev)}, cfg,
            UNSHARDED, 1104, cache_dtype=torch.float32)
        res = [logits]
        pos = torch.tensor([1100], device=dev)
        for i in range(3):
            lg, caches = model.decode_step(
                params, caches, torch.tensor([[5 + i]], device=dev), pos,
                cfg, UNSHARDED)
            res.append(lg)
            pos = pos + 1
        outs.append([t.cpu() for t in res + [caches[0]["k"]]])
    assert fa.flash_attention.launches == before + cfg.n_layers
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def test_engine_on_card_matches_cpu_and_evicts_bitwise(cuda):
    cfg = get_config("llama3.2-1b", smoke=True)
    cpu = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = model.params_from_numpy(model.params_to_numpy(cpu), cuda)
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    tight = dict(decode_slots=2, kv_block_tokens=4, hbm_budget_blocks=6)
    want = ServeEngine(cfg, cpu, ServeConfig(max_seq=64, **tight),
                       device="cpu").generate({"tokens": toks}, 6)
    eng = ServeEngine(cfg, gpu, ServeConfig(max_seq=64, kv_placement="pool",
                                            **tight))
    got = eng.generate({"tokens": toks}, 6)
    assert eng.counters["evictions"] > 0 and eng.counters["restores"] > 0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- #
# the SSM slice: ssm_scan, Falcon-Mamba on the card
# ---------------------------------------------------------------------- #

def _scan_inputs(b, l, d, n, dtype, device, with_h0):
    """x, dt, A, B, C, D (and h0) as tests/test_kernels.py draws them."""
    x = _randn((b, l, d), dtype, device)
    dt = (_randn((b, l, d), torch.float32, device).abs() * 0.1).to(dtype)
    a = -_randn((d, n), torch.float32, device).abs()
    bs, cs = (_randn((b, l, n), dtype, device) for _ in range(2))
    dres = _randn((d,), torch.float32, device)
    h0 = _randn((b, d, n), torch.float32, device) if with_h0 else None
    return (x, dt, a, bs, cs, dres), h0


@pytest.mark.parametrize("b,l,d,n,with_h0", [
    (2, 256, 256, 16, False), (1, 128, 512, 8, False),
    (2, 64, 128, 4, False),                      # the JAX test shapes
    (1, 1024, 8192, 16, False),                  # Falcon prefill
    (2, 300, 8192, 16, True),                    # ragged L, from a state
    (4, 1, 8192, 16, True),                      # Falcon decode step
    (3, 77, 100, 32, True),                      # ragged D, N = 32
    (1, 40, 130, 2, False), (1, 33, 70, 1, True),    # N = 2, 1
    # L one under and over a 64-step ring stage, and two stages + 1
    (1, 63, 8192, 16, True), (1, 65, 8192, 16, False),
    (1, 129, 8192, 16, True),
    (1, 4096, 8192, 16, False),                  # error grows with L
    (1, 1024, 4096, 64, False),                  # Zamba2 prefill (N = 64)
    (4, 1, 4096, 64, True),                      # Zamba2 decode step
    (2, 300, 4096, 64, True),                    # ragged L, N = 64
    (1, 4096, 4096, 64, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_vs_plain(cuda, b, l, d, n, with_h0, dtype):
    """y and h_last against the plain version (rtol/atol 1e-4 in f32, as
    tests/test_kernels.py holds the Pallas kernel; bf16 y differs by a
    rounding of the output), and two runs bitwise equal (no atomics)."""
    args, h0 = _scan_inputs(b, l, d, n, DTYPES[dtype], cuda, with_h0)
    before = ss.ssm_scan.launches
    y, h = ss.ssm_scan(*args, h0=h0, return_state=True)
    y2 = ss.ssm_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert ss.ssm_scan.launches == before + 2
    want_y, want_h = ss.ssm_scan_plain(*args, h0=h0, return_state=True)
    tol = (1e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol[0],
                               atol=tol[1])
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    assert y.dtype == DTYPES[dtype] and torch.equal(y, y2)


@pytest.mark.parametrize("b,l,d,n,with_h0", [
    (2, 300, 8192, 16, True), (1, 1024, 256, 16, False),
    (3, 161, 100, 32, True), (1, 257, 70, 1, True), (2, 96, 130, 2, False),
    (1, 200, 64, 8, True), (2, 130, 96, 4, True), (2, 97, 100, 64, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_every_variant_vs_plain_and_bitwise(cuda, b, l, d, n,
                                                      with_h0, dtype):
    """The launch ssm_geometry chooses (one pass with k lanes a thread:
    one kernel instantiation per N, each N here), through the private
    launch that takes it: y and h_last against the plain version at the
    same tolerances, a repeat bitwise equal, and no count."""
    args, h0 = _scan_inputs(b, l, d, n, DTYPES[dtype], cuda, with_h0)
    want_y, want_h = ss.ssm_scan_plain(*args, h0=h0, return_state=True)
    tol = (1e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
    geo = ss.ssm_geometry(b, l, d, n, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    before = ss.ssm_scan.launches
    y, h = ss._launch(*args, h0, True, geo)
    y2, h2 = ss._launch(*args, h0, True, geo)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol[0],
                               atol=tol[1])
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert ss.ssm_scan.launches == before        # only ssm_scan counts


def _scan_grads(fn, args, h0, dy, dh):
    """Every input's grad of (y * dy).sum() + (h_last * dh).sum() through
    ``fn`` (ssm_scan or its plain version)."""
    leaves = [t.clone().requires_grad_() for t in
              list(args) + ([h0] if h0 is not None else [])]
    y, h = fn(*leaves[:6], h0=leaves[6] if h0 is not None else None,
              return_state=True)
    ((y.float() * dy).sum() + (h * dh).sum()).backward()
    return [t.grad for t in leaves]


# (rtol, atol as a fraction of the grad's largest entry): the kernel
# recomputes each 16-step chunk from its checkpoint and sums over L, N
# and the channels in other orders than autograd through the plain loop
SCAN_GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}


@pytest.mark.parametrize("b,l,d,n,with_h0", [
    (1, 1024, 8192, 16, False),                  # Falcon's training shape
    (1, 1024, 4096, 64, False),                  # Zamba2's, a rank's rows
    (1, 4096, 1024, 64, False),                  # L = 4096
    (2, 300, 4096, 64, True),                    # from h0, ragged L
    (2, 77, 100, 16, True), (1, 33, 70, 1, True),    # ragged D, N = 1
    (2, 50, 64, 2, True), (1, 40, 96, 4, False), (2, 65, 130, 8, True),
    (1, 48, 64, 32, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_backward_kernel_vs_plain(cuda, b, l, d, n, with_h0,
                                           dtype):
    """Every input's grad through the kernels (the forward writing its
    checkpoints, one launch of the backward) against autograd through
    the plain version, with a cotangent on the final state, and a repeat
    bitwise equal (no atomics)."""
    args, h0 = _scan_inputs(b, l, d, n, DTYPES[dtype], cuda, with_h0)
    dy = _randn((b, l, d), torch.float32, cuda)
    dh = _randn((b, d, n), torch.float32, cuda)
    want = _scan_grads(ss.ssm_scan_plain, args, h0, dy, dh)
    before = ss.ssm_scan_vjp.launches
    got = _scan_grads(ss.ssm_scan, args, h0, dy, dh)
    again = _scan_grads(ss.ssm_scan, args, h0, dy, dh)
    torch.cuda.synchronize()
    assert ss.ssm_scan_vjp.launches == before + 2
    rtol, frac = SCAN_GRAD_TOL[dtype]
    for g, w, g2 in zip(got, want, again):
        assert g.dtype == w.dtype and torch.equal(g, g2)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=frac * float(w.abs().max()))


def test_ssm_scan_backward_counts_and_refusals(cuda):
    """One backward count per backward and none in the forward; a
    forward without grad writes no checkpoints; non-contiguous inputs
    still raise; CPU tensors take the plain backward and count
    nothing."""
    args, _ = _scan_inputs(1, 40, 64, 16, torch.float32, cuda, False)
    x = args[0].clone().requires_grad_()
    fwd, bwd = ss.ssm_scan.launches, ss.ssm_scan_vjp.launches
    y = ss.ssm_scan(x, *args[1:])
    assert (ss.ssm_scan.launches, ss.ssm_scan_vjp.launches) == \
        (fwd + 1, bwd)
    y.sum().backward()
    assert ss.ssm_scan_vjp.launches == bwd + 1 and x.grad is not None
    with torch.no_grad():
        assert not ss.ssm_scan(x, *args[1:]).requires_grad
    strided = torch.cat([args[3], args[3]], dim=-1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan(*args[:3], strided, *args[4:])
    cpu = [t.cpu() for t in args]
    dy = torch.ones(1, 40, 64)
    got = ss.ssm_scan_vjp(*cpu, None, dy)       # CPU: the plain backward
    assert ss.ssm_scan_vjp.launches == bwd + 1
    for g, w in zip(got, ss.ssm_scan_backward_plain(*cpu, dy)):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g, w)


def _head_inputs(b, l, nh, hd, n, dtype, device, with_h0):
    """x (b, l, nh hd), dt (b, l, nh), A, D (nh,), B, C (and h0) as
    tests/test_kernels.py draws the scan's, per head."""
    x = _randn((b, l, nh * hd), dtype, device)
    dt = (_randn((b, l, nh), torch.float32, device).abs() * 0.1).to(dtype)
    a = -_randn((nh,), torch.float32, device).abs()
    bs, cs = (_randn((b, l, n), dtype, device) for _ in range(2))
    dres = _randn((nh,), torch.float32, device)
    h0 = _randn((b, nh * hd, n), torch.float32, device) if with_h0 \
        else None
    return (x, dt, a, bs, cs, dres), h0


def _head_grads(fn, args, hd, h0, dy, dh):
    """Every input's grad of (y * dy).sum() + (h_last * dh).sum() through
    ``fn`` (ssm_scan_heads or its plain version)."""
    leaves = [t.clone().requires_grad_() for t in
              list(args) + ([h0] if h0 is not None else [])]
    y, h = fn(*leaves[:6], hd, h0=leaves[6] if h0 is not None else None,
              return_state=True)
    ((y.float() * dy).sum() + (h * dh).sum()).backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("b,l,nh,hd,n,with_h0", [
    (1, 1024, 64, 64, 64, False),                # Zamba2's training shape
    (1, 4096, 16, 64, 64, False),                # L = 4096
    (2, 300, 64, 64, 64, True),                  # from h0, ragged L
    (2, 50, 3, 48, 16, True),    # heads across blocks, nh odd: 2 clusters
    (1, 33, 5, 7, 64, True),     # headdim 7: heads inside thread groups
    (2, 40, 4, 16, 8, False), (1, 20, 6, 5, 1, True),
    (1, 37, 2, 64, 2, True), (1, 64, 8, 4, 4, False),
    (1, 17, 3, 32, 32, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_heads_backward_kernel_vs_plain(cuda, b, l, nh, hd, n,
                                                 with_h0, dtype):
    """Every grad through the head mode (the forward on the repeated
    values writing its checkpoints, one launch of the backward kernel in
    its head mode: ddt, dA and dD per head) against autograd through the
    plain version, with a cotangent on the final state, every N, and a
    repeat bitwise equal."""
    args, h0 = _head_inputs(b, l, nh, hd, n, DTYPES[dtype], cuda, with_h0)
    dy = _randn((b, l, nh * hd), torch.float32, cuda)
    dh = _randn((b, nh * hd, n), torch.float32, cuda)
    want = _head_grads(ss.ssm_scan_heads_plain, args, hd, h0, dy, dh)
    before = ss.ssm_scan_vjp.launches, ss.ssm_scan.launches
    got = _head_grads(ss.ssm_scan_heads, args, hd, h0, dy, dh)
    again = _head_grads(ss.ssm_scan_heads, args, hd, h0, dy, dh)
    torch.cuda.synchronize()
    assert (ss.ssm_scan_vjp.launches, ss.ssm_scan.launches) == \
        (before[0] + 2, before[1] + 2)
    rtol, frac = SCAN_GRAD_TOL[dtype]
    for g, w, g2 in zip(got, want, again):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, g2)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=frac * float(w.abs().max()))


def test_ssm_scan_heads_kernel_equals_plain_backward(cuda):
    """The head mode's launch against ``ssm_scan_heads_backward_plain``
    (the explicit per-head VJP) and the per-channel mode on the repeated
    values summed over each head, at Zamba2's row of 4 x 64 heads from
    h0 with dh_last, L ragged."""
    b, l, nh, hd, n = 2, 77, 4, 64, 64
    args, h0 = _head_inputs(b, l, nh, hd, n, torch.float32, cuda, True)
    dy = _randn((b, l, nh * hd), torch.float32, cuda)
    dh = _randn((b, nh * hd, n), torch.float32, cuda)
    dt_ch, a_ch, d_ch = ss._expand_heads(args[1], args[2], args[5], hd, n)
    _, _, hc = ss._launch(args[0], dt_ch, a_ch, *args[3:5], d_ch, h0, True,
                          ss.ssm_geometry(b, l, nh * hd, n),
                          checkpoints=True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = ss._backward_launch(*args, hc, dy, dh, True,
                              ss.ssm_bwd_geometry(b, l, nh * hd, n, hd, sms),
                              hd)
    plain = ss.ssm_scan_heads_backward_plain(*args, dy, hd, h0, dh)
    chan = list(ss._backward_launch(
        args[0], dt_ch, a_ch, *args[3:5], d_ch, hc, dy, dh, True,
        ss.ssm_bwd_geometry(b, l, nh * hd, n, None, sms)))
    torch.cuda.synchronize()
    chan[1] = chan[1].reshape(b, l, nh, hd).sum(-1)
    chan[2] = chan[2].sum(-1).reshape(nh, hd).sum(-1)
    chan[5] = chan[5].reshape(nh, hd).sum(-1)
    for name, g, w, c in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"),
                             got, plain, chan):
        for other in (w, c):
            torch.testing.assert_close(
                g, other, rtol=1e-4, atol=1e-5 * float(other.abs().max()),
                msg=name)


def test_ssm_scan_heads_counts_and_refusals(cuda):
    """One forward count per forward (none in the backward), one backward
    count per backward; no checkpoints without grad; non-contiguous
    inputs and shapes that disagree raise; CPU tensors take the plain
    versions and count nothing."""
    args, _ = _head_inputs(1, 40, 2, 32, 16, torch.float32, cuda, False)
    x = args[0].clone().requires_grad_()
    fwd, bwd = ss.ssm_scan.launches, ss.ssm_scan_vjp.launches
    y = ss.ssm_scan_heads(x, *args[1:], 32)
    assert (ss.ssm_scan.launches, ss.ssm_scan_vjp.launches) == \
        (fwd + 1, bwd)
    y.sum().backward()
    assert ss.ssm_scan_vjp.launches == bwd + 1 and x.grad is not None
    assert ss.ssm_scan.launches == fwd + 1
    with torch.no_grad():
        assert not ss.ssm_scan_heads(x, *args[1:], 32).requires_grad
    strided = torch.cat([args[3], args[3]], dim=-1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan_heads(*args[:3], strided, *args[4:], 32)
    with pytest.raises(ValueError, match="disagree"):
        ss.ssm_scan_heads(*args, 16)
    cpu = [t.cpu() for t in args]
    dy = torch.ones(1, 40, 64)
    got = ss.ssm_scan_heads_vjp(*cpu, None, dy, 32)
    assert ss.ssm_scan_vjp.launches == bwd + 1
    for g, w in zip(got, ss.ssm_scan_heads_backward_plain(*cpu, dy, 32)):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g, w)


def test_falcon_smoke_on_card_matches_cpu(cuda):
    """Falcon-Mamba SMOKE: prefill at L = 300 and three per-slot decode
    steps, the card (ssm_scan kernel) against the CPU (plain version),
    logits and both cache leaves at rtol 2e-4, atol 2e-5."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    cpu = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = model.params_from_numpy(model.params_to_numpy(cpu), cuda)
    toks = RNG.integers(0, cfg.vocab_size, (2, 300))
    outs = []
    for params, dev in ((cpu, torch.device("cpu")), (gpu, cuda)):
        before = ss.ssm_scan.launches
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(toks, device=dev)}, cfg,
            UNSHARDED, 320, cache_dtype=torch.float32)
        res = [logits]
        pos = torch.tensor([300, 300], device=dev)
        active = torch.tensor([True, False], device=dev)
        for i in range(3):
            lg, caches = model.decode_step(
                params, caches, torch.tensor([[5 + i], [9]], device=dev),
                pos, cfg, UNSHARDED, active=active)
            res.append(lg)
            pos = pos + 1
        outs.append([t.cpu() for t in res + [caches[0]["conv"],
                                             caches[0]["ssm"]]])
    assert ss.ssm_scan.launches == before + 4 * cfg.n_layers
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def test_zamba2_smoke_on_card_matches_cpu(cuda):
    """zamba2-smoke (Mamba-2 rows at N = 16, the shared attention block):
    prefill at L = 300 and three per-slot decode steps, then the loss
    and every grad of one training forward, the card (ssm_scan and its
    backward kernel, rms_norm's, flash_attention) against the CPU
    (plain versions), at rtol 2e-4, atol 2e-5 (grads: atol 2e-5 of the
    leaf's largest entry)."""
    cfg = get_config("zamba2-1.2b", smoke=True)
    cpu = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = model.params_from_numpy(model.params_to_numpy(cpu), cuda)
    toks = RNG.integers(0, cfg.vocab_size, (2, 300))
    outs, grads = [], []
    for params, dev in ((cpu, torch.device("cpu")), (gpu, cuda)):
        before = ss.ssm_scan.launches, ss.ssm_scan_vjp.launches
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(toks, device=dev)}, cfg,
            UNSHARDED, 320, cache_dtype=torch.float32)
        res = [logits]
        pos = torch.tensor([300, 300], device=dev)
        active = torch.tensor([True, False], device=dev)
        for i in range(3):
            lg, caches = model.decode_step(
                params, caches, torch.tensor([[5 + i], [9]], device=dev),
                pos, cfg, UNSHARDED, active=active)
            res.append(lg)
            pos = pos + 1
        leaves = {k: v for k, v in _flat(params).items()}
        train = {k: v.clone().requires_grad_() for k, v in leaves.items()}
        batch = {"tokens": torch.as_tensor(toks[:, :64], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:65], device=dev)}
        loss, _ = model.loss_fn(_unflat(train), batch, cfg, UNSHARDED)
        loss.backward()
        res.append(loss.detach())
        outs.append([t.cpu() for t in res])
        grads.append({k: t.grad.cpu() for k, t in train.items()})
    rows = cfg.layer_pattern.count("2")
    assert ss.ssm_scan.launches == before[0] + (4 + 2) * rows
    assert ss.ssm_scan_vjp.launches == before[1] + rows
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    for k, w in grads[0].items():
        torch.testing.assert_close(grads[1][k], w, rtol=2e-4,
                                   atol=2e-5 * float(w.abs().max()),
                                   msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_falcon_engine_on_card_matches_cpu_and_evicts_bitwise(cuda):
    """Whole-image eviction of the token-free SSM cache on the card."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    cpu = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = model.params_from_numpy(model.params_to_numpy(cpu), cuda)
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    tight = dict(decode_slots=2, kv_block_tokens=4, hbm_budget_blocks=6)
    want = ServeEngine(cfg, cpu, ServeConfig(max_seq=64, **tight),
                       device="cpu").generate({"tokens": toks}, 6)
    eng = ServeEngine(cfg, gpu, ServeConfig(max_seq=64, kv_placement="pool",
                                            **tight))
    got = eng.generate({"tokens": toks}, 6)
    assert eng.counters["evictions"] > 0 and eng.counters["restores"] > 0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- #
# the training slice: chunked_reduce, all_gather_matmul, gradients, pool
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("n_src", [2, 4, 16])
@pytest.mark.parametrize("length", [1 << 20, 1000003, 8, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_reduce_kernel_vs_plain(cuda, n_src, length, dtype):
    """Ragged L (1000003, 3) takes the masked scalar path.  Both sum in
    f32 but in another order: f32 agrees to the n_src - 1 roundings of
    partial sums up to about 16 (<= 15 * ulp(16) / 2 = 1.4e-5: atol
    2e-5), bf16 to one ulp of the output."""
    from repro_torch.kernels import chunked_reduce as cr
    x = _randn((n_src, length), DTYPES[dtype], cuda)
    before = cr.chunked_reduce.launches
    got = cr.chunked_reduce(x)
    torch.cuda.synchronize()
    assert cr.chunked_reduce.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (length,)
    tol = (1e-6, 2e-5) if dtype == "float32" else (8e-3, 8e-3)
    torch.testing.assert_close(got.float(),
                               cr.chunked_reduce_plain(x).float(),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("t,n,ks,nout", [
    (1024, 4, 512, 2048), (1024, 4, 512, 512), (1024, 4, 512, 8192),
    (1024, 4, 2048, 2048), (100, 3, 37, 130)])   # the last one ragged
def test_all_gather_matmul_kernel_vs_plain(cuda, t, n, ks, nout):
    """3xTF32 on the tensor cores against cuBLAS's f32 GEMM (TF32 off).
    The kernel keeps one running sum per output over K unit-normal
    products, added slab by slab; the partial sums grow like sqrt(K), so
    the rounding's spread is about K * 2^-24 and the largest of ~10^6
    outputs several times that (the earlier CUDA-core kernel measured
    1.3e-4 at K = 2048, 2.3e-3 at K = 8192): atol 8 * K * 2^-24, rtol
    1e-4."""
    from repro_torch.kernels import fused_collectives as fc
    x = _randn((t, n * ks), torch.float32, cuda)
    w = _randn((n, ks, nout), torch.float32, cuda)
    before = fc.all_gather_matmul.launches
    got = fc.all_gather_matmul(x, w)
    torch.cuda.synchronize()
    assert fc.all_gather_matmul.launches == before + 1
    torch.testing.assert_close(got, fc.all_gather_matmul_plain(x, w),
                               rtol=1e-4, atol=8 * n * ks * 2.0 ** -24)


@pytest.mark.parametrize("t,n,ks,nout,vec", [
    (64, 1, 256, 192, True),      # one shard
    (128, 8, 64, 256, True),      # eight shards, each two K slabs
    (96, 3, 40, 128, True),       # Ks not a multiple of the 32-deep slab
    (70, 2, 37, 130, False),      # K, N not multiples of 4: 4-byte copies
    (33, 4, 48, 102, False)])     # N not a multiple of 4 only
def test_all_gather_matmul_kernel_edges(cuda, t, n, ks, nout, vec):
    """Shard counts, slabs that straddle shards, and rows that are not
    16-byte aligned (the 4-byte copy path), at the same tolerance."""
    from repro_torch.kernels import fused_collectives as fc
    assert fc.agm_geometry(t, n, ks, nout)["vec"] == vec
    x = _randn((t, n * ks), torch.float32, cuda)
    w = _randn((n, ks, nout), torch.float32, cuda)
    torch.testing.assert_close(fc.all_gather_matmul(x, w),
                               fc.all_gather_matmul_plain(x, w),
                               rtol=1e-4, atol=8 * n * ks * 2.0 ** -24)


@pytest.mark.parametrize("t,n,ks,nout", [
    (1024, 4, 512, 2048), (1024, 4, 512, 512), (100, 3, 37, 130)])
def test_all_gather_matmul_kernel_repeats_bitwise(cuda, t, n, ks, nout):
    """No atomics and no split of a sum across blocks: a repeat is
    bitwise equal, whichever tile the shape takes."""
    from repro_torch.kernels import fused_collectives as fc
    x = _randn((t, n * ks), torch.float32, cuda)
    w = _randn((n, ks, nout), torch.float32, cuda)
    assert torch.equal(fc.all_gather_matmul(x, w),
                       fc.all_gather_matmul(x, w))


def test_all_gather_matmul_reads_a_strided_stack(cuda):
    """The fused FSDP gather hands the kernel a strided view of the
    gathered bucket (shards ``elems`` apart, not Ks * N)."""
    from repro_torch.kernels import fused_collectives as fc
    n, ks, nout, extra = 4, 64, 96, 1000
    bucket = _randn((n, ks * nout + extra), torch.float32, cuda)
    w = bucket[:, extra:].reshape(n, ks, nout)
    assert not w.is_contiguous()
    x = _randn((33, n * ks), torch.float32, cuda)
    torch.testing.assert_close(fc.all_gather_matmul(x, w),
                               fc.all_gather_matmul_plain(x, w),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="contraction"):
        fc.all_gather_matmul(x[:, 1:], w)


def test_fused_dense_grads_kernel_vs_plain(cuda):
    from repro_torch.kernels import fused_collectives as fc
    n, ks, nout = 4, 128, 256
    x0 = _randn((2, 64, n * ks), torch.float32, cuda)
    w0 = _randn((n, ks, nout), torch.float32, cuda)
    g = _randn((2, 64, nout), torch.float32, cuda)
    res = []
    for fn in (fc.fused_dense,
               lambda x, w: x @ w.reshape(n * ks, nout)):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        (fn(x, w) * g).sum().backward()
        res.append((x.grad, w.grad))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,d,upstream", [(1024, 2048, "random"),
                                          (1024, 4096, "random"),
                                          (4, 4096, "random"),
                                          (5, 100, "random"),
                                          (1024, 2048, "sum"),
                                          (2048, 1536, "random"),
                                          (1500, 384, "random"),
                                          (1600, 3072, "random")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_grads_kernel_vs_plain(cuda, t, d, upstream, dtype):
    """x.grad and scale.grad through the kernels (the forward kernel, then
    one launch of the backward kernel) equal autograd through the plain
    version.  ``sum``: the upstream gradient of ``.sum()`` arrives
    expanded (stride 0) in f32."""
    x0 = _randn((t, d), DTYPES[dtype], cuda)
    s0 = _randn((d,), torch.float32, cuda)
    g = _randn((t, d), DTYPES[dtype], cuda)
    res = []
    for fn in (rn.rms_norm, rn.rms_norm_plain):
        x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
        y = fn(x, s)
        before = rn.rms_norm_vjp.launches
        if upstream == "sum":
            y.sum().backward()
        else:
            (y.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        assert rn.rms_norm_vjp.launches == before + (fn is rn.rms_norm)
        res.append((x.grad, s.grad))
    tol = (1e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
    for a, b in zip(*res):
        assert a is not None and b is not None
        torch.testing.assert_close(a.float(), b.float(), rtol=tol[0],
                                   atol=tol[1])


@pytest.mark.parametrize("t,d", [(1024, 2048), (1024, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernels_repeat_bitwise(cuda, t, d, dtype):
    """The forward, dx and dscale repeat bitwise (fixed-order sums, no
    atomics), and each backward is one count of the backward kernel."""
    x = _randn((t, d), DTYPES[dtype], cuda)
    s = _randn((d,), torch.float32, cuda)
    g = _randn((t, d), DTYPES[dtype], cuda)
    out = []
    for _ in range(2):
        xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
        y = rn.rms_norm(xr, sr)
        before = rn.rms_norm_vjp.launches
        y.backward(g)
        torch.cuda.synchronize()
        assert rn.rms_norm_vjp.launches == before + 1
        out.append((y.detach(), xr.grad, sr.grad))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    dx, ds = rn.rms_norm_vjp(x, s, 1e-5, g, need_dx=False)
    assert dx is None and torch.equal(ds, out[0][2])
    dx, ds = rn.rms_norm_vjp(x, s, 1e-5, g, need_dscale=False)
    assert ds is None and torch.equal(dx, out[0][1])


@pytest.mark.parametrize("lq,window", [(1024, None), (1000, None),
                                       (512, 128)])
def test_flash_grads_kernel_vs_plain(cuda, lq, window):
    """dq/dk/dv through the kernel forward (which also writes the rows'
    max and normaliser) and the recompute VJP, against autograd through
    the dense plain version."""
    q0, k0, v0 = (_randn((1, lq, 4, 64), torch.float32, cuda)
                  for _ in range(3))
    g = _randn((1, lq, 4, 64), torch.float32, cuda)
    res = []
    for fn in (lambda q, k, v: fa.flash_attention_train(q, k, v, True,
                                                        window),
               lambda q, k, v: fa.flash_attention_plain(q, k, v, True,
                                                        window)):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        before = fa.flash_attention.launches
        (fn(q, k, v) * g).sum().backward()
        res.append((q.grad, k.grad, v.grad))
    assert fa.flash_attention.launches == before    # the plain one: none
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _pool_collectives(ctx):
    from repro_torch.launch import collectives as co
    xs = [co.bench_input_numpy(r, 64) for r in range(ctx.nranks)]
    out = {}
    for name in ("all_reduce_two_phase", "all_reduce_faithful",
                 "all_gather"):
        comm = co.communicator(ctx, "cxl", name)
        y = co.call(comm, name, co.bench_input(ctx.rank, 64, ctx.device))
        assert y.device.type == "cuda"
        out[name] = bool(np.array_equal(y.cpu().numpy(),
                                        co.oracle(name, xs, ctx.rank)))
    out["retrieved"] = ctx.pool.bytes_retrieved
    return out


def test_cxl_collectives_on_card_through_pinned_pool(cuda):
    """Two ranks share the card and a pinned host pool: all-reduce (both
    modes, reduced by the chunked_reduce kernel) and all-gather, bitwise
    against the numpy oracle."""
    from repro_torch.launch import ranks
    res = ranks.spawn(_pool_collectives, 2, device="cuda",
                      partition_bytes=1 << 20, timeout_s=300)
    for r in res:
        assert r.pop("retrieved") > 0
        assert all(r.values()), r


def _tuple_collectives(ctx):
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch import collectives as co
    from repro_torch.launch.mesh import mesh_shape
    x = co.bench_input(ctx.rank, 64, ctx.device)
    topo = parse_topology("pod:cxl,data:ici")
    out = {}
    for name in ("all_reduce_two_phase", "all_reduce_faithful",
                 "reduce_scatter"):
        flat = co.call(co.communicator(ctx, "cxl", name), name, x)
        hier = co.call(co.communicator(
            ctx, "cxl", name, shape=mesh_shape(ctx.nranks, 1, True),
            topology=topo), name, x, axis=("pod", "data"))
        torch.cuda.synchronize()
        out[name] = hier.device.type == "cuda" and torch.equal(hier, flat)
    out["retrieved"] = {g: pool.bytes_retrieved
                        for g, (_, pool) in ctx.groups.items()}
    return out


def test_tuple_collectives_on_card_equal_the_flat_axis(cuda):
    """Four ranks share the card as (pod, data) = (2, 2), each level
    group with its own pinned pool: the tuple all-reduce (both modes)
    and reduce-scatter under cxl equal the flat 4-rank results bitwise
    (integer-valued inputs), and both levels' pools moved bytes."""
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import level_groups, mesh_shape
    res = ranks.spawn(_tuple_collectives, 4, device="cuda",
                      partition_bytes=1 << 20, timeout_s=300,
                      groups=level_groups(mesh_shape(4, 1, True)))
    for r in res:
        moved = r.pop("retrieved")
        assert len(moved) == 2 and all(b > 0 for b in moved.values())
        assert all(r.values()), r


@pytest.mark.parametrize("n,t,d", [
    (2, 128, 64), (4, 256, 32), (3, 37, 48), (8, 1, 16),   # the JAX tests'
    (4, 1024, 2048),           # one rank's rows at Llama-3.2-1B's width
    (3, 1000, 2048),           # ragged T
    (2, 5, 100),               # rows not 16-byte aligned: scalar path
    (4, 64, 16384)])           # the widest aligned f32 row
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_scatter_rmsnorm_kernel_vs_plain(cuda, n, t, d, dtype):
    """Tolerances: the reference test's (rtol 1e-6, atol 1e-7 f32; 2e-2,
    1e-2 bf16), widened for f32 to rtol 1e-5, atol 1e-6: the kernel and
    torch sum the D squares in other orders (a random walk of about
    sqrt(D) roundings of 2^-24 relative, which reaches 1e-6 at D = 2048),
    and the result is that sum's rsqrt times values up to about 5."""
    from repro_torch.kernels import fused_collectives as fc
    x = _randn((n, t, d), DTYPES[dtype], cuda)
    s = _randn((d,), torch.float32, cuda)
    before = fc.reduce_scatter_rmsnorm.launches
    got = fc.reduce_scatter_rmsnorm(x, s)
    again = fc.reduce_scatter_rmsnorm(x, s)
    torch.cuda.synchronize()
    assert fc.reduce_scatter_rmsnorm.launches == before + 2
    assert torch.equal(got, again)        # bitwise repeatable
    tol = (1e-5, 1e-6) if dtype == "float32" else (2e-2, 1e-2)
    torch.testing.assert_close(
        got.float(), fc.reduce_scatter_rmsnorm_plain(x, s).float(),
        rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("n,length,wd", [
    (2, 2048, 0.0), (4, 3 * 2048, 0.1), (3, 1000, 0.0), (6, 7, 0.01),
    (4, 15204352, 0.1),          # one rank's grad segment of a row
    (4, 1000003, 0.0)])          # ragged: the scalar path
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_reduce_scatter_adamw_kernel_vs_plain(cuda, n, length, wd, p_dtype):
    """The reference test's tolerances, rtol 1e-6 and atol 1e-7 (f32
    moments and f32 params): every step is one IEEE-rounded operation on
    both sides, only the shard sum may associate differently.  A bf16
    param: rtol 2e-2, atol 1e-2 on p'."""
    from repro_torch.kernels import fused_collectives as fc
    g = _randn((n, length), torch.float32, cuda)
    p = _randn((length,), DTYPES[p_dtype], cuda)
    m = _randn((length,), torch.float32, cuda) * 0.1
    v = torch.as_tensor(RNG.random(length).astype(np.float32), device=cuda) \
        * 0.01
    hyper = (3e-3, 1.0 - 0.9 ** 3, 1.0 - 0.95 ** 3)
    before = fc.reduce_scatter_adamw.launches
    got = fc.reduce_scatter_adamw(g, p, m, v, *hyper, weight_decay=wd)
    again = fc.reduce_scatter_adamw(g, p, m, v, *hyper, weight_decay=wd)
    torch.cuda.synchronize()
    assert fc.reduce_scatter_adamw.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fc.reduce_scatter_adamw_plain(g, p, m, v, *hyper,
                                         weight_decay=wd)
    for name, a, b in zip("pmv", got, want):
        tol = (2e-2, 1e-2) if name == "p" and p_dtype == "bfloat16" \
            else (1e-6, 1e-7)
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a.float(), b.float(), rtol=tol[0],
                                   atol=tol[1], msg=name)


def test_reduce_scatter_adamw_reads_hypers_on_the_card(cuda):
    """0-d CUDA tensors for lr and the bias corrections give what the
    same numbers give; bf16 partials are summed in f32."""
    from repro_torch.kernels import fused_collectives as fc
    g = _randn((4, 4096), torch.bfloat16, cuda)
    p, m = (_randn((4096,), torch.float32, cuda) for _ in range(2))
    v = _randn((4096,), torch.float32, cuda).abs()
    nums = (1e-3, 0.1, 0.05)
    tens = tuple(torch.tensor(h, device=cuda) for h in nums)
    a = fc.reduce_scatter_adamw(g, p, m, v, *nums, weight_decay=0.1)
    b = fc.reduce_scatter_adamw(g, p, m, v, *tens, weight_decay=0.1)
    want = fc.reduce_scatter_adamw_plain(g, p, m, v, *nums,
                                         weight_decay=0.1)
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, w, rtol=1e-6, atol=1e-7)


def _auto_collectives(ctx, plan_path):
    from repro_torch.core import ledger
    from repro_torch.launch import collectives as co
    from repro_torch.tuner import load_plan
    plan = load_plan(plan_path)
    rows = 256                              # 1 MiB per rank
    xs = [co.bench_input_numpy(r, rows) for r in range(ctx.nranks)]
    out = {}
    for name in co.PRIMITIVES:
        comm = co.communicator(ctx, "auto", name, plan=plan)
        ledger.reset()
        y = co.call(comm, name, co.bench_input(ctx.rank, rows, ctx.device))
        torch.cuda.synchronize()
        choices = ledger.snapshot()["auto_choices"]
        ok = len(choices) == 1 and choices[0]["backend"] in ("ring", "cxl")
        out[name] = ok and bool(np.array_equal(
            y.cpu().numpy(), co.oracle(name, xs, ctx.rank)))
    out["retrieved"] = ctx.pool.bytes_retrieved
    return out


def test_auto_collectives_on_card_match_the_oracle(cuda, tmp_path):
    """Four ranks share the card under backend='auto' with a plan tuned
    for 4 ranks: every primitive, at 1 MiB per rank, resolves one plan
    cell and returns the numpy oracle's result bitwise."""
    from repro_torch import tuner
    from repro_torch.core.hw import MiB
    from repro_torch.launch import ranks
    path = str(tmp_path / "plan.json")
    tuner.save_plan(tuner.generate_plan(tuner.TuneGrid(
        nranks=(4,), sizes=(1 * MiB, 16 * MiB))), path)
    res = ranks.spawn(_auto_collectives, 4, (path,), device="cuda",
                      partition_bytes=4 << 20, timeout_s=300)
    for r in res:
        assert r.pop("retrieved") > 0     # some cells chose the pool
        assert all(r.values()), r


# ---------------------------------------------------------------------- #
# the tensor-parallel slice: the kernels at the (data, model) = (2, 2)
# path's shapes (Llama-3.2-1B, 2 sequences of 1024 tokens a rank)
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("nout,tile", [(256, 1), (1024, 0), (4096, 0)])
def test_all_gather_matmul_kernel_at_the_tp_shapes(cuda, nout, tile):
    """x (2048, 2 x 1024) @ the (2, 1024, N) stack of this model rank's
    columns of wk/wv (N = 256), wq (1024) and wg/wu (4096), at the tile
    ``agm_geometry`` chooses, against the plain version at the
    tolerance of ``test_all_gather_matmul_kernel_vs_plain``, and
    bitwise on repeat."""
    from repro_torch.kernels import fused_collectives as fc
    t, n, ks = 2048, 2, 1024
    assert fc.agm_geometry(t, n, ks, nout)["tile"] == tile
    x = _randn((t, n * ks), torch.float32, cuda)
    w = _randn((n, ks, nout), torch.float32, cuda)
    before = fc.all_gather_matmul.launches
    got = fc.all_gather_matmul(x, w)
    torch.cuda.synchronize()
    assert fc.all_gather_matmul.launches == before + 1
    torch.testing.assert_close(got, fc.all_gather_matmul_plain(x, w),
                               rtol=1e-4, atol=8 * n * ks * 2.0 ** -24)
    assert torch.equal(got, fc.all_gather_matmul(x, w))


def test_flash_kernel_at_the_tp_shape(cuda):
    """(2, 1024, 16, 64) causal, f32: a rank's 2 sequences and its 16
    of the 32 heads, forward and the recompute VJP against the plain
    version's autograd."""
    q, k, v = (_randn((2, 1024, 16, 64), torch.float32, cuda)
               .requires_grad_(True) for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention_train(q, k, v, True)
    assert fa.flash_attention.launches > before
    want = fa.flash_attention_plain(q, k, v, True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)
    dy = _randn((2, 1024, 16, 64), torch.float32, cuda)
    g_got = torch.autograd.grad(got, (q, k, v), dy)
    g_want = torch.autograd.grad(want, (q, k, v), dy)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------- #
# the MoE slice: the kernels at Granite-3.0-MoE's shapes over (data,
# model) = (2, 2) (d_model 1536, 24 q / 8 kv heads, 2 x 1024 tokens a
# rank), and the smoke MoE models on the card
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("nout", [768, 256])
def test_all_gather_matmul_kernel_at_the_moe_shapes(cuda, nout):
    """x (2048, 2 x 768) @ the (2, 768, N) stack of this model rank's
    columns of wq (N = 768) and wk/wv (256), at the tile
    ``agm_geometry`` chooses (the 64 x 32 tile at both), against the
    plain version at the tolerance of
    ``test_all_gather_matmul_kernel_vs_plain``, and bitwise on
    repeat."""
    from repro_torch.kernels import fused_collectives as fc
    t, n, ks = 2048, 2, 768
    assert fc.agm_geometry(t, n, ks, nout)["tile"] == 1
    x = _randn((t, n * ks), torch.float32, cuda)
    w = _randn((n, ks, nout), torch.float32, cuda)
    before = fc.all_gather_matmul.launches
    got = fc.all_gather_matmul(x, w)
    torch.cuda.synchronize()
    assert fc.all_gather_matmul.launches == before + 1
    torch.testing.assert_close(got, fc.all_gather_matmul_plain(x, w),
                               rtol=1e-4, atol=8 * n * ks * 2.0 ** -24)
    assert torch.equal(got, fc.all_gather_matmul(x, w))


def test_flash_kernel_at_the_moe_shape(cuda):
    """(2, 1024, 12, 64) causal, f32: a rank's 2 sequences and its 12 of
    the 24 q heads, its 4 kv heads repeated 3:1 (GQA) as the model hands
    them over, forward and the recompute VJP against the plain
    version's autograd."""
    q = _randn((2, 1024, 12, 64), torch.float32, cuda).requires_grad_(True)
    k, v = (_randn((2, 1024, 4, 64), torch.float32, cuda)
            .requires_grad_(True) for _ in range(2))
    kk, vv = (torch.repeat_interleave(t, 3, dim=2) for t in (k, v))
    before = fa.flash_attention.launches
    got = fa.flash_attention_train(q, kk, vv, True)
    assert fa.flash_attention.launches > before
    want = fa.flash_attention_plain(q, kk, vv, True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)
    dy = _randn((2, 1024, 12, 64), torch.float32, cuda)
    g_got = torch.autograd.grad(got, (q, k, v), dy)
    g_want = torch.autograd.grad(want, (q, k, v), dy)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("length", [1_572_864, 25_196_544])
def test_chunked_reduce_kernel_at_the_moe_shapes(cuda, length):
    """N = 2: the model level's activation AllReduce of (2048, 1536) f32
    (two-phase: half of it a rank) and the data level's reduce-scatter
    of one model rank's half of a row's FSDP bucket (attention, router
    and its 20 experts)."""
    from repro_torch.kernels import chunked_reduce as cr
    x = _randn((2, length), torch.float32, cuda)
    before = cr.chunked_reduce.launches
    got = cr.chunked_reduce(x)
    torch.cuda.synchronize()
    assert cr.chunked_reduce.launches == before + 1
    torch.testing.assert_close(got, cr.chunked_reduce_plain(x), rtol=1e-6,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_smoke_moe_model_on_card_matches_cpu(cuda, arch):
    """A smoke MoE model's prefill at L = 1100 (the flash kernel, the
    router, the capacity's drops) and three drop-free decode steps, the
    card against the CPU with the same params (rtol 2e-4, atol 2e-5, as
    ``test_smoke_model_on_card_matches_cpu``)."""
    cfg = get_config(arch, smoke=True)
    cpu = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = model.params_from_numpy(model.params_to_numpy(cpu), cuda)
    toks = RNG.integers(0, cfg.vocab_size, (1, 1100))
    outs = []
    for params, dev in ((cpu, torch.device("cpu")), (gpu, cuda)):
        before = fa.flash_attention.launches
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(toks, device=dev)}, cfg,
            UNSHARDED, 1104, cache_dtype=torch.float32)
        res = [logits]
        pos = torch.tensor([1100], device=dev)
        for i in range(3):
            lg, caches = model.decode_step(
                params, caches, torch.tensor([[5 + i]], device=dev), pos,
                cfg, UNSHARDED)
            res.append(lg)
            pos = pos + 1
        outs.append([t.cpu() for t in res + [caches[0]["k"]]])
    assert fa.flash_attention.launches == before + cfg.n_layers
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------- #
# the non-text models: the kernels at whisper-tiny's (encoder S = 1500,
# cross attention lq != lk, d_model 384) and Phi-3-vision's (head_dim
# 96, 576 + 1024 tokens, d_model 3072) shapes, and both smoke models on
# the card
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,lq,lk,h,d,causal", [
    (1, 1600, 1600, 32, 96, True), (4, 1024, 1500, 6, 64, False),
    (2, 77, 141, 3, 96, True)])
def test_flash_kernel_new_shapes_repeat_bitwise(cuda, b, lq, lk, h, d,
                                                causal, dtype):
    """The D = 96 build and the lq != lk launch repeat bitwise, o, m and
    l (no atomics, fixed-order sums)."""
    q = _randn((b, lq, h, d), DTYPES[dtype], cuda)
    k, v = (_randn((b, lk, h, d), DTYPES[dtype], cuda) for _ in range(2))
    outs = [fa._launch(q, k, v, causal, None, 0, lk, True)
            for _ in range(2)]
    for x, y in zip(*outs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,lq,lk,h,d,causal", [
    (1, 1024, 1500, 6, 64, False), (1, 1500, 1500, 6, 64, False),
    (1, 1100, 1100, 8, 96, True), (1, 77, 141, 3, 96, False)])
def test_flash_grads_at_the_frontend_shapes(cuda, b, lq, lk, h, d, causal):
    """dq/dk/dv through the kernel forward and the recompute VJP against
    autograd through the dense plain version: cross attention (lq !=
    lk), the encoder's non-causal 1500, head_dim 96 (causal, and ragged
    non-causal)."""
    q0 = _randn((b, lq, h, d), torch.float32, cuda)
    k0, v0 = (_randn((b, lk, h, d), torch.float32, cuda)
              for _ in range(2))
    g = _randn((b, lq, h, d), torch.float32, cuda)
    res = []
    for fn in (fa.flash_attention_train, fa.flash_attention_plain):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        before = fa.flash_attention.launches
        (fn(q, k, v, causal) * g).sum().backward()
        res.append((q.grad, k.grad, v.grad))
        if fn is fa.flash_attention_train:
            assert fa.flash_attention.launches == before + 1
    for a, b_ in zip(*res):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,n,ks,nout,tile", [
    (1024, 4, 96, 384, 1), (1500, 4, 96, 384, 1), (1024, 4, 96, 1536, 1),
    (1600, 4, 768, 3072, 0), (1600, 4, 768, 8192, 0)])
def test_all_gather_matmul_kernel_at_the_frontend_shapes(cuda, t, n, ks,
                                                         nout, tile):
    """``--fuse-kernels`` at ``--mesh 4x1``: whisper-tiny's (T, 4 x 96)
    @ N = 384 (wq, wk, wv; T = 1500 for cross attention's wk / wv on the
    encoder's output) and 1536 (wg, wu), Phi-3-vision's (1600, 4 x 768)
    @ N = 3072 and 8192, at the tile ``agm_geometry`` chooses (64 x 32
    for whisper, 128 x 128 for Phi-3), against the plain version at the
    tolerance of ``test_all_gather_matmul_kernel_vs_plain``, and bitwise
    on repeat."""
    from repro_torch.kernels import fused_collectives as fc
    assert fc.agm_geometry(t, n, ks, nout)["tile"] == tile
    x = _randn((t, n * ks), torch.float32, cuda)
    w = _randn((n, ks, nout), torch.float32, cuda)
    before = fc.all_gather_matmul.launches
    got = fc.all_gather_matmul(x, w)
    torch.cuda.synchronize()
    assert fc.all_gather_matmul.launches == before + 1
    torch.testing.assert_close(got, fc.all_gather_matmul_plain(x, w),
                               rtol=1e-4, atol=8 * n * ks * 2.0 ** -24)
    assert torch.equal(got, fc.all_gather_matmul(x, w))


@pytest.mark.parametrize("arch", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_frontend_smoke_on_card_matches_cpu(cuda, arch):
    """A smoke model with a stub frontend: prefill of 2 prompts of 1100
    tokens with their extras (the decoder's self attention through the
    flash kernel) and three per-slot decode steps, every cache leaf
    (whisper's cross-attention ``ck`` / ``cv`` included) and the logits,
    then the loss and every grad of a training forward, the card against
    the CPU (rtol 2e-4, atol 2e-5; cache leaves and grads atol 2e-5 of
    the leaf's largest entry: a cache entry sums over 1100 positions and
    the model width in other orders on the two sides, so its error
    scales with the leaf's magnitude, not with an entry that cancels
    near zero)."""
    from repro_torch.data.pipeline import batch_for
    from repro_torch.serving import kvcache
    cfg = get_config(arch, smoke=True)
    cpu = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = model.params_from_numpy(model.params_to_numpy(cpu), cuda)
    b = batch_for(cfg, RNG.integers(0, cfg.vocab_size, (2, 1101)),
                  np.random.default_rng(1))
    prefix = cfg.frontend_tokens if cfg.encoder is None else 0
    outs, grads = [], []
    for params, dev in ((cpu, torch.device("cpu")), (gpu, cuda)):
        batch = {k: torch.as_tensor(v, device=dev, dtype=torch.long
                                    if v.dtype.kind == "i" else None)
                 for k, v in b.items()}
        before = fa.flash_attention.launches
        logits, caches = model.prefill(
            params, {k: v for k, v in batch.items() if k != "labels"}, cfg,
            UNSHARDED, prefix + 1104, cache_dtype=torch.float32)
        res = [logits]
        pos = torch.tensor([prefix + 1100] * 2, device=dev)
        for i in range(3):
            lg, caches = model.decode_step(
                params, caches, torch.tensor([[5 + i], [9]], device=dev),
                pos, cfg, UNSHARDED)
            res.append(lg)
            pos = pos + 1
        if dev.type == "cuda":
            assert fa.flash_attention.launches == before + cfg.n_layers
        res += [leaf for leaf in kvcache.cache_leaves(caches)]
        train = {k: v.clone().requires_grad_()
                 for k, v in _flat(params).items()}
        short = {"tokens": batch["tokens"][:, :64],
                 "labels": batch["labels"][:, :64],
                 **{k: v for k, v in batch.items()
                    if k not in ("tokens", "labels")}}
        loss, _ = model.loss_fn(_unflat(train), short, cfg, UNSHARDED)
        loss.backward()
        res.append(loss.detach())
        outs.append([t.cpu() for t in res])
        grads.append({k: t.grad.cpu() for k, t in train.items()})
    assert len(outs[0]) == 4 + (4 if cfg.encoder else 2) + 1
    for i, (a, b_) in enumerate(zip(outs[1], outs[0])):
        leaf = 4 <= i < len(outs[0]) - 1       # a cache leaf
        torch.testing.assert_close(
            a, b_, rtol=2e-4,
            atol=2e-5 * (max(1.0, float(b_.abs().max())) if leaf else 1.0))
    for k, w in grads[0].items():
        torch.testing.assert_close(grads[1][k], w, rtol=2e-4,
                                   atol=2e-5 * float(w.abs().max()),
                                   msg=k)


def test_pool_store_round_trip_through_pinned_memory(cuda, tmp_path):
    """``PoolCheckpointStore`` in a ``PoolRegion`` on the card: this
    rank's partition pinned (``cudaHostRegister``), card tensors
    snapshotted with device-to-host copies and restored into card
    tensors in place; the slot's image is bitwise the image a CPU store
    writes of the same values, and the restored tensors equal the
    originals bitwise."""
    from repro_torch.core.pool import create_backing
    from repro_torch.training.checkpoint import (PoolCheckpointStore,
                                                 PoolRegion)
    tree = {"params": {"w": _randn((1000, 257), torch.float32, cuda),
                       "b": _randn((3,), torch.float32, cuda)},
            "opt": {"step": torch.tensor([7], device=cuda)}}
    cap = 2 * (4 * (1000 * 257 + 3) + 8 + (1 << 20)) + 4096
    path, fd = create_backing(PoolRegion.total_bytes(2, cap))
    try:
        region = PoolRegion(path, 2, 1, cap, cuda)
        rep = region.store.snapshot(5, tree, meta={"data_step": 5})
        cpu = PoolCheckpointStore(cap)
        cpu_tree = {"params": {k: v.cpu() for k, v in
                               tree["params"].items()},
                    "opt": {"step": tree["opt"]["step"].cpu()}}
        assert cpu.snapshot(5, cpu_tree, meta={"data_step": 5}) == rep
        assert region.store.image(5) == cpu.image(5)
        out = {"params": {k: torch.zeros_like(v) for k, v in
                          tree["params"].items()},
               "opt": {"step": torch.zeros_like(tree["opt"]["step"])}}
        got, meta = region.store.restore(out, out=out)
        torch.cuda.synchronize()
        assert meta == {"data_step": 5}
        for k in tree["params"]:
            assert got["params"][k] is out["params"][k]
            assert torch.equal(got["params"][k], tree["params"][k])
        assert int(got["opt"]["step"][0]) == 7
        region.close()
    finally:
        os.close(fd)


def _launch_cases(dev):
    """Each kernel's call at a small shape on ``dev``, with the counter
    its wrapper adds one to where it launches."""
    from repro_torch.kernels import chunked_reduce as cr
    from repro_torch.kernels import fused_collectives as fc

    def m(*shape):
        return torch.randn(shape, device=dev) if dev.type == "cuda" \
            else torch.empty(shape, device=dev)
    return {
        "rms_norm": (lambda: rn.rms_norm(m(6, 256), m(256), 1e-5),
                     lambda: rn.rms_norm.launches),
        "flash_attention": (lambda: fa.flash_attention(
            m(1, 64, 2, 64), m(1, 64, 2, 64), m(1, 64, 2, 64)),
            lambda: fa.flash_attention.launches),
        "chunked_reduce": (lambda: cr.chunked_reduce(m(3, 4096)),
                           lambda: cr.chunked_reduce.launches),
        "all_gather_matmul": (lambda: fc.all_gather_matmul(
            m(64, 2 * 64), m(2, 64, 128)),
            lambda: fc.all_gather_matmul.launches),
        "ssm_scan": (lambda: ss.ssm_scan(
            m(1, 16, 64), m(1, 16, 64).abs(), -m(64, 16).abs(),
            m(1, 16, 16), m(1, 16, 16), m(64)),
            lambda: ss.ssm_scan.launches),
    }


@pytest.mark.parametrize("name", ["rms_norm", "flash_attention",
                                  "chunked_reduce", "all_gather_matmul",
                                  "ssm_scan"])
def test_cuda_launches_while_meta_traces(cuda, name):
    """The dry-run's dispatch on the card's machine: a CUDA tensor still
    launches the kernel (its counter moves by one), while a meta tensor
    of the same shape takes the plain version's shape-only path (a meta
    result of the same shape, no launch)."""
    fn, count = _launch_cases(cuda)[name]
    before = count()
    got = fn()
    torch.cuda.synchronize()
    assert count() == before + 1 and got.device.type == "cuda"
    meta_fn, _ = _launch_cases(torch.device("meta"))[name]
    out = meta_fn()
    assert count() == before + 1
    assert out.device.type == "meta" and out.shape == got.shape
