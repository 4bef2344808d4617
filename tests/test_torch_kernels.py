"""The port's kernels: the plain versions against the JAX package's
Pallas kernels (interpret mode) and jnp twins on the same numpy inputs.
Shapes and tolerances mirror tests/test_kernels.py and
tests/test_flash_jnp.py.  The CUDA kernels themselves are held against
the plain versions in tests/test_torch_cuda.py, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import layers as jax_layers
from repro.models.flash import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import flash as torch_flash
from repro_torch.models import layers

RNG = np.random.default_rng(0)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16 rounds identically)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(a).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- rms_norm ------------------------------------------------------------ #

@pytest.mark.parametrize("t,d", [(64, 128), (300, 256), (1000, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_plain_vs_pallas_and_layers(t, d, dtype):
    jx, tx = _pair(RNG.standard_normal((t, d)).astype(np.float32), dtype)
    s = RNG.standard_normal((d,)).astype(np.float32)
    got = rn.rms_norm(tx, torch.as_tensor(s))       # CPU: plain version
    tol = dict(rtol=2e-2 if dtype == "bfloat16" else 1e-5, atol=1e-2)
    pallas = ops.rms_norm(jx, jnp.asarray(s), rows=128)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **tol)
    np.testing.assert_allclose(
        _f32(got), _f32(jax_layers.rms_norm(jx, jnp.asarray(s))), **tol)
    np.testing.assert_allclose(_f32(got), _f32(ref.rms_norm_ref(
        jx, jnp.asarray(s))), **tol)


def test_layers_rms_norm_flattens_rows():
    x = RNG.standard_normal((2, 5, 64)).astype(np.float32)
    s = RNG.standard_normal((64,)).astype(np.float32)
    got = layers.rms_norm(torch.as_tensor(x), torch.as_tensor(s))
    want = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(s))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_rms_norm_wrapper_checks():
    with pytest.raises(ValueError):
        rn.rms_norm(torch.zeros(4, 8), torch.zeros(7))
    with pytest.raises(TypeError):
        rn.rms_norm(torch.zeros(4, 8, dtype=torch.float16), torch.zeros(8))


# the paths' shapes (Llama serve prefill and training forward, decode;
# Falcon-Mamba prefill, decode; the training backward) and (5, 100):
# (tpr, v, rows_per_block, grid) on the H100's 132 SMs
@pytest.mark.parametrize("rows,d,itemsize,backward,want", [
    (1024, 2048, 4, False, (128, 4, 2, 512)),
    (4, 2048, 4, False, (512, 1, 1, 4)),         # spread: one vector each
    (1024, 4096, 4, False, (256, 4, 1, 1024)),
    (4, 4096, 4, False, (512, 2, 1, 4)),
    (1024, 2048, 2, False, (128, 2, 2, 512)),    # bf16
    (1024, 2048, 4, True, (256, 2, 4, 264)),     # two blocks an SM
    (5, 100, 4, False, (32, 1, 8, 1)),
    (5, 100, 2, False, (128, 1, 2, 3)),          # unaligned bf16: N = 1
    (5, 100, 4, True, (32, 1, 1, 5)),
    # train_lm's d_model 768 at one rank (8 x 256 rows) and a rank at data
    # 2: 192 vectors over 64 threads, 4 a thread, the last predicated off
    (2048, 768, 4, False, (64, 4, 4, 512)),
    (1024, 768, 4, False, (64, 4, 4, 256)),
    (2048, 768, 4, True, (128, 2, 4, 528))])
def test_rms_geometry_pins(rows, d, itemsize, backward, want):
    """rms_geometry's launch per shape: a forward thread holds at most 16
    elements (a backward 8), a block 256 threads, a short grid spreads its
    rows; the threads a block never pass the kernel's launch bound."""
    geo = rn.rms_geometry(rows, d, itemsize, backward=backward)
    assert (geo["tpr"], geo["v"], geo["rows_per_block"],
            geo["grid"]) == want
    assert geo["threads"] <= (512 if geo["v"] * geo["vec"] <= 16 else 256)
    assert geo["v"] * geo["tpr"] * geo["vec"] >= d


def test_rms_geometry_refuses_rows_wider_than_it_holds():
    assert rn.rms_geometry(1024, 8192, 4, backward=True)["tpr"] == 512
    for backward in (False, True):
        with pytest.raises(ValueError, match="cannot hold"):
            rn.rms_geometry(1024, 16384, 4, backward=backward)


# -- flash attention ----------------------------------------------------- #

def _bhld_to_model(x: np.ndarray) -> torch.Tensor:
    """(BH, L, D) -> model layout (B=BH, L, H=1, D)."""
    return torch.as_tensor(x)[:, :, None, :]


@pytest.mark.parametrize("bh,l,d", [(4, 256, 64), (2, 512, 128),
                                    (1, 384, 64)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 128),
                                           (False, None)])
def test_flash_plain_vs_pallas(bh, l, d, causal, window):
    q, k, v = (RNG.standard_normal((bh, l, d)).astype(np.float32)
               for _ in range(3))
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               window=window)
    got = fa.flash_attention(_bhld_to_model(q), _bhld_to_model(k),
                             _bhld_to_model(v), causal=causal,
                             window=window)
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want),
                               rtol=1e-4, atol=2e-5)


def test_flash_plain_vs_pallas_bf16():
    arrs = [RNG.standard_normal((2, 256, 64)).astype(np.float32)
            for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in arrs)
    want = ops.flash_attention(jq, jk, jv)
    got = fa.flash_attention(tq[:, :, None], tk[:, :, None],
                             tv[:, :, None])
    np.testing.assert_allclose(_f32(got[:, :, 0]), _f32(want), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("l,blk,causal,window", [
    (128, 64, True, None), (200, 64, True, None), (256, 64, True, 96),
    (128, 32, False, None), (512, 128, True, 128)])
def test_flash_plain_vs_jnp_blocked(l, blk, causal, window):
    """Ragged L (200 with 64-row blocks) included."""
    q, k, v = (RNG.standard_normal((2, l, 4, 32)).astype(np.float32)
               for _ in range(3))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal, window, 0, blk)
    got = torch_flash.flash_attention(torch.as_tensor(q),
                                      torch.as_tensor(k),
                                      torch.as_tensor(v), causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("lq,lk,window", [(64, 200, None), (37, 130, 48),
                                          (100, 100, None)])
def test_flash_plain_vs_jnp_q_offset(lq, lk, window):
    """A q chunk at the end of a longer (ragged) kv sequence: causal on
    absolute positions, q_offset = Lk - Lq."""
    q = RNG.standard_normal((1, lq, 2, 32)).astype(np.float32)
    k, v = (RNG.standard_normal((1, lk, 2, 32)).astype(np.float32)
            for _ in range(2))
    off = lk - lq
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                     window, off, 64)
    got = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), True, window, off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


def test_flash_plain_kv_len_masks_ragged_edge():
    """kv_len < Lk equals attention over the first kv_len keys."""
    q, k, v = (torch.as_tensor(RNG.standard_normal((1, 20, 2, 64))
                               .astype(np.float32)) for _ in range(3))
    got = fa.flash_attention(q[:, :10], k, v, causal=False, kv_len=13)
    want = fa.flash_attention(q[:, :10], k[:, :13], v[:, :13],
                              causal=False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_flash_wrapper_checks():
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x, window=0)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x, kv_len=9)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x[:, :, :1], x)


# -- the CPU plain versions' first math call ----------------------------- #

_FIRST_EXP = """
import numpy as np
import jax.numpy as jnp
import torch
from repro.kernels import ops, ref
import repro_torch.kernels.ssm_scan
rng = np.random.default_rng(0)
rng.standard_normal((2, 256, 256))                      # x
dt = (np.abs(rng.standard_normal((2, 256, 256))) * 0.1).astype(np.float32)
a = -np.abs(rng.standard_normal((256, 16))).astype(np.float32)
p = torch.as_tensor(dt)[..., None] * torch.as_tensor(a)[None, None]
want = np.exp(p.numpy().astype(np.float64)).astype(np.float32)
err = float(np.abs(torch.exp(p).numpy() - want).max())
assert err <= 2.0 ** -24, err
"""


def test_first_exp_of_a_process_is_accurate():
    """In a fresh process that imported JAX and the port's kernels, as
    ``tests/test_torch_ssm.py`` does, the first large f32 ``exp`` -
    ``ssm_scan_plain``'s decay on that file's inputs - is within an ulp
    of numpy's, in each of 4 processes run one after another (before
    ``repro_torch.kernels`` settled torch's CPU math on import, 7
    processes in 10 were up to 1.1e-4 off)."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    for _ in range(4):     # one at a time: the race needs idle cores
        res = subprocess.run([sys.executable, "-c", _FIRST_EXP], env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
