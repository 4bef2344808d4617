"""The hand-written CUDA kernels against their plain PyTorch versions, and
the port's model and engine on the card against the same code on the
CPU.  Needs an NVIDIA GPU with nvcc: every test is marked ``cuda`` and
skips without a card.  Imports no JAX, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
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
                                 (5, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernel_vs_plain(cuda, t, d, dtype):
    """(5, 100): rows not 16-byte aligned take the scalar path."""
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
    (1, 128, 128, 2, 64, False, None, 0)])
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
