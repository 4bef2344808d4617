"""The port's model (repro_torch.models) against the JAX reference with
the same numpy params: params interchange, prefill logits and caches,
per-slot decode steps, and the flash dispatch at L >= 1024.  float32
throughout; tolerance rtol 1e-4 / atol 1e-5 (two f32 matmul stacks that
sum in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models.pcontext import UNSHARDED as JAX_UNSHARDED
from repro_torch.configs import get_config
from repro_torch.models import model
from repro_torch.models.pcontext import UNSHARDED

RTOL, ATOL = 1e-4, 1e-5
ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_model.init_params(jax.random.key(0), jcfg, tp=1,
                                    dtype=jnp.float32)
    npp = jax.tree.map(np.asarray, jparams)
    params = model.params_from_numpy(npp, "cpu")
    return get_config(ARCH, smoke=True), jcfg, jparams, npp, params


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def test_params_numpy_round_trip(setup):
    _cfg, _jcfg, _jparams, npp, params = setup
    back = model.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(npp)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_init_params_layout_matches_reference(setup):
    cfg, _jcfg, _jparams, npp, _params = setup
    mine = model.params_to_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    ref = jax.tree_util.tree_leaves_with_path(npp)
    got = jax.tree_util.tree_leaves_with_path(mine)
    assert [(p, a.shape, a.dtype) for p, a in ref] == \
        [(p, a.shape, a.dtype) for p, a in got]


def _prefill_both(setup, tokens, max_seq):
    cfg, jcfg, jparams, _npp, params = setup
    jl, jc = jax_model.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                               jcfg, JAX_UNSHARDED, max_seq,
                               cache_dtype=jnp.float32)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(tokens)},
                           cfg, UNSHARDED, max_seq,
                           cache_dtype=torch.float32)
    return jl, jc, tl, tc


@pytest.mark.parametrize("batch,length", [(2, 8), (1, 33)])
def test_prefill_matches_reference(setup, batch, length):
    rng = np.random.default_rng(length)
    tokens = rng.integers(0, 512, (batch, length)).astype(np.int32)
    jl, jc, tl, tc = _prefill_both(setup, tokens, 48)
    assert tuple(tl.shape) == jl.shape
    _close(tl, jl)
    assert len(tc) == len(jc)
    for k in ("k", "v"):
        assert tuple(tc[0][k].shape) == jc[0][k].shape
        _close(tc[0][k], jc[0][k])


def test_decode_steps_vector_pos_match_reference(setup):
    """Three per-slot decode steps from a prefilled cache, slots at
    different depths (vector pos)."""
    cfg, jcfg, jparams, _npp, params = setup
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (2, 8)).astype(np.int32)
    _jl, jc, _tl, tc = _prefill_both(setup, tokens, 32)
    pos = np.array([8, 5], np.int32)
    for step in range(3):
        tok = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jlog, jc = jax_model.decode_step(jparams, jc, jnp.asarray(tok),
                                         jnp.asarray(pos), jcfg,
                                         JAX_UNSHARDED)
        tlog, tc = model.decode_step(params, tc, torch.as_tensor(tok),
                                     torch.as_tensor(pos), cfg, UNSHARDED)
        _close(tlog, jlog)
        for k in ("k", "v"):
            _close(tc[0][k], jc[0][k])
        pos = pos + 1


def test_decode_inactive_slot_untouched(setup):
    """The in-place decode writes nothing into an inactive slot."""
    cfg, _jcfg, _jparams, _npp, params = setup
    caches = model.init_cache(cfg, UNSHARDED, 2, 16, torch.float32,
                              device="cpu")
    for c in caches:
        for t in c.values():
            t.normal_(generator=torch.Generator().manual_seed(1))
    before = [{k: t.clone() for k, t in c.items()} for c in caches]
    model.decode_step(params, caches, torch.tensor([[3], [4]]),
                      torch.tensor([5, 9]), cfg, UNSHARDED,
                      active=torch.tensor([True, False]))
    for c, b in zip(caches, before):
        for k in c:
            assert torch.equal(c[k][:, 1], b[k][:, 1])
            assert not torch.equal(c[k][:, 0, 5], b[k][:, 0, 5])


def test_prefill_flash_dispatch_matches_reference(setup):
    """L = 1100 >= FLASH_THRESHOLD: the reference runs models/flash.py,
    the port the flash kernel's wrapper (its plain version on CPU)."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 512, (1, 1100)).astype(np.int32)
    jl, jc, tl, tc = _prefill_both(setup, tokens, 1104)
    _close(tl, jl)
    for k in ("k", "v"):
        _close(tc[0][k], jc[0][k])
