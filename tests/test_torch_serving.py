"""The port's serving engine (repro_torch.serving) against the JAX
reference with the same numpy params, plus the engine's own invariants:
greedy tokens equal the reference's, eviction to the pool and to
recompute reproduce the roomy run bit for bit, pooled prefixes cross
engines, sampled streams do not depend on scheduling, cache images are
byte-identical to the reference's, and the placement oracle agrees with
the reference given the same roofline constants."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.hw import TPU_V5E
from repro.models import model as jax_model
from repro.models.pcontext import UNSHARDED as JAX_UNSHARDED
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import PooledKVStore as JaxPooledKVStore
from repro.serving import kvcache as jax_kvcache
from repro_torch.configs import get_config
from repro_torch.core import ledger
from repro_torch.models import model
from repro_torch.models.pcontext import UNSHARDED
from repro_torch.serving import (PooledKVStore, Request, SamplingParams,
                                 ServeConfig, ServeEngine, kvcache)

ARCH = "llama3.2-1b"
RNG = np.random.default_rng(0)
_TIGHT = dict(decode_slots=2, kv_block_tokens=4, hbm_budget_blocks=6)


@pytest.fixture(scope="module")
def shared():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_model.init_params(jax.random.key(0), jcfg, tp=1,
                                    dtype=jnp.float32)
    params = model.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return get_config(ARCH, smoke=True), params, jcfg, jparams


def _engine(shared, **kw):
    cfg, params, _jcfg, _jparams = shared
    return ServeEngine(cfg, params, ServeConfig(max_seq=64, **kw),
                       device="cpu")


def test_greedy_generate_matches_reference(shared):
    cfg, _params, jcfg, jparams = shared
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    want = JaxServeEngine(jcfg, jparams, JaxServeConfig(max_seq=64)) \
        .generate({"tokens": jnp.asarray(toks)}, max_new_tokens=6)
    got = _engine(shared).generate({"tokens": toks}, max_new_tokens=6)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("placement,counter,absent", [
    ("pool", "restores", "replays"), ("recompute", "replays", "restores")])
def test_eviction_reproduces_roomy_bitwise(shared, placement, counter,
                                           absent):
    cfg = shared[0]
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    eng = _engine(shared, kv_placement=placement, **_TIGHT)
    out = eng.generate({"tokens": toks}, 6)
    assert eng.counters["evictions"] > 0
    assert eng.counters[counter] > 0
    assert eng.counters[absent] == 0
    ref = _engine(shared, decode_slots=2, kv_block_tokens=4)
    exp = ref.generate({"tokens": toks}, 6)
    assert ref.counters["evictions"] == 0
    np.testing.assert_array_equal(out, exp)


def test_pooled_prefix_sharing_across_engines(shared):
    """Engine A publishes its prompt's blocks; engine B (sharing the
    pool) restores them instead of prefilling, bit-identically."""
    cfg, params = shared[0], shared[1]
    scfg = ServeConfig(max_seq=64, decode_slots=2, kv_block_tokens=8,
                       prefix_sharing=True)
    a = ServeEngine(cfg, params, scfg, device="cpu")
    toks = RNG.integers(0, cfg.vocab_size, (1, 32))
    exp = a.generate({"tokens": toks}, 4)
    assert a.counters["prefix_publishes"] == 4   # 32 tok / 8-tok blocks
    assert a.counters["prefix_hits"] == 0
    b = ServeEngine(cfg, params, scfg, pool=a.pool, device="cpu")
    ledger.reset()
    got = b.generate({"tokens": toks}, 4)
    assert b.counters["prefix_hits"] == 1
    assert b.counters["prefix_hit_tokens"] == 24
    assert b.counters["prefills"] == 0
    np.testing.assert_array_equal(got, exp)
    cells = [c for c in ledger.snapshot()["auto_choices"]
             if c["primitive"] == "kv_prefix"]
    assert len(cells) == 1 and cells[0]["backend"] == "pool"


def test_sampled_streams_invariant_to_scheduling(shared):
    """The same sampled requests through generate(), through submit/step
    with another slot count, and under pool eviction give one stream."""
    cfg = shared[0]
    toks = RNG.integers(0, cfg.vocab_size, (3, 8))
    ref = _engine(shared, temperature=0.8).generate({"tokens": toks}, 5,
                                                    seed=3)
    assert ref.shape == (3, 5) and ref.max() < cfg.vocab_size
    for kw in (dict(decode_slots=1), dict(kv_placement="pool", **_TIGHT)):
        eng = _engine(shared, **kw)
        sp = SamplingParams(temperature=0.8, seed=3)
        for b in range(3):
            eng.submit(Request(id=f"m{b}", tokens=toks[b], sampling=sp,
                               max_new_tokens=5))
        while eng.step():
            pass
        rows = [eng.poll(f"m{b}")[1] for b in range(3)]
        np.testing.assert_array_equal(np.asarray(rows), ref)


def test_window_shorter_than_max_seq_refused(shared):
    """Both packages refuse a ring-buffer window shorter than max_seq:
    the reference fails at the first prefill, the port at construction."""
    cfg, params, jcfg, jparams = shared
    jeng = JaxServeEngine(jcfg, jparams, JaxServeConfig(max_seq=64,
                                                        window=32))
    with pytest.raises(ValueError, match="cache image"):
        jeng.generate({"tokens": jnp.ones((1, 8), jnp.int32)}, 2)
    with pytest.raises(NotImplementedError, match="window"):
        ServeEngine(cfg, params, ServeConfig(max_seq=64, window=32),
                    device="cpu")
    eng = ServeEngine(cfg, params, ServeConfig(max_seq=64, window=64),
                      device="cpu")
    full = _engine(shared)
    toks = RNG.integers(0, cfg.vocab_size, (2, 8))
    np.testing.assert_array_equal(eng.generate({"tokens": toks}, 5),
                                  full.generate({"tokens": toks}, 5))


def test_request_api_streaming(shared):
    cfg = shared[0]
    eng = _engine(shared)
    toks = RNG.integers(0, cfg.vocab_size, 8)
    rid = eng.submit(Request(id="s0", tokens=toks, max_new_tokens=5))
    assert eng.poll(rid) == ("waiting", [])
    with pytest.raises(ValueError):
        eng.submit(Request(id="s0", tokens=toks))   # duplicate id
    seen, busy = [], True
    while busy:
        busy = eng.step()
        status, fresh = eng.poll(rid)
        seen += fresh
    assert status == "finished" and len(seen) == 5
    with pytest.raises(KeyError):
        eng.poll(rid)


def _filled_caches(cfg_jax, cfg, slots, max_seq):
    """The same random cache contents in both frameworks."""
    jc = jax_model.init_cache(cfg_jax, JAX_UNSHARDED, slots, max_seq,
                              cache_dtype=jnp.float32)
    vals = [RNG.standard_normal(x.shape).astype(np.float32)
            for x in jax.tree.leaves(jc)]
    jc = jax.tree.unflatten(jax.tree.structure(jc),
                            [jnp.asarray(v) for v in vals])
    tc = model.init_cache(cfg, UNSHARDED, slots, max_seq, torch.float32,
                          device="cpu")
    for leaf, v in zip(kvcache.cache_leaves(tc), vals):
        leaf.copy_(torch.as_tensor(v))
    return jc, tc


def test_cache_images_byte_identical_to_reference(shared):
    """extract_slot / extract_token_range (sliced on the device, only the
    slot's bytes copied) give the reference's exact byte image, and
    insert_slot takes the reference's image back."""
    cfg, _params, jcfg, _jparams = shared
    jc, tc = _filled_caches(jcfg, cfg, 3, 24)
    jl = jax_kvcache.CacheLayout(jcfg, JAX_UNSHARDED, 3, 24, jnp.float32)
    tl = kvcache.CacheLayout(cfg, UNSHARDED, 3, 24, torch.float32)
    assert [(s.shape, s.batch_axis, s.seq_axis) for s in tl.leaves] == \
        [(s.shape, s.batch_axis, s.seq_axis) for s in jl.leaves]
    for slot, ntok in ((0, 24), (2, 7), (1, 0)):
        img = jl.extract_slot(jc, slot, ntok)
        assert tl.extract_slot(tc, slot, ntok) == img
        assert tl.bytes_for(ntok) == jl.bytes_for(ntok)
    assert tl.extract_token_range(tc, 1, 4, 12) == \
        jl.extract_token_range(jc, 1, 4, 12)
    img = jl.extract_slot(jc, 2, 9)
    tl.insert_slot(tc, 0, 9, img)
    want = jl.insert_slot(jc, 0, 9, img)
    for a, b in zip(kvcache.cache_leaves(tc), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_copy_slot_equals_byte_round_trip(shared):
    cfg = shared[0]
    _jc, src = _filled_caches(jax_get_config(ARCH, smoke=True), cfg, 1, 24)
    _jc, a = _filled_caches(jax_get_config(ARCH, smoke=True), cfg, 3, 24)
    b = [{k: t.clone() for k, t in c.items()} for c in a]
    big = kvcache.CacheLayout(cfg, UNSHARDED, 3, 24, torch.float32)
    one = kvcache.CacheLayout(cfg, UNSHARDED, 1, 24, torch.float32)
    big.copy_slot(a, 2, src, 0, 11)
    big.insert_slot(b, 2, 11, one.extract_slot(src, 0, 11))
    for x, y in zip(kvcache.cache_leaves(a), kvcache.cache_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("nbytes,flops", [(1 << 16, 1e9), (5 << 20, 1e15),
                                          (12345, 3e12), (1 << 30, 1e17)])
def test_price_kv_block_matches_reference(nbytes, flops):
    """Given the reference's roofline constants the port prices exactly
    like the reference (its own default is the H100)."""
    want = jax_kvcache.price_kv_block(nbytes, flops)
    got = kvcache.price_kv_block(nbytes, flops,
                                 peak_flops=TPU_V5E.peak_flops_bf16,
                                 hbm_bw=TPU_V5E.hbm_bw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_prefix_store_protocol_matches_reference():
    """The framework-free pooled store behaves op for op like the
    reference's: doorbell commit, LRU reclaim of unpinned entries."""
    stores = [PooledKVStore(4 << 16, block_bytes=1 << 16, max_entries=4),
              JaxPooledKVStore(4 << 16, block_bytes=1 << 16, max_entries=4)]
    for pool in stores:
        assert pool.put("a", bytes(1 << 16))
        assert pool.put("b", bytes(1 << 16))
        pool.acquire("a")
        for key in "cde":
            assert pool.put(key, bytes(1 << 16))
        assert "a" in pool and pool.get("a") == bytes(1 << 16)
        assert "b" not in pool
        with pytest.raises(ValueError):
            pool.remove("a")
        pool.release("a")
        pool.remove("a")
        assert "a" not in pool
    assert stores[0].stats == stores[1].stats
