"""The port's non-text frontends against the JAX package on the same
numpy inputs and params: whisper-tiny's encoder-decoder (the audio stub's
frames through ``enc_proj``, a bidirectional encoder of ``a`` rows and
``enc_norm``; cross attention in the decoder's ``a`` rows, with its
``ck`` / ``cv`` decode cache) and Phi-3-vision's vision prefix (the
projected patch embeddings ``front_proj`` prepended to the tokens):
configs, batches with their extras, ``param_specs``, the encoder, the
cross-attention row, prefill and decode, the loss and its gradients,
the flash path at the new shapes, and serving (greedy tokens, the cache
layout, eviction, the refusal of a request past ``max_seq``).

Tolerances: the modules and the SMOKE models at rtol 1e-4 / atol 1e-5
(f32 matmul stacks in other sum orders), gradients at rtol 1e-4 and
atol 2e-5 of the leaf's largest entry, the blocked attention against
``repro.models.flash`` at rtol 1e-4 / atol 2e-5 (its dense scores
against the reference's online softmax).  Greedy tokens, batches, specs
and evicted cache images are compared exactly.  The flash kernel itself
is held at these shapes in tests/test_torch_cuda.py, on a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jax_blocks
from repro.models import model as jax_model
from repro.models.pcontext import UNSHARDED as JAX_UNSHARDED
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import kvcache as jax_kvcache
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.models import blocks, model
from repro_torch.models.pcontext import UNSHARDED
from repro_torch.serving import Request, ServeConfig, ServeEngine, kvcache

AUDIO, VLM = "whisper-tiny", "phi-3-vision-4.2b"
ARCHS = (AUDIO, VLM)
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-5
RNG = np.random.default_rng(26)
PROMPT, NEW = 8, 5


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """(cfg, jcfg, jparams, npp, params) of one smoke model: the
    reference's params (key 0) and the same as the port's."""
    arch = request.param
    jcfg = jax_get_config(arch, smoke=True)
    jparams = jax_model.init_params(jax.random.key(0), jcfg, tp=1,
                                    dtype=jnp.float32)
    npp = jax.tree.map(np.asarray, jparams)
    cfg = get_config(arch, smoke=True)
    return cfg, jcfg, jparams, npp, model.params_from_numpy(npp, "cpu", cfg)


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


def _batch(jcfg, rows: int, length: int, seed: int) -> dict:
    """A training batch (numpy) of the reference's ``batch_for``, which
    the port's equals (:func:`test_batches_with_extras_equal_reference`)."""
    from repro.data.pipeline import batch_for
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                                (rows, length + 1))
    return batch_for(jcfg, toks, np.random.default_rng(seed + 1))


def _torch_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.long
                               if np.issubdtype(v.dtype, np.integer)
                               else None) for k, v in b.items()}


# -- configs, batches, specs ----------------------------------------------- #

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, smoke):
    """The copied configs equal the reference's field by field, and so do
    the parameter counts (whisper-tiny's 61,065,984 and Phi-3-vision's
    3,820,879,872 at full size)."""
    got, want = get_config(arch, smoke=smoke), jax_get_config(arch, smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    if not smoke:
        assert got.param_count() == {AUDIO: 61_065_984,
                                     VLM: 3_820_879_872}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_with_extras_equal_reference(arch):
    """``batch_for`` and ``SyntheticTokens`` give the reference's batches
    (tokens, labels and the stub embeddings, drawn from one rng after the
    tokens) for one seed, and ``local_batch`` splits the extras with the
    rows."""
    from repro.data.pipeline import SyntheticTokens as JaxTokens
    from repro.data.pipeline import batch_for as jax_batch_for
    from repro_torch.data.pipeline import (SyntheticTokens, batch_for,
                                           local_batch)
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, True)
    toks = RNG.integers(0, cfg.vocab_size, (4, 9))
    got = batch_for(cfg, toks, np.random.default_rng(5))
    want = jax_batch_for(jcfg, toks, np.random.default_rng(5))
    extra = {AUDIO: "source", VLM: "frontend"}[arch]
    assert sorted(got) == sorted(want) == sorted(["tokens", "labels",
                                                  extra])
    assert got[extra].dtype == np.float32
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(zip(range(2), SyntheticTokens(cfg, 4, 16, seed=3)),
                    JaxTokens(jcfg, 4, 16, seed=3)):
        for k in w:
            np.testing.assert_array_equal(g[1][k], w[k])
    half = local_batch(got, 1, 2)
    for k in got:
        np.testing.assert_array_equal(half[k], got[k][2:])


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, smoke, mesh):
    """Leaf by leaf on both packages' GLOBAL shapes at that tp, and the
    rule ``tests/test_sharding_specs.py::test_fsdp_skips_small_and_
    frontend`` holds for the port: the encoder and the frontend
    projections (used outside the FSDP gather hook) and every leaf under
    ``FSDP_MIN_SIZE`` stay dp-replicated."""
    from repro.models import sharding as jax_sharding
    from repro_torch.models import sharding
    dp, tp = mesh
    sizes = {"data": dp, "model": tp}
    jcfg, cfg = jax_get_config(arch, smoke), get_config(arch, smoke=smoke)
    jax_sharding.set_mesh_sizes(sizes)
    jabs = jax_model.abstract_params(jcfg, tp=tp)
    jspecs = jax_sharding.param_specs(jabs, jcfg, dp_axis="data")
    want = {"/".join(k.key for k in path): (tuple(leaf.shape), tuple(spec))
            for (path, leaf), spec in zip(
                jax.tree_util.tree_leaves_with_path(jabs),
                jax.tree.leaves(jspecs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec)))}
    sharding.set_mesh_sizes(sizes)
    abstract = model.abstract_params(cfg, tp=tp)
    specs = sharding.param_specs(abstract, cfg, dp_axis="data")
    got = {"/".join(p): (tuple(x.shape), tree.get(specs, p))
           for p, x in tree.leaves_with_paths(abstract)}
    assert got == want
    frontend = {"encoder", "enc_proj", "front_proj"}
    assert frontend & {p.split("/")[0] for p in got}
    for path, (shape, spec) in got.items():
        if frontend & set(path.split("/")) or \
                int(np.prod(shape)) < sharding.FSDP_MIN_SIZE:
            assert "data" not in spec, path


@pytest.mark.parametrize("arch", ARCHS)
def test_params_layout_and_round_trip(arch):
    """The port's params have the reference's tree, shapes and dtypes
    (``encoder`` stacked, ``norm_x`` / ``xattn`` in every decoder row of
    an encoder model), and the numpy interchange is lossless."""
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, True)
    jabs = jax_model.abstract_params(jcfg)
    want = [("/".join(k.key for k in p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(jabs)]
    mine = model.params_to_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    got = [("/".join(p), tuple(x.shape), str(x.dtype))
           for p, x in tree.leaves_with_paths(mine)]
    assert got == want
    back = model.params_to_numpy(model.params_from_numpy(mine, "cpu", cfg))
    for (_, a), (_, b) in zip(tree.leaves_with_paths(mine),
                              tree.leaves_with_paths(back)):
        assert a.tobytes() == b.tobytes()
    names = {p[0] for p, _ in tree.leaves_with_paths(mine)}
    rows = {p[1] for p, _ in tree.leaves_with_paths(mine) if p[0] == "g0"}
    if arch == AUDIO:
        assert {"encoder", "enc_norm", "enc_proj"} <= names
        assert {"norm_x", "xattn"} <= rows
    else:
        assert "front_proj" in names and "xattn" not in rows


# -- modules --------------------------------------------------------------- #

def _source(cfg, rows: int = 2) -> np.ndarray:
    return RNG.standard_normal((rows, cfg.encoder.source_len,
                                cfg.frontend_dim)).astype(np.float32)


def test_encode_matches_reference():
    """``_encode``: the projection, the bidirectional rows (RoPE on
    arange(S), never causal) and ``enc_norm``."""
    cfg, jcfg = get_config(AUDIO, smoke=True), jax_get_config(AUDIO, True)
    jparams = jax_model.init_params(jax.random.key(1), jcfg)
    params = model.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu", cfg)
    src = _source(cfg)
    want = jax_model._encode(jparams, jnp.asarray(src), jcfg, JAX_UNSHARDED)
    got = model._encode(params, torch.as_tensor(src), cfg, UNSHARDED)
    _close(got, want)


@pytest.mark.parametrize("with_encoder", [True, False],
                         ids=["cross", "no_encoder_out"])
def test_cross_attention_row_matches_reference(with_encoder):
    """One decoder ``a`` row with cross attention, forward and prefill
    (its cache's ``ck`` / ``cv``, unroped, in the cache dtype), against
    the reference's row; without an encoder output the row skips cross
    attention in both packages."""
    cfg, jcfg = get_config(AUDIO, smoke=True), jax_get_config(AUDIO, True)
    jrow = jax_blocks.init_row(jax.random.key(2), "a", jcfg, 1,
                               jnp.float32, cross=True)
    row = model.params_from_numpy(jax.tree.map(np.asarray, jrow), "cpu")
    h = RNG.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    enc = RNG.standard_normal((2, cfg.encoder.source_len, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(12)
    jenc = jnp.asarray(enc) if with_encoder else None
    tenc = torch.as_tensor(enc) if with_encoder else None
    want, _ = jax_blocks.row_forward(jrow, jnp.asarray(h), "a", jcfg,
                                     JAX_UNSHARDED, jnp.asarray(pos),
                                     encoder_out=jenc)
    got, _ = blocks.row_forward(row, torch.as_tensor(h), "a", cfg,
                                UNSHARDED, torch.as_tensor(pos), tenc)
    _close(got, want)
    wh, _, wc = jax_blocks.row_prefill(
        jrow, jnp.asarray(h), "a", jcfg, JAX_UNSHARDED, jnp.asarray(pos), 16,
        jnp.float32, encoder_out=jenc)
    cache = blocks.row_cache_init("a", cfg, UNSHARDED, 2, 16,
                                  torch.float32, "cpu", None,
                                  cfg.encoder.source_len)
    gh = blocks.row_prefill(row, torch.as_tensor(h), "a", cfg, UNSHARDED,
                            torch.as_tensor(pos), cache, tenc)
    _close(gh, wh)
    assert sorted(cache) == ["ck", "cv", "k", "v"]
    for key in wc:
        _close(cache[key], wc[key], msg=key)
    if not with_encoder:
        assert "ck" not in wc and not cache["ck"].any()


def _prefill_decode(cfg, jcfg, jparams, params, steps: int = 3):
    """Prefill of a 2-row batch (with its extras) and ``steps`` per-slot
    decode steps in both packages: (the reference's logits and caches,
    the port's)."""
    b = _batch(jcfg, 2, 10, seed=11)
    b.pop("labels")
    n_prefix = cfg.frontend_tokens if cfg.encoder is None else 0
    max_seq = n_prefix + 10 + steps + 2
    jl, jc = jax_model.prefill(jparams, {k: jnp.asarray(v) for k, v in
                                         b.items()}, jcfg, JAX_UNSHARDED,
                               max_seq, cache_dtype=jnp.float32)
    tl, tc = model.prefill(params, _torch_batch(b), cfg, UNSHARDED, max_seq,
                           cache_dtype=torch.float32)
    want, got = [jl[..., :cfg.vocab_size]], [tl[..., :cfg.vocab_size]]
    pos = n_prefix + 10
    for i in range(steps):
        tok = np.array([[3 + i], [40 + i]])
        p = np.array([pos + i, pos + i])
        jl, jc = jax_model.decode_step(jparams, jc, jnp.asarray(tok),
                                       jnp.asarray(p), jcfg, JAX_UNSHARDED)
        tl, tc = model.decode_step(params, tc, torch.as_tensor(tok),
                                   torch.as_tensor(p), cfg, UNSHARDED)
        want.append(jl)
        got.append(tl)
    return (want, jc), (got, tc)


def test_prefill_and_decode_match_reference(setup):
    """Logits of the prefill and of 3 decode steps, and every cache leaf
    after them (whisper's ``ck`` / ``cv`` included), with the vision
    prefix taking the cache's first positions."""
    cfg, jcfg, jparams, _npp, params = setup
    (want, jc), (got, tc) = _prefill_decode(cfg, jcfg, jparams, params)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, msg=f"step {i}")
    jleaves = jax.tree.leaves(jc)
    tleaves = kvcache.cache_leaves(tc)
    assert len(jleaves) == len(tleaves) == (4 if cfg.encoder else 2)
    for g, w in zip(tleaves, jleaves):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


_JAX_GRADS: dict = {}     # arch -> the reference's (loss, grads)


def _grads(cfg, jcfg, jparams, params, remat: bool):
    b = _batch(jcfg, 2, 12, seed=7)
    if cfg.name not in _JAX_GRADS:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        (jloss, _), jg = jax.value_and_grad(
            lambda p: jax_model.loss_fn(p, jb, jcfg, JAX_UNSHARDED,
                                        remat=False), has_aux=True)(jparams)
        _JAX_GRADS[cfg.name] = (jloss, jg)
    jloss, jg = _JAX_GRADS[cfg.name]
    leaves = tree.map_with_path(
        lambda _p, x: x.detach().clone().requires_grad_(True), params)
    loss, _ = model.loss_fn(leaves, _torch_batch(b), cfg, UNSHARDED,
                            remat=remat)
    loss.backward()
    return (float(jloss), jg), (float(loss.detach()), leaves)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "plain"])
def test_loss_and_grads_match_reference(setup, remat):
    """The loss (the vision prefix cut off before the logits) and the
    gradient of every leaf, the encoder's and ``enc_proj``'s included:
    under remat a decoder row closes over the encoder's output, and its
    replay must still carry the gradient back to the encoder."""
    cfg, jcfg, jparams, _npp, params = setup
    (jloss, jg), (loss, leaves) = _grads(cfg, jcfg, jparams, params, remat)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    want = {"/".join(k.key for k in p): np.asarray(g)
            for p, g in jax.tree_util.tree_leaves_with_path(jg)}
    got = {"/".join(p): x.grad.numpy()
           for p, x in tree.leaves_with_paths(leaves)}
    assert sorted(got) == sorted(want)
    frontend = [k for k in got if k.split("/")[0] in
                ("encoder", "enc_proj", "front_proj")]
    assert frontend
    for k in want:
        scale = float(np.max(np.abs(want[k])))
        assert k not in frontend or scale > 0, k
        _close(got[k], want[k], GRAD_RTOL, GRAD_ATOL * scale, msg=k)


# -- the flash path at the new shapes -------------------------------------- #

@pytest.mark.parametrize("lq,lk,d,causal", [(1024, 1500, 64, False),
                                            (1500, 1500, 64, False),
                                            (1100, 1100, 96, True)],
                         ids=["cross_1024x1500", "encoder_1500",
                              "causal_d96"])
def test_flash_plain_and_vjp_match_reference(lq, lk, d, causal):
    """The flash entry the model dispatches to (``models.flash``: on the
    CPU the kernel's plain version forward, the recompute VJP backward)
    against ``repro.models.flash.flash_attention`` and its ``jax.vjp``
    at whisper's non-causal shapes (lq != lk, ragged 64-tiles) and at
    Phi-3-vision's head_dim 96 (causal, two heads)."""
    from repro.models import flash as jax_flash
    from repro_torch.models import flash
    q = RNG.standard_normal((1, lq, 2, d)).astype(np.float32)
    k, v = (RNG.standard_normal((1, lk, 2, d)).astype(np.float32)
            for _ in range(2))
    do = RNG.standard_normal((1, lq, 2, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, causal), *(jnp.asarray(x) for x in (q, k, v)))
    wgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.as_tensor(x).requires_grad_(True)
                  for x in (q, k, v))
    got = flash.flash_attention(tq, tk, tv, causal)
    got.backward(torch.as_tensor(do))
    _close(got.detach(), want, RTOL, 2e-5)
    for g, w in zip((tq.grad, tk.grad, tv.grad), wgrads):
        _close(g, w, RTOL, 2e-5 * float(np.max(np.abs(np.asarray(w)))))


def test_cross_attention_dispatches_to_flash_at_1024():
    """``attention_scores`` reaches the flash path for cross attention
    once both lengths are >= 1024 (lq 1024, lk 1500, as the reference
    dispatches), and the plain einsum path below that; both agree."""
    from repro_torch.models import layers
    q = torch.as_tensor(RNG.standard_normal((1, 1024, 2, 64)),
                        dtype=torch.float32)
    k, v = (torch.as_tensor(RNG.standard_normal((1, 1500, 2, 64)),
                            dtype=torch.float32) for _ in range(2))
    calls = []
    import repro_torch.models.flash as flash_mod
    real = flash_mod.flash_attention
    try:
        flash_mod.flash_attention = lambda *a, **kw: (calls.append(a[1]
                                                                  .shape)
                                                      or real(*a, **kw))
        out = layers.attention_scores(q, k, v, causal=False)
        small = layers.attention_scores(q[:, :1000], k, v, causal=False)
    finally:
        flash_mod.flash_attention = real
    assert calls == [torch.Size([1, 1500, 2, 64])]
    _close(small, out[:, :1000], RTOL, 2e-5)


# -- serving --------------------------------------------------------------- #

def _prompts(cfg, rows: int) -> dict:
    """Prompts and the frontend's extras, as the serve launchers draw
    them (``launch.serve.stub_batch``)."""
    from repro_torch.launch.serve import stub_batch
    return stub_batch(cfg, rows, PROMPT, np.random.default_rng(rows))


def _max_seq(cfg) -> int:
    return model.prefix_tokens(cfg) + PROMPT + NEW + 8


def _engine(setup, **kw):
    cfg, params = setup[0], setup[4]
    return ServeEngine(cfg, params, ServeConfig(max_seq=_max_seq(cfg), **kw),
                       device="cpu")


def test_engine_greedy_matches_reference(setup):
    """Greedy tokens of the port's engine against the reference engine
    built with a ``max_seq`` that holds the vision prefix (the
    reference launcher's own sizing leaves it out:
    :func:`test_reference_launcher_max_seq_fault`)."""
    cfg, jcfg, jparams = setup[0], setup[1], setup[2]
    batch = _prompts(cfg, 3)
    want = JaxServeEngine(jcfg, jparams, JaxServeConfig(
        max_seq=_max_seq(cfg))).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, max_new_tokens=NEW)
    got = _engine(setup).generate(batch, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)


def test_cache_layout_and_prefix_sharing(setup):
    """Whisper's ``ck`` / ``cv`` leaves have no token axis, so its cache
    is not block-sharable (whole-image eviction, no prefix sharing), as
    in the reference; Phi-3-vision's is, but a conditioned request
    publishes and restores no prefix blocks."""
    cfg, jcfg = setup[0], setup[1]
    tl = kvcache.CacheLayout(cfg, UNSHARDED, 3, 40, torch.float32)
    jl = jax_kvcache.CacheLayout(jcfg, JAX_UNSHARDED, 3, 40, jnp.float32)
    assert [(s.shape, s.batch_axis, s.seq_axis) for s in tl.leaves] == \
        [(s.shape, s.batch_axis, s.seq_axis) for s in jl.leaves]
    assert tl.block_sharable == jl.block_sharable == (cfg.encoder is None)
    eng = _engine(setup, prefix_sharing=True)
    assert eng._share == (cfg.encoder is None)
    batch = _prompts(cfg, 2)
    batch["tokens"][1] = batch["tokens"][0]
    eng.generate(batch, NEW)
    assert eng.counters["prefix_publishes"] == 0
    assert eng.counters["prefix_hits"] == 0


@pytest.mark.parametrize("placement,counter", [("pool", "restores"),
                                               ("recompute", "replays")])
def test_eviction_reproduces_roomy(setup, placement, counter):
    """Two slots, two blocks short of holding both requests whole:
    evicted slots come back as whole images from the pool (restored
    bitwise; whisper's cross-attention keys and values with them) or by
    re-prefilling with their extras; greedy tokens equal the roomy
    run's."""
    cfg = setup[0]
    batch = _prompts(cfg, 3)
    bt = 4
    whole = -(-(model.prefix_tokens(cfg) + PROMPT + NEW - 1) // bt)
    roomy = _engine(setup).generate(batch, NEW)
    eng = _engine(setup, kv_placement=placement, decode_slots=2,
                  kv_block_tokens=bt, hbm_budget_blocks=2 * whole - 2)
    got = eng.generate(batch, NEW)
    assert eng.counters["evictions"] > 0 and eng.counters[counter] > 0
    np.testing.assert_array_equal(got, roomy)


def test_whisper_slot_image_round_trip_is_bitwise():
    """A whisper slot image (self-attention KV up to the slot's tokens,
    ``ck`` / ``cv`` whole) is byte-identical to the reference's, and
    inserting it back restores every leaf bitwise."""
    cfg, jcfg = get_config(AUDIO, smoke=True), jax_get_config(AUDIO, True)
    jc = jax_model.init_cache(jcfg, JAX_UNSHARDED, 3, 24,
                              cache_dtype=jnp.float32)
    vals = [RNG.standard_normal(x.shape).astype(np.float32)
            for x in jax.tree.leaves(jc)]
    jc = jax.tree.unflatten(jax.tree.structure(jc),
                            [jnp.asarray(v) for v in vals])
    tc = model.init_cache(cfg, UNSHARDED, 3, 24, torch.float32, device="cpu")
    for leaf, v in zip(kvcache.cache_leaves(tc), vals):
        leaf.copy_(torch.as_tensor(v))
    jl = jax_kvcache.CacheLayout(jcfg, JAX_UNSHARDED, 3, 24, jnp.float32)
    tl = kvcache.CacheLayout(cfg, UNSHARDED, 3, 24, torch.float32)
    img = tl.extract_slot(tc, 1, 9)
    assert img == jl.extract_slot(jc, 1, 9)
    assert len(img) == tl.bytes_for(9) == jl.bytes_for(9)
    before = [x.clone() for x in kvcache.cache_leaves(tc)]
    tl.insert_slot(tc, 2, 9, img)
    assert tl.extract_slot(tc, 2, 9) == img
    for a, b, sp in zip(kvcache.cache_leaves(tc), before, tl.leaves):
        for slot in (0, 1):
            assert torch.equal(a.select(sp.batch_axis, slot),
                               b.select(sp.batch_axis, slot))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_what_does_not_fit(arch):
    """A request whose prefix, prompt and new tokens outgrow ``max_seq``
    is refused at submit (the reference's engine decodes past the end
    instead), and so is one without its frontend's extras; one that
    fits exactly is served."""
    cfg = get_config(arch, smoke=True)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _prompts(cfg, 1)
    extras = {k: v[0] for k, v in batch.items() if k != "tokens"}
    fit = model.prefix_tokens(cfg) + PROMPT + NEW - 1
    eng = ServeEngine(cfg, params, ServeConfig(max_seq=fit), device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(id="long", tokens=batch["tokens"][0],
                           max_new_tokens=NEW + 1, extras=extras))
    with pytest.raises(ValueError, match="extras"):
        eng.submit(Request(id="bare", tokens=batch["tokens"][0],
                           max_new_tokens=NEW))
    assert eng.generate(batch, NEW).shape == (1, NEW)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_sizes_the_cache_with_the_prefix(arch, capsys):
    """``launch.serve`` sizes ``max_seq`` as prefix + prompt + new + 8
    (Phi-3-vision's 576 patches at full size: 1624 for 1024 + 16), draws
    the stub batch after the prompts from seed 0 as the reference
    launcher does, serves it, and refuses ``--trace`` for these models
    (the reference's trace builds requests without extras)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", str(PROMPT), "--new-tokens", "3"]
    _, eng = serve.engine_from_args(serve.build_parser().parse_args(argv))
    full = get_config(arch)
    assert eng.scfg.max_seq == model.prefix_tokens(eng.cfg) + PROMPT + 3 + 8
    assert model.prefix_tokens(full) + 1024 + 16 + 8 == \
        {AUDIO: 1048, VLM: 1624}[arch]
    b = serve.stub_batch(eng.cfg, 2, PROMPT, np.random.default_rng(0))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        b["tokens"], rng.integers(0, eng.cfg.vocab_size, (2, PROMPT)))
    extra = "source" if arch == AUDIO else "frontend"
    np.testing.assert_array_equal(b[extra], rng.standard_normal(
        b[extra].shape).astype(np.float32))
    serve.main(argv)
    assert f"{eng.cfg.name}: (2, 3)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--trace"):
        serve.main(argv + ["--trace", "poisson", "--requests", "2"])


def test_reference_launcher_max_seq_fault():
    """A fault of the reference, pinned on the reference alone: its serve
    launcher sizes the cache as prompt + new + 8
    (``src/repro/launch/serve.py:257``), without the vision prefix, and
    its engine does not refuse: the prefill's cache is not padded past
    ``max_seq`` and the decode writes past the end.  Phi3-vision-smoke
    (16 patches), 2 prompts of 16 tokens, 4 new tokens: at the
    launcher's ``max_seq`` 28 only the first token (the prefill's)
    agrees with a cache sized with the prefix (44)."""
    jcfg = jax_get_config(VLM, smoke=True)
    jparams = jax_model.init_params(jax.random.key(0), jcfg, tp=1,
                                    dtype=jnp.float32)
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size,
                                                (2, 16)))}
    batch["frontend"] = jnp.asarray(rng.standard_normal(
        (2, jcfg.frontend_tokens, jcfg.frontend_dim)), jnp.float32)
    short, roomy = (JaxServeEngine(jcfg, jparams, JaxServeConfig(
        max_seq=m)).generate(batch, 4).tolist() for m in (16 + 4 + 8,
                                                          16 + 16 + 4 + 8))
    assert short == [[304, 312, 169, 334], [12, 122, 197, 124]]
    assert roomy == [[304, 10, 186, 433], [12, 122, 460, 305]]
