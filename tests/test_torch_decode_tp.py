"""The port's sequence-sharded decode (tp > 1) against the JAX reference.

The reference's flash-decoding path (``src/repro/models/layers.py:
231-336``, ``blocks.py:154-176, 233-260``): at tp > 1 every rank holds
max_seq / tp positions of every kv head, the new token's k and v are
computed on every rank and written by the rank that owns the slot, and
the softmax takes the global max and three AllReduces.  The port runs
on gloo CPU ranks (one spawn of 2 ranks and one of 4 for the module)
under ``ring`` and ``cxl``; the reference runs ``prefill`` /
``decode_step`` inside ``shard_map`` over forced host devices in a
subprocess, from the same numpy params (made by the reference at that
tp) and the same numpy caches and tokens (made from a seed).

Smoke configs of every row kind: llama3.2 (``a``; kv sharded at tp 2,
replicated at tp 4), granite-moe (``e``; at tp 2 the decode's 2 tokens
split over the ranks, at tp 4 they do not: both branches of
``models/moe.py``), falcon-mamba (``1``), zamba2 (``2`` and the shared
``a``), whisper-tiny (cross attention's ``ck``/``cv``) and Phi-3-vision
(the vision prefix, in the prefill).  Decode runs from a random global
cache (the reference's ``init_cache`` layout) at a scalar position, and
for llama3.2 also at per-slot (vector) positions and with an explicit
window whose ring buffer wraps.  Held at rtol 1e-4, atol 1e-5:

* every step's logits and the final caches (the port's local caches
  against their slices of the reference's global ones) against the
  reference's sharded decode, and the logits against the port's own tp
  = 1 decode; Zamba2's against the reference's UNSHARDED decode (the
  reference's sharded Mamba-2 gated norm spans d_inner / tp, ROADMAP
  queue 3; the port's spans d_inner at every tp);
* a decode step's ledger (wire bytes and calls by primitive) against
  the reference's trace-time ledger, Zamba2's plus the port's gated-norm
  AllReduce a Mamba-2 row;
* the prefill at L = max_seq against the reference's sharded prefill
  (Zamba2's unsharded), logits (this rank's vocabulary slice) and
  caches; a shorter prefill against the port's tp = 1 prefill (it pads
  to max_seq, then takes its segment) and, for the models without an
  MoE, the reference's unsharded one.

``test_reference_prefill_at_tp_shorter_than_cache`` pins the reference's
sharded prefill fault (ROADMAP queue 3).

Also runnable as a script: ``python tests/test_torch_decode_tp.py
--reference OUT.npz TMPDIR GROUP`` writes the reference's results.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RTOL, ATOL = 1e-4, 1e-5
B = 2                  # the batch (2 slots)
S = 32                 # max_seq: the global cache length
P0 = 20                # the first decoded position
STEPS = 3
WINDOW, W0 = 8, 6      # the explicit window and its first position: wraps
SHORT = 12             # the shorter prefill's text length
BACKENDS = ("ring", "cxl")

CASES = {
    "llama_tp2": dict(arch="llama3.2-1b", tp=2,
                      modes=("scalar", "vector", "window")),
    "llama_tp4": dict(arch="llama3.2-1b", tp=4,
                      modes=("scalar", "vector", "window")),
    "granite_tp2": dict(arch="granite-moe-3b-a800m", tp=2,
                        modes=("scalar",)),
    "granite_tp4": dict(arch="granite-moe-3b-a800m", tp=4,
                        modes=("scalar",)),
    "falcon_tp2": dict(arch="falcon-mamba-7b", tp=2, modes=("scalar",)),
    "falcon_tp4": dict(arch="falcon-mamba-7b", tp=4, modes=("scalar",)),
    "zamba2_tp2": dict(arch="zamba2-1.2b", tp=2, modes=("scalar",)),
    "zamba2_tp4": dict(arch="zamba2-1.2b", tp=4, modes=("scalar",)),
    "whisper_tp2": dict(arch="whisper-tiny", tp=2, modes=("scalar",)),
    "phi3v_tp2": dict(arch="phi-3-vision-4.2b", tp=2, modes=("scalar",)),
}
# the reference's sharded Mamba-2 row is another function (queue 3): hold
# these to its unsharded decode and prefill
UNSHARDED_REF = {"zamba2_tp2", "zamba2_tp4"}
MOE = {"granite_tp2", "granite_tp4"}
TPS = (2, 4)
DECODES = [(c, m, b) for c, r in CASES.items() for m in r["modes"]
           for b in BACKENDS]
PREFILLS = [(c, b) for c in CASES for b in BACKENDS]
# the reference's runs in two processes side by side
REF_GROUPS = (("llama_tp2", "llama_tp4", "granite_tp2", "granite_tp4",
               "whisper_tp2"),
              ("falcon_tp2", "falcon_tp4", "zamba2_tp2", "zamba2_tp4",
               "phi3v_tp2"))


# ---------------------------------------------------------------------- #
# inputs (numpy, from a seed) and the cache layout
# ---------------------------------------------------------------------- #

def _flat(tree, prefix=()) -> dict:
    """A nested list/dict tree -> {"0/k": leaf, "2/0/ssm": leaf, ...}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def _unflat(tree, flat: dict, prefix=()):
    """``tree``'s structure with the leaves of ``flat``."""
    if isinstance(tree, dict):
        return {k: _unflat(v, flat, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflat(v, flat, prefix + (str(i),))
                for i, v in enumerate(tree)]
    return flat["/".join(prefix)]


def _cfg(case: str):
    from repro_torch.configs import get_config
    return get_config(CASES[case]["arch"], smoke=True)


def _seq(mode: str) -> int:
    return WINDOW if mode == "window" else S


def _positions(mode: str) -> list:
    """Each step's position: a scalar, or (B,) per slot."""
    if mode == "vector":
        return [[P0 + i, P0 - 5 + i] for i in range(STEPS)]
    start = W0 if mode == "window" else P0
    return [start + i for i in range(STEPS)]


def _inputs(case: str) -> dict:
    """The case's numpy inputs: the global decode caches of each mode,
    the decode tokens and the prefills' batches."""
    import torch

    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED
    cfg = _cfg(case)
    rng = np.random.default_rng(sum(map(ord, case)))
    out = {}
    for mode in CASES[case]["modes"]:
        tree = model.init_cache(cfg, UNSHARDED, B, _seq(mode),
                                torch.float32, device="meta")
        for path, leaf in _flat(tree).items():
            scale = 0.1 if path.endswith("ssm") else 0.5
            out[f"cache|{mode}|{path}"] = (scale * rng.standard_normal(
                tuple(leaf.shape))).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab_size,
                                 (STEPS, B, 1)).astype(np.int32)
    prefix = cfg.frontend_tokens if cfg.frontend != "text" \
        and cfg.encoder is None else 0
    for name, text in (("full", S - prefix), ("short", SHORT)):
        out[f"batch|{name}|tokens"] = rng.integers(
            0, cfg.vocab_size, (B, text)).astype(np.int32)
        if prefix:
            out[f"batch|{name}|frontend"] = rng.standard_normal(
                (B, prefix, cfg.frontend_dim)).astype(np.float32)
        if cfg.encoder is not None:
            out[f"batch|{name}|source"] = rng.standard_normal(
                (B, cfg.encoder.source_len,
                 cfg.frontend_dim or cfg.d_model)).astype(np.float32)
    return out


def _batch(inputs: dict, name: str) -> dict:
    pre = f"batch|{name}|"
    return {k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}


def _cache(inputs: dict, mode: str) -> dict:
    pre = f"cache|{mode}|"
    return {k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}


def _shard_dim(path: str, cfg, tp: int):
    """The dim of a cache leaf that the model axis shards (None:
    replicated), as the reference's ``cache_specs``: the KV cache's
    sequence, cross attention's heads when kv is sharded, the Mamba x
    conv's channels and its state's channels (Mamba-1) or heads
    (Mamba-2); the B/C conv is replicated."""
    name = path.split("/")[-1]
    if name in ("k", "v"):
        return -3
    if name in ("ck", "cv"):
        return -2 if cfg.kv_sharded(tp) else None
    if name == "conv":
        return -1
    if name == "ssm":
        return -2 if cfg.ssm.version == 1 else -3
    return None


def _local(flat: dict, cfg, tp: int, rank: int) -> dict:
    out = {}
    for path, x in flat.items():
        dim = _shard_dim(path, cfg, tp)
        out[path] = x if dim is None else np.split(x, tp, axis=dim)[rank]
    return out


# ---------------------------------------------------------------------- #
# the reference side (a subprocess with 8 forced host devices)
# ---------------------------------------------------------------------- #

def reference_main(out_path: str, tmp: str, group: str) -> None:
    os.environ.setdefault("REPRO_DRYRUN_DEVICES", "8")
    from repro.launch import dryrun as rd      # before jax: the flags
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core import ledger
    from repro.core.api import Communicator
    from repro.models import model, sharding
    from repro.models.pcontext import UNSHARDED, ParallelContext

    out = {}
    for case in REF_GROUPS[int(group)]:
        r = CASES[case]
        tp = r["tp"]
        cfg = get_config(r["arch"], smoke=True)
        with np.load(os.path.join(tmp, f"{case}.npz")) as f:
            a = {k: f[k] for k in f.files}
        params = {}
        for k, v in a.items():
            if k.startswith("param|"):
                node = params
                parts = k[len("param|"):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        mesh = jax.make_mesh((tp,), ("model",), devices=jax.devices()[:tp])
        sharding.set_mesh_sizes({"model": tp})
        pc = ParallelContext(tp_axis="model", tp=tp,
                             comm=Communicator(backend="ring"))
        unsharded = case in UNSHARDED_REF
        pspecs = sharding.param_specs(params, cfg, fsdp=False)

        def tree_of(mode):
            return model.init_cache(cfg, UNSHARDED, B, _seq(mode),
                                    cache_dtype=jnp.float32)

        def jflat(tree):
            return _flat(jax.tree.map(np.asarray, tree))

        for mode in r["modes"]:
            window = WINDOW if mode == "window" else None
            cache = _unflat(tree_of(mode), {
                k: jnp.asarray(v) for k, v in _cache(a, mode).items()})
            cspecs = rd.cache_specs(cfg, cache, None, batch_sharded=False,
                                    tp=tp)

            def dec(p, c, t, pos, window=window):
                return model.decode_step(p, c, t, pos, cfg,
                                         UNSHARDED if unsharded else pc,
                                         window=window)
            f = jax.jit(dec) if unsharded else jax.jit(jax.shard_map(
                dec, mesh=mesh, in_specs=(pspecs, cspecs, P(), P()),
                out_specs=(P(), cspecs), check_vma=False))
            for i, pos in enumerate(_positions(mode)):
                pos = jnp.asarray(pos, jnp.int32)
                tok = jnp.asarray(a["tokens"][i])
                if i == 0 and mode == "scalar":
                    ledger.reset()
                    f.lower(params, cache, tok, pos)
                    snap = ledger.snapshot()
                    out[f"{case}|ledger"] = np.asarray(json.dumps(
                        {k: snap[k] for k in ("wire_bytes",
                                              "collective_calls")}))
                logits, cache = f(params, cache, tok, pos)
                out[f"{case}|{mode}|logits|{i}"] = np.asarray(logits)
            for k, v in jflat(cache).items():
                out[f"{case}|{mode}|cache|{k}"] = v

        # the prefill at L = max_seq, sharded (Zamba2: unsharded)
        ctree = tree_of("scalar")
        cspecs = rd.cache_specs(cfg, ctree, None, batch_sharded=False,
                                tp=tp)
        for name in ("full", "short"):
            batch = {k: jnp.asarray(v) for k, v in _batch(a, name).items()}
            if name == "full" and not unsharded:
                def pre(p, b):
                    return model.prefill(p, b, cfg, pc, max_seq=S,
                                         cache_dtype=jnp.float32)
                f = jax.jit(jax.shard_map(
                    pre, mesh=mesh, in_specs=(pspecs, {k: P() for k in
                                                       batch}),
                    out_specs=(P(None, None, "model"), cspecs),
                    check_vma=False))
            elif name == "full" or case not in MOE:
                def pre(p, b):
                    return model.prefill(p, b, cfg, UNSHARDED, max_seq=S,
                                         cache_dtype=jnp.float32)
                f = jax.jit(pre)
            else:
                continue
            logits, cache = f(params, batch)
            out[f"{case}|prefill_{name}|logits"] = np.asarray(logits)
            for k, v in jflat(cache).items():
                out[f"{case}|prefill_{name}|cache|{k}"] = v

        if case == "llama_tp2":
            # the reference's sharded prefill below max_seq (queue 3)
            s_local = S // tp

            def pre(p, b):
                return model.prefill(p, b, cfg, pc, max_seq=S,
                                     cache_dtype=jnp.float32)
            f = jax.jit(jax.shard_map(
                pre, mesh=mesh, in_specs=(pspecs, {"tokens": P()}),
                out_specs=(P(None, None, "model"), cspecs),
                check_vma=False))
            short = {"tokens": jnp.asarray(
                a["batch|full|tokens"][:, :s_local - 4])}
            try:
                f(params, short)
                out["fault|below_s_local"] = np.asarray("no error")
            except TypeError as e:
                out["fault|below_s_local"] = np.asarray(
                    f"TypeError: {e}"[:300])
            mid = s_local + 4
            toks = {"tokens": jnp.asarray(a["batch|full|tokens"][:, :mid])}
            _, sharded = f(params, toks)
            _, plain = jax.jit(lambda p, b: model.prefill(
                p, b, cfg, UNSHARDED, max_seq=S,
                cache_dtype=jnp.float32))(params, toks)
            out["fault|mid|sharded_k"] = np.asarray(sharded[0]["k"])
            out["fault|mid|plain_k"] = np.asarray(plain[0]["k"])
    np.savez(out_path, **out)


# ---------------------------------------------------------------------- #
# the port side: one spawn of 2 ranks and one of 4
# ---------------------------------------------------------------------- #

def _port_rank(ctx, tmp: str, tp: int) -> dict:
    import torch

    from repro_torch.core import ledger
    from repro_torch.core.api import Communicator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model, sharding
    from repro_torch.models.pcontext import ParallelContext

    mesh = make_host_mesh((("model", tp),), ctx)
    sharding.set_mesh_sizes({"model": tp})
    out = {}
    for case, r in CASES.items():
        if r["tp"] != tp:
            continue
        cfg = _cfg(case)
        with np.load(os.path.join(tmp, f"{case}.npz")) as f:
            a = {k: f[k] for k in f.files}
        full = model.params_from_numpy(
            _unflat_params(a), "cpu", cfg, tp=tp)
        specs = sharding.param_specs(model.abstract_params(cfg, tp), cfg,
                                     fsdp=False)
        params = sharding.shard_params(full, specs, None, 0, 1,
                                       tp_axis="model", tp_rank=ctx.rank,
                                       tp=tp)
        for backend in BACKENDS:
            pc = ParallelContext(
                tp_axis="model", tp=tp,
                comm=Communicator(backend=backend, axes=mesh))
            key = f"{case}|{backend}"
            for mode in r["modes"]:
                window = WINDOW if mode == "window" else None
                tree = model.init_cache(cfg, pc, B, _seq(mode),
                                        torch.float32, device="meta")
                local = _local(_cache(a, mode), cfg, tp, ctx.rank)
                cache = _unflat(tree, {k: torch.from_numpy(v.copy())
                                       for k, v in local.items()})
                for i, pos in enumerate(_positions(mode)):
                    if i == 0 and mode == "scalar":
                        ledger.reset()
                    logits, cache = model.decode_step(
                        params, cache, torch.from_numpy(a["tokens"][i]),
                        torch.tensor(pos), cfg, pc, window=window)
                    if i == 0 and mode == "scalar":
                        snap = ledger.snapshot()
                        out[f"{key}|ledger"] = json.dumps(
                            {k: snap[k] for k in ("wire_bytes",
                                                  "collective_calls")})
                    out[f"{key}|{mode}|logits|{i}"] = logits.numpy()
                for k, v in _flat(cache).items():
                    out[f"{key}|{mode}|cache|{k}"] = v.numpy()
            for name in ("full", "short"):
                batch = {k: torch.from_numpy(v)
                         for k, v in _batch(a, name).items()}
                logits, cache = model.prefill(params, batch, cfg, pc, S,
                                              cache_dtype=torch.float32)
                out[f"{key}|prefill_{name}|logits"] = logits.numpy()
                for k, v in _flat(cache).items():
                    out[f"{key}|prefill_{name}|cache|{k}"] = v.numpy()
    return out


def _unflat_params(a: dict) -> dict:
    params: dict = {}
    for k, v in a.items():
        if k.startswith("param|"):
            node = params
            parts = k[len("param|"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return params


def _port_tp1(case: str, a: dict) -> dict:
    """The port's tp = 1 decode from the global caches and its prefills,
    on the same params (the tp's padding is inert)."""
    import torch

    from repro_torch.models import model
    from repro_torch.models.pcontext import UNSHARDED
    cfg = _cfg(case)
    params = model.params_from_numpy(_unflat_params(a), "cpu")
    out = {}
    for mode in CASES[case]["modes"]:
        window = WINDOW if mode == "window" else None
        tree = model.init_cache(cfg, UNSHARDED, B, _seq(mode),
                                torch.float32, device="meta")
        cache = _unflat(tree, {k: torch.from_numpy(v.copy())
                               for k, v in _cache(a, mode).items()})
        for i, pos in enumerate(_positions(mode)):
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(a["tokens"][i]),
                torch.tensor(pos), cfg, UNSHARDED, window=window)
            out[f"{mode}|logits|{i}"] = logits.numpy()
    for name in ("full", "short"):
        batch = {k: torch.from_numpy(v) for k, v in _batch(a, name).items()}
        logits, cache = model.prefill(params, batch, cfg, UNSHARDED, S,
                                      cache_dtype=torch.float32)
        out[f"prefill_{name}|logits"] = logits.numpy()
        for k, v in _flat(cache).items():
            out[f"prefill_{name}|cache|{k}"] = v.numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import model as jax_model
    from repro_torch.launch import ranks

    tmp = str(tmp_path_factory.mktemp("torch_decode_tp"))
    inputs = {}
    for case, r in CASES.items():
        a = _inputs(case)
        jparams = jax_model.init_params(
            jax.random.key(3), jax_get_config(r["arch"], smoke=True),
            tp=r["tp"], dtype=jnp.float32)
        for path, x in jax.tree_util.tree_leaves_with_path(jparams):
            a["param|" + "/".join(p.key for p in path)] = np.asarray(x)
        np.savez(os.path.join(tmp, f"{case}.npz"), **a)
        inputs[case] = a
    ref_path = os.path.join(tmp, "reference")
    env = dict(os.environ)
    env["REPRO_DRYRUN_DEVICES"] = "8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    refs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference",
         f"{ref_path}.{g}.npz", tmp, str(g)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for g in range(len(REF_GROUPS))]
    try:
        mine = {}
        for tp in TPS:
            per_rank = ranks.spawn(_port_rank, tp, (tmp, tp), device="cpu",
                                   partition_bytes=1 << 20, timeout_s=120)
            mine[tp] = per_rank
        tp1 = {case: _port_tp1(case, inputs[case]) for case in CASES}
        logs = [ref.communicate(timeout=600)[0] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    reference = {}
    for g, (ref, log) in enumerate(zip(refs, logs)):
        assert ref.returncode == 0, log[-3000:]
        with np.load(f"{ref_path}.{g}.npz") as f:
            reference.update({k: f[k] for k in f.files})
    return mine, tp1, reference


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _ref_caches(reference: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case,mode,backend", DECODES)
def test_decode_logits_match_reference(runs, case, mode, backend):
    """Every rank's logits of every step equal the reference's sharded
    decode (Zamba2: unsharded) and the port's tp = 1 decode."""
    mine, tp1, reference = runs
    for rank, got in enumerate(mine[CASES[case]["tp"]]):
        for i in range(STEPS):
            g = got[f"{case}|{backend}|{mode}|logits|{i}"]
            _close(g, reference[f"{case}|{mode}|logits|{i}"],
                   f"rank {rank} step {i}")
            _close(g, tp1[case][f"{mode}|logits|{i}"],
                   f"rank {rank} step {i} vs tp 1")


@pytest.mark.parametrize("case,mode,backend", DECODES)
def test_decode_caches_match_reference(runs, case, mode, backend):
    """Every rank's caches after the steps equal its slices of the
    reference's global caches: the owning rank wrote each new slot."""
    mine, _, reference = runs
    tp, cfg = CASES[case]["tp"], _cfg(case)
    want = _ref_caches(reference, f"{case}|{mode}|cache|")
    assert want
    for rank, got in enumerate(mine[tp]):
        local = _local(want, cfg, tp, rank)
        mine_c = _ref_caches(got, f"{case}|{backend}|{mode}|cache|")
        assert sorted(mine_c) == sorted(local)
        for k in local:
            _close(mine_c[k], local[k], f"rank {rank} {k}")


def _gated_norm_bytes(case: str) -> float:
    """The port's gated-norm AllReduce of a decode step: one (B, 1) f32
    sum of squares a Mamba-2 row, 2 s (n - 1) / n wire bytes each."""
    cfg, tp = _cfg(case), CASES[case]["tp"]
    rows = cfg.layer_pattern.count("2")
    return rows * B * 4 * 2 * (tp - 1) / tp, rows


@pytest.mark.parametrize("case", list(CASES))
def test_decode_ledger_matches_reference(runs, case):
    """A decode step's wire bytes and calls by primitive on every rank
    and backend equal the reference's trace-time ledger (its scanned
    rows booked by trip count); Zamba2 adds the port's gated-norm
    AllReduce of each Mamba-2 row.  The global max books nothing in
    either package.  Granite at tp 2 gathers its split tokens back each
    row (the MoE's token-sharded branch), at tp 4 it does not."""
    mine, _, reference = runs
    want = json.loads(str(reference[f"{case}|ledger"]))
    if case in UNSHARDED_REF:
        extra, rows = _gated_norm_bytes(case)
        # the reference's unsharded decode books nothing: the port's
        # ledger is its own sharded decode's, checked by count
        assert want["wire_bytes"] == {}
    for got in mine[CASES[case]["tp"]]:
        for backend in BACKENDS:
            g = json.loads(got[f"{case}|{backend}|ledger"])
            if case in UNSHARDED_REF:
                cfg = _cfg(case)
                n_attn = cfg.layer_pattern.count("a")
                # embed 1, a Mamba-2 row's out_proj and gated norm, an
                # attention row's 3 + its FFN's
                assert g["collective_calls"]["all_reduce"] == \
                    1 + 2 * rows + 4 * n_attn
                continue
            assert g == want, (backend, g, want)
    if case.startswith("granite"):
        cfg = _cfg(case)
        n = len(cfg.layer_pattern)
        tp = CASES[case]["tp"]
        gathers = n * (3 if cfg.kv_sharded(tp) else 1) + 1
        if tp == 2:
            gathers += n          # the token-sharded branch's AllGather
        assert want["collective_calls"]["all_gather"] == gathers


@pytest.mark.parametrize("case,backend", PREFILLS)
def test_prefill_matches_reference(runs, case, backend):
    """The prefill at L = max_seq: every rank's vocabulary slice of the
    last position's logits and its caches equal the reference's sharded
    prefill (Zamba2: unsharded, the global logits sliced)."""
    mine, _, reference = runs
    tp, cfg = CASES[case]["tp"], _cfg(case)
    logits = reference[f"{case}|prefill_full|logits"]
    want = _ref_caches(reference, f"{case}|prefill_full|cache|")
    v_loc = logits.shape[-1] // tp
    for rank, got in enumerate(mine[tp]):
        g = got[f"{case}|{backend}|prefill_full|logits"]
        _close(g, logits[..., rank * v_loc:(rank + 1) * v_loc],
               f"rank {rank} logits")
        local = _local(want, cfg, tp, rank)
        mine_c = _ref_caches(got, f"{case}|{backend}|prefill_full|cache|")
        assert sorted(mine_c) == sorted(local)
        for k in local:
            _close(mine_c[k], local[k], f"rank {rank} {k}")


@pytest.mark.parametrize("case,backend",
                         [(c, b) for c, b in PREFILLS if c not in MOE])
def test_short_prefill_pads_to_max_seq(runs, case, backend):
    """A prefill shorter than the cache (and than a rank's segment at tp
    2): every rank's caches are its segment of the tp = 1 prefill's,
    zero past L, and the logits its slice; both equal the reference's
    unsharded prefill.  (The MoE's token split changes the prefill's
    capacity drops with tp, so Granite is held at L = max_seq only.)"""
    mine, tp1, reference = runs
    tp, cfg = CASES[case]["tp"], _cfg(case)
    want = {k[len("prefill_short|cache|"):]: v for k, v in tp1[case].items()
            if k.startswith("prefill_short|cache|")}
    ref = _ref_caches(reference, f"{case}|prefill_short|cache|")
    for k in want:
        _close(want[k], ref[k], f"tp 1 vs the reference {k}")
    logits = tp1[case]["prefill_short|logits"]
    _close(logits, reference[f"{case}|prefill_short|logits"],
           "tp 1 logits vs the reference")
    v_loc = logits.shape[-1] // tp
    for rank, got in enumerate(mine[tp]):
        _close(got[f"{case}|{backend}|prefill_short|logits"],
               logits[..., rank * v_loc:(rank + 1) * v_loc],
               f"rank {rank} logits")
        local = _local(want, cfg, tp, rank)
        mine_c = _ref_caches(got, f"{case}|{backend}|prefill_short|cache|")
        for k in local:
            _close(mine_c[k], local[k], f"rank {rank} {k}")


def test_reference_prefill_at_tp_shorter_than_cache(runs):
    """The reference's sharded prefill slices each rank's segment out of
    k of length L without padding (``src/repro/models/blocks.py:
    164-169``; its comment says shorter prefills zero-pad): below a
    rank's segment (L < max_seq / tp) it raises a TypeError, and between
    the segment and max_seq JAX clamps the slice's start, so rank 1
    holds positions L - S_local ... L - 1 in the slots of S_local ...
    max_seq - 1.  The port pads first (``test_short_prefill_pads_to_
    max_seq``).  ROADMAP queue 3, a reference-side fault."""
    _, _, reference = runs
    assert str(reference["fault|below_s_local"]).startswith("TypeError")
    s_local = S // CASES["llama_tp2"]["tp"]
    mid = s_local + 4
    sharded = reference["fault|mid|sharded_k"]
    plain = reference["fault|mid|plain_k"]
    # rank 0's segment is right; rank 1's is the clamped slice (the
    # sharded k is computed from head shards: equal up to rounding)
    _close(sharded[:, :, :s_local], plain[:, :, :s_local], "rank 0")
    _close(sharded[:, :, s_local:], plain[:, :, mid - s_local:mid],
           "rank 1 holds the clamped slice")
    assert not np.allclose(sharded[:, :, s_local:], plain[:, :, s_local:],
                           rtol=RTOL, atol=ATOL)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:5])
    else:
        print(json.dumps({"usage": "--reference OUT.npz TMPDIR GROUP"}))
        sys.exit(2)
