"""Request-level serving engine: continuous batching over a pooled,
paged KV cache.

Port of ``repro/serving/engine.py``.  The engine's numeric state is one
dense slot-major cache on the device (``ServeConfig.decode_slots`` batch
lanes) driven by one decode step whose position argument is a per-slot
vector (``model.decode_step`` with ``pos: (B,)``), so slots at different
depths decode together.  The step writes only the active slots' caches,
in place.  Around it:

* admission / preemption / slot packing live in
  ``serving.scheduler.Scheduler`` (``continuous`` or the
  batch-synchronous ``static`` baseline);
* HBM is accounted in fixed token blocks
  (``serving.kvcache.BlockManager``), and when a growing sequence
  cannot get a block the newest running request is *evicted to the
  pool*: its slot's cache image is serialized through
  ``core.pool.PoolBlockAllocator`` (doorbell-committed) and restored
  bitwise-exactly when a slot frees up - or, when the placement oracle
  prices recompute cheaper than the pool round-trip, dropped and
  re-prefixed by teacher-forcing (audited in the ledger);
* with ``prefix_sharing`` on, complete prompt blocks are published to
  a hash-addressed :class:`~repro_torch.serving.kvcache.PooledKVStore`;
  a later request (this engine or any engine *sharing the store*)
  restores the longest pooled prefix instead of prefilling it, and
  teacher-forces only the remainder.

A conditioned model's requests carry their frontend's input in
``Request.extras`` (``frontend`` patch embeddings of a vision prefix,
whose ``frontend_tokens`` take the cache's first positions, or an
encoder's ``source`` frames, whose cross-attention keys and values the
prefill caches); such requests share no prefixes.  A request whose
prefix, prompt and new tokens do not fit ``max_seq`` is refused at
``submit``.

API: ``submit(Request) -> id``, ``step() -> bool`` (one scheduler round
+ one decode step), ``poll() -> finished-token streaming``, and the
``generate()`` compat wrapper.  Sampling is per request: token ``i`` of
a request draws from its own ``torch.Generator`` seeded from
``(seed, i)``, so a request's stream is invariant to how it was
scheduled, preempted or restored.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ledger
from repro_torch.core.device import resolve_device
from repro_torch.core.hw import CXL_POOL, INFINIBAND
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.pcontext import UNSHARDED, ParallelContext
from repro_torch.serving import kvcache
from repro_torch.serving.scheduler import (FINISHED, RUNNING, Request,
                                           RequestState, SamplingParams,
                                           Scheduler)
from repro_torch.tuner.costmodel import roofline_compute_time
from repro_torch.tuner.plan import load_plan

_ENGINE_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine-level serving configuration (per-request knobs live in
    ``SamplingParams``; ``temperature`` here is the default the
    ``generate()`` compat wrapper folds into its requests)."""

    max_seq: int = 2048
    window: Optional[int] = None          # sliding-window cache size
    temperature: float = 0.0              # compat default for generate()
    cache_dtype: str = "float32"
    # KV tiering: decode lanes, HBM block budget, pool budget.
    decode_slots: int = 4
    kv_block_tokens: int = 16
    hbm_budget_blocks: Optional[int] = None   # None: slots*ceil(seq/bt)
    pool_budget_bytes: int = 64 << 20
    pool_block_bytes: int = 1 << 16
    scheduler: str = "continuous"             # or 'static' (baseline)
    # Eviction placement: 'auto' prices pool-round-trip vs recompute
    # through the live oracle; 'pool' and 'recompute' force one arm.
    kv_placement: str = "auto"
    # Cross-request pooled-prefix sharing.  Off by default: a pooled
    # prefix is restored bitwise, but the *suffix* is then teacher-
    # forced through the decode path, whose float reduction order can
    # differ from prefill's.
    prefix_sharing: bool = False
    # Autotuning plan whose ``kv_block`` cells price eviction placement
    # ahead of the live oracle (``repro_torch.launch.tune
    # --kv-block-bytes``).  The engine is unsharded: no collective of
    # it resolves against the plan.
    plan_path: Optional[str] = None


def sample_seed(seed: int, index: int) -> int:
    """The generator seed of token ``index`` of a request seeded
    ``seed`` (a pure function of the pair, not of scheduling)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0])


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 pc: ParallelContext = UNSHARDED, *,
                 pool: Optional[kvcache.PooledKVStore] = None,
                 device=None, obs=None):
        """``device``: where the cache lives and the params must already
        be (``None``: the CUDA card; raises when there is none).
        ``obs``: an ``obs.ObsSession``, as the reference's ``obs=`` hook:
        diagnostics go through its ``diag``, each ``step`` is a
        ``serve_step`` span, and after each step the serving counters are
        exported as ``repro_serve_*`` gauges (the reference's set)."""
        self.device = resolve_device(device)
        if scfg.window is not None and scfg.window < scfg.max_seq:
            # The prefill cache spans max_seq while a window cache spans
            # the window; the reference fails here too (ROADMAP queue 3).
            raise NotImplementedError(
                f"window {scfg.window} < max_seq {scfg.max_seq}: ring-"
                f"buffer serving caches are not supported")
        if params["embed"]["tok"].device != self.device:
            raise ValueError(f"params live on "
                             f"{params['embed']['tok'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.pc = pc
        self.obs = obs
        self._kv_plan = None
        if scfg.plan_path is not None:
            self._kv_plan = load_plan(scfg.plan_path, pool=CXL_POOL,
                                      ib=INFINIBAND)
            if pc.tp_axis is None or pc.tp == 1:
                self._diag("plan loaded but the engine is unsharded "
                           "(tp=1): no collectives to autotune")
        self._uid = f"eng{next(_ENGINE_IDS)}"
        self._cd = getattr(torch, scfg.cache_dtype)
        self._n_prefix = model.prefix_tokens(cfg)
        self._extras_keys = model.frontend_inputs(cfg)

        # Dense slot cache + its structural layout.
        self.layout = kvcache.CacheLayout(
            cfg, pc, scfg.decode_slots, scfg.max_seq, self._cd,
            window=scfg.window)
        self.caches = model.init_cache(cfg, pc, scfg.decode_slots,
                                       scfg.max_seq, cache_dtype=self._cd,
                                       window=scfg.window,
                                       device=self.device)

        # Paged HBM accounting + scheduler + pool tier.
        bt = scfg.kv_block_tokens
        n_hbm = scfg.hbm_budget_blocks
        if n_hbm is None:
            n_hbm = scfg.decode_slots * (-(-scfg.max_seq // bt))
        self.blocks = kvcache.BlockManager(n_hbm, bt)
        self.sched = Scheduler(scfg.decode_slots, self.blocks,
                               mode=scfg.scheduler)
        self.pool = pool if pool is not None else kvcache.PooledKVStore(
            scfg.pool_budget_bytes, block_bytes=scfg.pool_block_bytes)
        self._share = bool(scfg.prefix_sharing
                           and self.layout.block_sharable)

        self._states: dict = {}          # request id -> RequestState
        self._sample_after: dict = {}    # id -> sample when forced drains
        self._gen = itertools.count()
        # Serving counters (read by stats()).
        self.counters = {"finished": 0, "evictions": 0, "restores": 0,
                         "replays": 0, "prefix_hits": 0,
                         "prefix_hit_tokens": 0, "prefix_publishes": 0,
                         "decode_steps": 0, "prefills": 0}

    def _diag(self, msg: str) -> None:
        if self.obs is not None:
            self.obs.diag("serve", msg)
        else:
            print(f"[serve] {msg}")

    def stats(self) -> dict:
        return {"inflight": self.sched.inflight,
                "running": len(self.sched.running),
                "waiting": len(self.sched.waiting),
                "preempted_queued": len(self.sched.preempted),
                "hbm_blocks_used": self.blocks.used_blocks,
                "hbm_shared_hits": self.blocks.shared_block_hits,
                "pool": self.pool.stats, **self.counters}

    def _export_metrics(self) -> None:
        if self.obs is None or not self.obs.enabled:
            return
        g = self.obs.registry.gauge
        g("repro_serve_inflight",
          "requests in flight").set(self.sched.inflight)
        g("repro_serve_hbm_blocks_used",
          "HBM KV blocks held").set(self.blocks.used_blocks)
        g("repro_serve_pool_blocks_used",
          "pool KV blocks held").set(self.pool.alloc.used_blocks)
        for k in ("finished", "evictions", "restores", "replays",
                  "prefix_hits", "prefix_publishes"):
            g(f"repro_serve_{k}_total", f"serving {k}").set(
                self.counters[k])
        g("repro_serve_pool_hits_total",
          "pooled KV store hits").set(self.pool.hits)

    # -- request API -------------------------------------------------------

    def submit(self, req: Request) -> str:
        """Queue a request; returns its id (``poll`` key).  Refuses a
        request without its frontend's extras, and one whose cache would
        outgrow ``max_seq`` (prefix + prompt + new tokens - 1 positions;
        a ring-buffer window wraps by design)."""
        got = set(req.extras or ())
        if got != self._extras_keys:
            raise ValueError(f"request {req.id!r} carries extras "
                             f"{sorted(got)}; {self.cfg.name} takes "
                             f"{sorted(self._extras_keys)}")
        need = self._n_prefix + len(req.tokens) + req.max_new_tokens - 1
        if self.scfg.window is None and need > self.scfg.max_seq:
            raise ValueError(f"request {req.id!r} needs {need} cache "
                             f"positions ({self._n_prefix} prefix + "
                             f"{len(req.tokens)} prompt + "
                             f"{req.max_new_tokens} new - 1); max_seq is "
                             f"{self.scfg.max_seq}")
        if req.id in self._states:
            raise ValueError(f"request id {req.id!r} already submitted")
        self._states[req.id] = self.sched.submit(req)
        return req.id

    def poll(self, req_id: Optional[str] = None):
        """Finished-token streaming.  ``poll(id)`` returns
        ``(status, new_tokens)`` - the tokens generated since the last
        poll.  ``poll()`` returns ``{id: (status, new_tokens)}`` for
        every tracked request and drops fully-delivered finished
        requests from tracking."""
        if req_id is not None:
            st = self._states[req_id]
            fresh = [int(t) for t in st.generated[st.delivered:]]
            st.delivered = len(st.generated)
            if st.status == FINISHED and st.delivered == len(
                    st.generated):
                del self._states[req_id]
            return st.status, fresh
        out = {}
        for rid in list(self._states):
            out[rid] = self.poll(rid)
        return out

    def step(self) -> bool:
        """One engine round: admit what fits, secure block capacity
        (evicting to the pool when HBM runs out), run one decode step
        over every running slot, sample/advance each request.  Returns
        True while work remains."""
        span = self.obs.span("serve_step") if self.obs is not None \
            else contextlib.nullcontext()
        with span:
            self._do_step()
        self._export_metrics()
        return not self.sched.idle

    def generate(self, batch: dict, max_new_tokens: int,
                 seed: int = 0) -> np.ndarray:
        """Batch API as a thin wrapper: one request per row of
        ``batch["tokens"]`` (temperature from ``ServeConfig``), each with
        its row of the batch's other entries as extras, stepped until
        drained.  Returns (B, max_new_tokens)."""
        toks = np.asarray(batch["tokens"])
        sp = SamplingParams(temperature=self.scfg.temperature, seed=seed)
        ids = []
        for b in range(toks.shape[0]):
            extras = {k: np.asarray(v)[b] for k, v in batch.items()
                      if k != "tokens"} or None
            ids.append(self.submit(Request(
                id=f"gen{next(self._gen)}", tokens=toks[b], sampling=sp,
                max_new_tokens=max_new_tokens, extras=extras)))
        while self.step():
            pass
        return np.asarray([self.poll(rid)[1] for rid in ids], np.int32)

    # -- internals ---------------------------------------------------------

    def _prompt_ntok(self, st: RequestState) -> int:
        """Cache positions the prefill fills: the prefix and the prompt."""
        return self._n_prefix + len(st.req.tokens)

    def _hashes(self, st: RequestState) -> list:
        """Chain hashes of the prompt's complete blocks (content
        addressing is text-only: conditioned requests do not share)."""
        if st.req.extras is not None or self._n_prefix:
            return []
        return kvcache.chain_hashes(st.req.tokens, self.blocks.block_tokens)

    def _reserve(self, st: RequestState) -> bool:
        """Transactionally claim the blocks an admission needs (the
        scheduler's ``reserve`` callback)."""
        ntok = st.pos if st.preemptions else self._prompt_ntok(st)
        try:
            self.blocks.alloc(st.req.id, max(ntok, 1), self._hashes(st))
            return True
        except MemoryError:
            return False

    def _replay_flops(self, ntok: int) -> float:
        """Roofline FLOPs of recomputing ``ntok`` tokens of cache
        (~2 * active params per token, forward only)."""
        return 2.0 * self.cfg.active_param_count() * max(1, ntok)

    def _evict(self, st: RequestState) -> None:
        """Preemption-by-eviction: spill ``st``'s slot to the pool (or
        drop it for recompute when the oracle prices that cheaper)."""
        nbytes = self.layout.bytes_for(st.pos)
        if self.scfg.kv_placement == "auto":
            backend = kvcache.resolve_kv_choice(
                "kv_block", nbytes, self._replay_flops(st.pos),
                plan=self._kv_plan,
                block_bytes=self.pool.alloc.block_bytes).backend
        else:
            backend = self.scfg.kv_placement
            ledger.record_choice("kv_block", max(1, nbytes), 1,
                                 backend, 1, "kv_tier")
        if backend == "pool":
            img = self.layout.extract_slot(self.caches, st.slot, st.pos)
            if not self.pool.put(("evict", self._uid, st.req.id), img):
                self._diag(f"pool budget full: eviction of "
                           f"{st.req.id!r} falls back to recompute")
        self.blocks.free(st.req.id)
        self.sched.preempt(st)
        self.counters["evictions"] += 1

    def _ensure_capacity(self, st: RequestState) -> bool:
        """Secure the next token's HBM block, evicting newer requests
        as needed.  False when ``st`` itself got preempted."""
        while True:
            try:
                self.blocks.append(st.req.id, 1)
                return True
            except MemoryError:
                victim = self.sched.pick_victim(exclude=(st,))
                if victim is None:
                    raise MemoryError(
                        f"hbm_budget_blocks={self.blocks.num_blocks} "
                        f"cannot hold request {st.req.id!r} alone "
                        f"({self.blocks.used_blocks} blocks at "
                        f"{st.pos} tokens)")
                self._evict(victim)

    def _sample(self, rows: torch.Tensor, picks: list) -> list:
        """Sample one token per ``(row index, SamplingParams, token
        index)`` from ``rows`` (n, >= vocab) logits.  Greedy rows take
        the device argmax (first maximum, like ``jnp.argmax``); sampled
        rows draw from a CPU generator seeded by :func:`sample_seed`."""
        rows = rows[:, :self.cfg.vocab_size]
        greedy = rows.argmax(dim=-1).tolist()
        out = []
        for r, sp, index in picks:
            if sp.temperature == 0.0:
                out.append(int(greedy[r]))
                continue
            gen = torch.Generator().manual_seed(sample_seed(sp.seed,
                                                            index))
            probs = torch.softmax(rows[r].float().cpu() / sp.temperature,
                                  dim=-1)
            out.append(int(torch.multinomial(probs, 1, generator=gen)))
        return out

    def _finish(self, st: RequestState) -> None:
        self.blocks.free(st.req.id)
        self.sched.finish(st)
        self.counters["finished"] += 1

    def _prefill_into_slot(self, st: RequestState) -> torch.Tensor:
        """Full prefill of the prompt (behind its extras), copied into the
        slot on the device; returns the last-position logits (1, V)."""
        batch = {"tokens": torch.as_tensor(
            np.asarray(st.req.tokens, np.int64), device=self.device)[None]}
        for k, v in (st.req.extras or {}).items():
            batch[k] = torch.as_tensor(np.asarray(v),
                                       device=self.device)[None]
        logits, c1 = model.prefill(self.params, batch, self.cfg,
                                   self.pc, self.scfg.max_seq,
                                   cache_dtype=self._cd,
                                   window=self.scfg.window)
        self.counters["prefills"] += 1
        st.n_prefix = self._n_prefix
        st.pos = self._prompt_ntok(st)
        self.layout.copy_slot(self.caches, st.slot, c1, 0, st.pos)
        return logits[:, -1]

    def _prefill_request(self, st: RequestState) -> None:
        """Materialize a fresh prompt, then sample the first token."""
        logits = self._prefill_into_slot(st)
        if self._share:
            self._publish_prefix(st)
        tok = self._sample(logits, [(0, st.req.sampling, 0)])[0]
        st.generated.append(tok)
        st.last_token = tok

    def _publish_prefix(self, st: RequestState) -> None:
        """Push the prompt's complete blocks to the pooled prefix
        store (hash-addressed; write -> refcount -> doorbell ring)."""
        bt = self.blocks.block_tokens
        for i, h in enumerate(self._hashes(st)):
            key = ("kvblk", h)
            if key in self.pool:
                continue
            img = self.layout.extract_token_range(
                self.caches, st.slot, i * bt, (i + 1) * bt)
            if not self.pool.put(key, img):
                break               # pool full of pinned entries
            self.counters["prefix_publishes"] += 1

    def _try_prefix_restore(self, st: RequestState) -> bool:
        """Restore the longest pooled prefix and queue the rest of the
        prompt for teacher-forcing.  False on miss (caller prefills)."""
        if not self._share:
            return False
        hashes = self._hashes(st)
        bt = self.blocks.block_tokens
        # Cap so at least one prompt token is teacher-forced: its
        # decode step yields the logits the first sample needs.
        usable = min(len(hashes), (len(st.req.tokens) - 1) // bt)
        run = 0
        while run < usable and ("kvblk", hashes[run]) in self.pool:
            run += 1
        if run == 0:
            return False
        imgs = []
        keys = [("kvblk", h) for h in hashes[:run]]
        for key in keys:
            self.pool.acquire(key)      # pin against reclaim mid-read
        try:
            for key in keys:
                img = self.pool.get(key)
                if img is None:         # lost a race with reclaim
                    return False
                imgs.append(img)
        finally:
            for key in keys:
                self.pool.release(key)
        for i, img in enumerate(imgs):
            self.layout.insert_token_range(
                self.caches, st.slot, i * bt, (i + 1) * bt, img)
        prefix = run * bt
        st.pos = prefix
        st.forced = tuple(st.req.tokens[prefix:])
        self._sample_after[st.req.id] = True
        st.prefix_hit_tokens = prefix
        self.counters["prefix_hits"] += 1
        self.counters["prefix_hit_tokens"] += prefix
        # Audit: pooled prefix replaced prefill compute over `prefix`
        # tokens - a kv_prefix cell, recorded like any collective.
        nbytes = self.layout.bytes_for_range(0, prefix)
        ledger.record_choice(
            "kv_prefix", max(1, nbytes), 1, "pool", 1, "kv_tier",
            predicted_time=self.pool.predict_get_s(nbytes),
            baseline_time=roofline_compute_time(
                self._replay_flops(prefix)))
        return True

    def _admit(self, st: RequestState, slot: int) -> None:
        if st.preemptions:
            key = ("evict", self._uid, st.req.id)
            img = self.pool.get(key)
            if img is not None:
                # Bitwise restore of the evicted image (blocks were
                # reserved at admission).
                self.layout.insert_slot(self.caches, slot, st.pos, img)
                self.pool.remove(key)
                self.counters["restores"] += 1
                return
            # Recompute path: re-prefill the prompt, then teacher-
            # force the tokens already sampled (minus the last, which
            # is the next step's input).  The sample stream is index-
            # keyed, so the continuation is unchanged.
            self._replay(st)
            return
        if self._try_prefix_restore(st):
            return
        self._prefill_request(st)
        if st.done:
            self._finish(st)

    def _replay(self, st: RequestState) -> None:
        done_tokens = list(st.generated)
        st.forced = ()
        # Re-size the admission reservation (made at the preempted
        # pos) down to the prompt; forced steps grow it back.
        self.blocks.free(st.req.id)
        self.blocks.alloc(st.req.id, self._prompt_ntok(st),
                          self._hashes(st))
        self._prefill_into_slot(st)
        st.generated = done_tokens
        # Feed back everything but the last sampled token; sampling
        # must not rerun when the forced queue drains.
        st.forced = tuple(done_tokens[:-1])
        self._sample_after[st.req.id] = False
        st.last_token = done_tokens[-1]
        self.counters["replays"] += 1

    def _do_step(self) -> None:
        for adm in self.sched.admissions(self._reserve):
            self._admit(adm.state, adm.slot)
        # Secure one token of growth per running request; evictions
        # here shrink `running` for this round.
        stepping = []
        for st in list(self.sched.running.values()):
            if st.status == RUNNING and self._ensure_capacity(st):
                stepping.append(st)
        # An eviction later in the loop may have preempted an earlier
        # entrant; only still-running slots step.
        stepping = [st for st in stepping if st.status == RUNNING]
        if not stepping:
            if self.sched.inflight and not self.sched.running:
                head = (self.sched.preempted or self.sched.waiting)[0]
                raise MemoryError(
                    f"engine cannot make progress: request "
                    f"{head.req.id!r} does not fit an empty "
                    f"hbm_budget_blocks={self.blocks.num_blocks}")
            return
        n = self.scfg.decode_slots
        tok = np.zeros((n, 1), np.int64)
        pos = np.zeros((n,), np.int64)
        active = np.zeros((n,), bool)
        for st in stepping:
            tok[st.slot, 0] = st.forced[0] if st.forced else st.last_token
            pos[st.slot] = st.pos
            active[st.slot] = True
        dev = self.device
        logits, _ = model.decode_step(
            self.params, self.caches, torch.from_numpy(tok).to(dev),
            torch.from_numpy(pos).to(dev), self.cfg, self.pc,
            window=self.scfg.window,
            active=torch.from_numpy(active).to(dev))
        self.counters["decode_steps"] += 1
        picks, sampling = [], []
        for st in stepping:
            st.pos += 1
            if st.forced:
                st.forced = st.forced[1:]
                if st.forced:
                    continue
                if not self._sample_after.pop(st.req.id, True):
                    continue        # replay rejoin: last_token is set
            picks.append((st.slot, st.req.sampling, len(st.generated)))
            sampling.append(st)
        if not picks:
            return
        for st, tokv in zip(sampling, self._sample(logits[:, 0], picks)):
            st.generated.append(tokv)
            st.last_token = tokv
            if st.done:
                self._finish(st)
