"""Continuous-batching request scheduler (policy only, no numerics).

The scheduler owns the request lifecycle

    WAITING -> RUNNING -> FINISHED
                 |  ^
                 v  |            (preemption-by-eviction: the engine
              PREEMPTED           spills the slot's cache to the pool)

and the two placement resources the engine cannot see from inside a
jitted step: decode slots (the dense cache's batch lanes) and HBM
blocks (the :class:`~repro_torch.serving.kvcache.BlockManager` budget).  It
is deliberately free of torch / pool I/O so the policy is unit-testable
and the virtual-clock benchmark can drive the *real* scheduler without
touching a model.

Two modes:

* ``continuous`` - per-request admission: any free slot whose blocks
  fit is filled immediately, preempted requests are resumed first
  (they hold progress), and when a growing sequence cannot get a block
  the *newest* running request is evicted (vLLM's policy: the oldest
  request never starves).
* ``static`` - the PR-8-era batch-synchronous engine as a policy: a
  batch is admitted only when the engine is idle, and the next batch
  waits until every member finished.  This is the serving benchmark's
  baseline, running through the identical engine machinery.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from repro_torch.serving.kvcache import BlockManager

WAITING = "waiting"
RUNNING = "running"
PREEMPTED = "preempted"
FINISHED = "finished"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (the request-level half of the old
    ``ServeConfig``): ``temperature == 0`` is greedy; ``seed`` feeds a
    per-request key folded with the token index, so a request's sample
    stream does not depend on how it was scheduled."""

    temperature: float = 0.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt tokens in, sampled tokens out."""

    id: str
    tokens: tuple                       # prompt token ids
    sampling: SamplingParams = SamplingParams()
    max_new_tokens: int = 16
    # Non-text conditioning (vision frontend / encoder source) for the
    # compat path; keyed per request, batch dim stripped.
    extras: Optional[dict] = None

    def __post_init__(self):
        object.__setattr__(self, "tokens",
                           tuple(int(t) for t in self.tokens))
        if not self.tokens:
            raise ValueError(f"request {self.id!r} has an empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.id!r}: max_new_tokens "
                             f"must be >= 1")


@dataclasses.dataclass
class RequestState:
    """Mutable per-request record the scheduler and engine share."""

    req: Request
    arrival: int                        # admission-order tiebreaker
    status: str = WAITING
    slot: int = -1
    pos: int = 0            # cache positions filled (incl. any prefix)
    n_prefix: int = 0       # non-text conditioning tokens before text
    forced: tuple = ()      # prompt tokens still to teacher-force
    generated: list = dataclasses.field(default_factory=list)
    delivered: int = 0      # tokens already handed out via poll()
    last_token: int = -1    # input token for the next decode step
    preemptions: int = 0
    prefix_hit_tokens: int = 0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new_tokens

    @property
    def total_tokens(self) -> int:
        """Tokens the request's cache must hold right now."""
        return self.pos


@dataclasses.dataclass(frozen=True)
class Preemption:
    """Engine order: spill this running request's slot to the pool."""

    state: RequestState


@dataclasses.dataclass(frozen=True)
class Admission:
    """Engine order: materialize this request's cache in ``slot``
    (fresh prefill, pooled-prefix restore, or eviction-image restore
    - the engine decides which, the scheduler only placed it)."""

    state: RequestState
    slot: int


class Scheduler:
    def __init__(self, n_slots: int, blocks: BlockManager, *,
                 mode: str = "continuous"):
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        if n_slots <= 0:
            raise ValueError("need at least one decode slot")
        self.mode = mode
        self.n_slots = int(n_slots)
        self.blocks = blocks
        self.waiting: deque = deque()
        self.preempted: deque = deque()
        self.running: dict = {}          # slot -> RequestState
        self._free_slots = list(range(self.n_slots - 1, -1, -1))
        self._arrivals = 0
        self.preemption_count = 0

    # -- queue state -------------------------------------------------------

    @property
    def inflight(self) -> int:
        return (len(self.waiting) + len(self.preempted)
                + len(self.running))

    @property
    def idle(self) -> bool:
        return self.inflight == 0

    def submit(self, req: Request) -> RequestState:
        st = RequestState(req=req, arrival=self._arrivals)
        self._arrivals += 1
        self.waiting.append(st)
        return st

    # -- admission ---------------------------------------------------------

    def admissions(self, reserve) -> list:
        """Requests to place this step, in priority order (resume
        preempted work before admitting fresh prompts).

        ``reserve(state) -> bool`` must *transactionally* claim the
        candidate's HBM blocks (the engine binds it to
        ``BlockManager.alloc``): a candidate is only taken off its
        queue once its blocks are actually held, so one round's
        admissions can never over-commit the budget.  In ``static``
        mode nothing is admitted until the engine drained completely.
        """
        if self.mode == "static" and self.running:
            return []
        out = []
        for queue in (self.preempted, self.waiting):
            while queue and self._free_slots:
                st = queue[0]
                if not reserve(st):
                    break
                queue.popleft()
                slot = self._free_slots.pop()
                st.slot = slot
                st.status = RUNNING
                self.running[slot] = st
                out.append(Admission(state=st, slot=slot))
        return out

    # -- preemption --------------------------------------------------------

    def pick_victim(self, *, exclude=()) -> Optional[RequestState]:
        """Newest-arrival running request not in ``exclude`` (the
        oldest request never starves)."""
        candidates = [st for st in self.running.values()
                      if st not in exclude]
        if not candidates:
            return None
        return max(candidates, key=lambda st: st.arrival)

    def preempt(self, st: RequestState) -> Preemption:
        """Take ``st`` off its slot; it re-queues at the *front* so it
        resumes before fresh admissions."""
        if st.status != RUNNING:
            raise ValueError(f"cannot preempt {st.req.id!r} in state "
                             f"{st.status}")
        del self.running[st.slot]
        self._free_slots.append(st.slot)
        st.slot = -1
        st.status = PREEMPTED
        st.preemptions += 1
        self.preemption_count += 1
        self.preempted.appendleft(st)
        return Preemption(state=st)

    # -- completion --------------------------------------------------------

    def finish(self, st: RequestState) -> None:
        if st.status != RUNNING:
            raise ValueError(f"cannot finish {st.req.id!r} in state "
                             f"{st.status}")
        del self.running[st.slot]
        self._free_slots.append(st.slot)
        st.slot = -1
        st.status = FINISHED
