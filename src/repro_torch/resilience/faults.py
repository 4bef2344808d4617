"""Seeded fault injection: the chaos half of the recovery loop.

A ``FaultPlan`` is a deterministic schedule of ``FaultEvent``s - rank
deaths, persistent or transient link degradations, windows of
pool-access failures - driven through the two seams the rest of the
repo already has:

* **link degrades** multiply the ``obs.StepEmulator`` per-level
  slowdown factors (``set_degrade``).  A pool-side degrade uses the
  backend-qualified key (``"node@cxl"``) so the level's ring/IB
  alternative keeps its healthy speed - that is what makes failover
  worth anything.
* **rank deaths and pool errors** install as the ``core.pool`` fault
  hook: every emulated pool access (collective write/read, heartbeat
  pulse, pool-checkpoint store) consults it, and the hook raises
  ``PoolAccessError`` for accesses by a dead rank or inside an active
  pool-error window (Bernoulli at ``error_rate``, seeded).

Determinism: the schedule is explicit and the pool-error coin flips
come from a ``numpy`` generator seeded at construction, so a fault run
is exactly reproducible - benchmarks commit bounds against it.

Copy of ``repro.resilience.faults``, with two additions for a run whose
ranks are processes (``launch.train``):

* ``ops`` scopes the hook to some pool accesses (None: every access, as
  the reference).  The launcher passes ``RANK_OPS``: heartbeats, the
  pool checkpoint store and the KV tier.  A collective's exchange
  (``core.pool.SharedPool``'s "write" / "read") is the reference's
  ``ppermute``, which never consults the hook; a fault there would
  leave the other ranks waiting on the dead rank's doorbells.
* ``replace(rank)``: the launcher keeps its ranks, so after a confirmed
  death the rank's process goes on as the node that replaced it, whose
  pool accesses the death no longer reaches (pool-error windows still
  do).  The pool partition the dead node committed outlives it, and the
  replacement restores from it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from repro_torch.core import pool as pool_mod

_KINDS = ("rank_death", "link_degrade", "pool_error")

# The pool accesses a rank's death or a pool-error window reaches in a
# run of rank processes: not a collective's exchange ("write" / "read").
RANK_OPS = frozenset({"heartbeat", "ckpt_write", "ckpt_read", "kv_write",
                      "kv_read", "refcount"})


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``step`` is the first step the fault is active; ``until_step``
    (exclusive) ends a *transient* fault, ``None`` makes it
    persistent.  Field use by kind:

    * ``rank_death``: ``rank`` dies at ``step`` (pool stores fail,
      heartbeat goes stale).  Always persistent.
    * ``link_degrade``: emulator degrade key ``link`` (axis, fabric,
      ``"axis@backend"``, or ``"*"``) slows by ``factor`` while
      active.
    * ``pool_error``: while active, any pool access fails with
      probability ``error_rate`` (1.0 = every access).
    """

    kind: str
    step: int
    rank: Optional[int] = None
    link: Optional[str] = None
    factor: float = 4.0
    until_step: Optional[int] = None
    error_rate: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {_KINDS})")
        if self.kind == "rank_death" and self.rank is None:
            raise ValueError("rank_death needs rank=")
        if self.kind == "link_degrade" and self.link is None:
            raise ValueError("link_degrade needs link=")
        if self.until_step is not None and self.until_step <= self.step:
            raise ValueError("until_step must be > step")

    def active(self, step: int) -> bool:
        if step < self.step:
            return False
        if self.kind == "rank_death":
            return True                     # death is forever
        return self.until_step is None or step < self.until_step

    def describe(self) -> str:
        span = (f"@{self.step}" if self.until_step is None
                else f"@{self.step}-{self.until_step}")
        if self.kind == "rank_death":
            return f"rank_death{span}:rank={self.rank}"
        if self.kind == "link_degrade":
            return f"link_degrade{span}:link={self.link},x{self.factor}"
        return f"pool_error{span}:rate={self.error_rate}"


_SPEC_RE = re.compile(
    r"(?P<kind>\w+)@(?P<step>\d+)(?:-(?P<until>\d+))?"
    r"(?::(?P<kv>[^;]*))?")


def _parse_one(part: str) -> FaultEvent:
    m = _SPEC_RE.fullmatch(part.strip())
    if m is None:
        raise ValueError(
            f"bad fault spec {part!r}; expected "
            f"kind@step[-until][:k=v,...], e.g. rank_death@12:rank=3")
    kv = {}
    for item in (m.group("kv") or "").split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        kv[k.strip()] = v.strip()
    kw: dict = {"kind": m.group("kind"), "step": int(m.group("step"))}
    if m.group("until") is not None:
        kw["until_step"] = int(m.group("until"))
    if "rank" in kv:
        kw["rank"] = int(kv["rank"])
    if "link" in kv:
        kw["link"] = kv["link"]
    if "factor" in kv:
        kw["factor"] = float(kv["factor"])
    if "rate" in kv:
        kw["error_rate"] = float(kv["rate"])
    return FaultEvent(**kw)


class FaultPlan:
    """A seeded, step-indexed schedule of faults.

    Drive it from the step loop::

        fp = FaultPlan.parse("rank_death@12:rank=5", seed=0)
        fp.install()                  # pool fault hook
        for step in range(steps):
            fp.begin_step(step, emulator=emu)   # link degrades
            ...
        fp.uninstall()

    ``begin_step`` applies/clears emulator degrades at activation and
    healing boundaries and returns the events newly activated this
    step; the installed hook covers rank deaths and pool-error
    windows continuously.
    """

    def __init__(self, events: "list[FaultEvent] | tuple" = (), *,
                 seed: int = 0, ops: Optional[frozenset] = None):
        self.events = tuple(sorted(events, key=lambda e: (e.step,
                                                          e.kind)))
        self._rng = np.random.default_rng(seed)
        self.step = -1
        self.injected: list = []            # (step, describe()) log
        self.ops = None if ops is None else frozenset(ops)
        self.replaced: set = set()          # dead ranks whose node was
        #                                     replaced (``replace``)

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0,
              ops: Optional[frozenset] = None) -> "FaultPlan":
        """Parse ``"kind@step[-until][:k=v,...];..."``, e.g.
        ``"link_degrade@10-18:link=node@cxl,factor=4;``
        ``rank_death@12:rank=3;pool_error@5-7:rate=0.5"``."""
        parts = [p for p in spec.split(";") if p.strip()]
        return cls([_parse_one(p) for p in parts], seed=seed, ops=ops)

    def replace(self, rank: int) -> None:
        """Rank ``rank``'s node was replaced: its death no longer fails
        the rank's pool accesses."""
        self.replaced.add(int(rank))

    # -- schedule state ---------------------------------------------------
    def dead_ranks(self, step: Optional[int] = None) -> set:
        s = self.step if step is None else step
        return {e.rank for e in self.events
                if e.kind == "rank_death" and e.active(s)}

    def active_events(self, step: Optional[int] = None) -> list:
        s = self.step if step is None else step
        return [e for e in self.events if e.active(s)]

    def begin_step(self, step: int, emulator=None) -> list:
        """Advance the schedule to ``step``: apply newly-active link
        degrades to ``emulator`` (and lift healed ones).  Returns the
        events that became active this step."""
        prev = self.step
        self.step = int(step)
        fresh = [e for e in self.events
                 if e.active(step) and not e.active(prev)]
        if emulator is not None:
            for e in self.events:
                if e.kind != "link_degrade":
                    continue
                if e.active(step) and not e.active(prev):
                    emulator.set_degrade(e.link, e.factor)
                elif e.active(prev) and not e.active(step):
                    emulator.set_degrade(e.link, 1.0)
        for e in fresh:
            self.injected.append((int(step), e.describe()))
        return fresh

    # -- the pool fault hook ----------------------------------------------
    def pool_hook(self, op: str, info: dict) -> None:
        """``core.pool`` fault hook: fail accesses by dead ranks, and
        any access inside an active pool-error window (seeded
        Bernoulli at the event's ``error_rate``)."""
        if self.ops is not None and op not in self.ops:
            return
        rank = info.get("rank")
        if rank is not None and rank in self.dead_ranks() \
                and rank not in self.replaced:
            raise pool_mod.PoolAccessError(
                f"rank {rank} is dead (op={op}, step={self.step})")
        for e in self.events:
            if e.kind == "pool_error" and e.active(self.step):
                if self._rng.random() < e.error_rate:
                    raise pool_mod.PoolAccessError(
                        f"transient pool fault (op={op}, "
                        f"step={self.step}, rate={e.error_rate})")

    def install(self) -> None:
        pool_mod.set_fault_hook(self.pool_hook)

    def uninstall(self) -> None:
        if pool_mod.get_fault_hook() == self.pool_hook:
            pool_mod.clear_fault_hook()

    def __enter__(self) -> "FaultPlan":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def describe(self) -> str:
        return "; ".join(e.describe() for e in self.events) or "(none)"
