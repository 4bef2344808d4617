"""Process-wide plan registry + the on-disk plan cache.

``Communicator(backend="auto")`` resolves its plan in this order:

1. the ``plan`` explicitly attached to the Communicator;
2. the process-wide active plan (``set_active_plan`` /
   ``activate_plan_file``);
3. the persisted default plan for the current hardware fingerprint
   (``ensure_default_plan``), generated on first use with the smoke
   grid and cached under :func:`plan_cache_dir` so later processes
   just load it.

Topology plans (format v3) are fingerprinted by the topology, and
``activate_plan_file`` also activates the embedded topology
(``core.topology.set_active_topology``) so every Communicator in the
process resolves its axes against the levels the plan was tuned for.

The registry is *epoch-versioned*: every ``set_active_plan`` bumps a
monotonically increasing epoch, and ``Communicator(backend='auto')``
stamps the epoch it resolved against into the ledger audit.

Ported from ``repro.tuner.runtime``.  The registry is per process: the
training launcher's ranks are spawned processes, so each rank activates
the plan itself (``TrainConfig.plan_path``).  The plan cache is a
directory of this package's own: plans tuned here price the fused cells
with the H100 roofline, so their ``predicted_time`` differs from the
reference's under the same fingerprint, and the two caches must not
share files.  The link-health registry and the rank-liveness registry are the
reference's (``obs.health.HealthMonitor`` and
``resilience.FailureMonitor`` publish, planners consult).
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

from repro_torch.core.hw import (CXL_POOL, INFINIBAND, CXLPoolConfig,
                                 InfiniBandConfig)
from repro_torch.core.topology import (Topology, get_active_topology,
                                       set_active_topology)
from repro_torch.tuner.plan import (Plan, hardware_fingerprint, load_plan,
                                    save_plan)
from repro_torch.tuner.sweep import SMOKE_GRID, TuneGrid, generate_plan

_ACTIVE: list = [None]
_EPOCH: list = [0]


def set_active_plan(plan: Optional[Plan]) -> None:
    _ACTIVE[0] = plan
    _EPOCH[0] += 1


def get_active_plan() -> Optional[Plan]:
    return _ACTIVE[0]


def plan_epoch() -> int:
    """Monotonic version of the active-plan registry: bumps on every
    ``set_active_plan`` / ``clear_active_plan``."""
    return _EPOCH[0]


def get_active_plan_versioned() -> tuple:
    """(active plan, registry epoch) - the pair ``backend='auto'``
    resolution reads, so audits can attribute each decision to the plan
    generation that produced it."""
    return _ACTIVE[0], _EPOCH[0]


def clear_active_plan() -> None:
    set_active_plan(None)


# -- link-health registry (obs.health publishes, planners consult) ---------
#
# Keyed "<level axis>/<fabric>" -> the health monitor's latest state for
# that link ({"degraded", "slowdown", "since_step", ...}).  Lives next
# to the active plan because it is plan-shaped advice: a degraded entry
# tells a planner (or a human reading the dry-run report) that the
# measured fabric no longer matches what the plan was tuned against.

_LINK_HEALTH: dict = {}


def set_link_health(key: str, state: dict) -> None:
    _LINK_HEALTH[str(key)] = dict(state)


def get_link_health(key: "str | None" = None):
    """One link's state dict (or None), or a copy of the whole registry
    when called without a key."""
    if key is None:
        return {k: dict(v) for k, v in _LINK_HEALTH.items()}
    return _LINK_HEALTH.get(str(key))


def degraded_links() -> list:
    return sorted(k for k, v in _LINK_HEALTH.items()
                  if v.get("degraded"))


def clear_link_health() -> None:
    _LINK_HEALTH.clear()


# -- rank-liveness registry (resilience.FailureMonitor publishes) ----------
#
# Keyed by global rank -> the monitor's latest verdict for that rank
# ({"alive", "last_beat_step", "confirmed_step", ...}).  Mirrors the
# link-health registry: plan-shaped advice living next to the plan,
# consulted by planners deriving survivor topologies and by launchers
# deciding whether a re-plan is due.

_RANK_LIVENESS: dict = {}


def set_rank_liveness(rank: int, state: dict) -> None:
    _RANK_LIVENESS[int(rank)] = dict(state)


def get_rank_liveness(rank: "int | None" = None):
    """One rank's state dict (or None), or a copy of the whole registry
    when called without a rank."""
    if rank is None:
        return {r: dict(v) for r, v in _RANK_LIVENESS.items()}
    return _RANK_LIVENESS.get(int(rank))


def dead_ranks() -> list:
    """Ranks the failure monitor has *confirmed* dead, sorted."""
    return sorted(r for r, v in _RANK_LIVENESS.items()
                  if not v.get("alive", True))


def clear_rank_liveness() -> None:
    _RANK_LIVENESS.clear()


def activate_plan_file(path: str, *,
                       pool: Optional[CXLPoolConfig] = None,
                       ib: Optional[InfiniBandConfig] = None,
                       topology: Optional[Topology] = None) -> Plan:
    """Load a plan file, fingerprint-check it against the given
    hardware (``pool``/``ib`` for flat plans, ``topology`` for
    per-level ones), publish it as the process-wide active plan, and
    activate its embedded topology when no explicit one is set.
    Returns the activated Plan; raises ``ValueError`` on a fingerprint
    mismatch and ``PlanVersionError`` on an unreadable format."""
    plan = load_plan(path, pool=pool, ib=ib, topology=topology)
    set_active_plan(plan)
    topo = plan.topology()
    if topo is not None:
        current = get_active_topology()
        if current is None:
            set_active_topology(topo)
        elif current.fingerprint() != topo.fingerprint():
            warnings.warn(
                f"topology conflict: the active topology fingerprints "
                f"to {current.fingerprint()} (levels "
                f"{[f'{lv.axis}:{lv.fabric}' for lv in current.levels]})"
                f" but plan {path} was tuned for topology "
                f"{topo.fingerprint()} (levels "
                f"{[f'{lv.axis}:{lv.fabric}' for lv in topo.levels]}); "
                f"the plan's level-keyed cells will not resolve and "
                f"collectives fall back to ring")
    return plan


def plan_cache_dir() -> str:
    """``$REPRO_PLAN_CACHE/repro_torch`` when the variable is set (the
    reference caches in ``$REPRO_PLAN_CACHE`` itself), else
    ``~/.cache/repro_torch/plans``."""
    env = os.environ.get("REPRO_PLAN_CACHE")
    if env:
        return os.path.join(env, "repro_torch")
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "plans")


def default_plan_path(pool: CXLPoolConfig = CXL_POOL,
                      ib: InfiniBandConfig = INFINIBAND,
                      topology: Optional[Topology] = None) -> str:
    fp = topology.fingerprint() if topology is not None else \
        hardware_fingerprint(pool, ib)
    return os.path.join(plan_cache_dir(), f"plan_{fp}.json")


def ensure_default_plan(pool: CXLPoolConfig = CXL_POOL,
                        ib: InfiniBandConfig = INFINIBAND,
                        grid: TuneGrid = SMOKE_GRID,
                        topology: Optional[Topology] = None) -> Plan:
    """Return the active plan, loading or generating+persisting the
    fingerprint-keyed default when none is set.  With a topology the
    default plan is tuned per level against each level's own fabric.
    Several processes may call this at once: each writes the same plan
    through its own temporary file (``save_plan``)."""
    active = get_active_plan()
    if active is not None:
        return active
    path = default_plan_path(pool, ib, topology=topology)
    if os.path.exists(path):
        try:
            plan = load_plan(path, pool=pool, ib=ib, topology=topology)
            set_active_plan(plan)
            return plan
        except (ValueError, OSError, KeyError):
            pass  # stale/corrupt cache: regenerate below
    plan = generate_plan(grid, pool=pool, ib=ib, topology=topology)
    try:
        save_plan(plan, path)
    except OSError:
        pass  # read-only cache dir: keep the in-memory plan
    set_active_plan(plan)
    return plan
