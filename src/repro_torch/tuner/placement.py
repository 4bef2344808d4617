"""Topology-aware placement planner.

With a topology alone the mesh->fabric assignment is hand-written: the
user decides that the FSDP axis rides the rack-scale CXL pool and the TP
axis the intra-node ring.  This module chooses that assignment from the
*workload*: given a model's collective mix (per-axis wire bytes,
primitive counts and overlap windows - from a dry-run record or the
analytic model) and a ``core.topology.Topology``, it enumerates every axis<->level assignment (including splits of one
logical axis across adjacent levels, and ragged levels priced with
their cross-group parent fabric) and prices each with the tuner's own
per-level oracles (``costmodel.predict_level_time``), minimizing the
predicted *exposed* communication time per step::

    exposed(call) = max(0, wire_time - overlap_window) * calls_per_step

The result is a ranked :class:`PlacementPlan`.  Launchers apply the
best placement when building the mesh (``train/serve --placement
auto``): the mesh axes are ordered by the levels they were
assigned to, the placed topology relabels those levels with the logical
axis names (topology fingerprints ignore axis names, so an existing
tuned plan keeps matching), and split axes resolve through the
``models.sharding`` axis-alias indirection - model code never changes.

Entry points
------------
``CollectiveMix.for_model``   analytic per-axis traffic for an arch
``CollectiveMix.from_dryrun`` per-axis traffic from a dry-run record
``plan_placement``            mix + topology -> ranked PlacementPlan
``placed_topology``           relabel levels with the assigned axes
``mesh_spec``                 (shape, axis names, aliases) for the mesh

Copied from ``repro.tuner.placement`` (framework-free).  One change:
``CollectiveMix.for_model`` takes the roofline's ``peak_flops`` and
``hbm_bw``, defaulting to the port's H100 constants
(``costmodel.roofline_compute_time``); the reference's TPU constants
give the reference's gather windows, so its plans come out the same.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Sequence

from repro_torch.core.topology import Level, Topology
from repro_torch.tuner import costmodel

# Primitives whose hierarchical decomposition we price exactly; the
# rest fall back to per-level recursion at the full payload.
_EXACT = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")


# --------------------------------------------------------------------- #
# the collective mix
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective call site on a logical axis, per training step."""

    primitive: str
    msg_bytes: int          # per-rank payload, the repo-wide convention
    calls: float = 1.0      # launches per step (trip-count scaled)
    overlap_s: float = 0.0  # compute window one launch can hide behind

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AxisTraffic:
    """A logical mesh axis: its required parallel degree and the
    per-step collective traffic the model issues over it."""

    axis: str
    size: int
    calls: tuple = ()       # of CollectiveCall

    @property
    def bytes_per_step(self) -> float:
        return sum(c.msg_bytes * c.calls for c in self.calls)


@dataclasses.dataclass(frozen=True)
class CollectiveMix:
    """The model's whole per-step collective traffic, split per logical
    axis - the workload half of the placement problem."""

    axes: tuple             # of AxisTraffic, any order

    def axis(self, name: str) -> AxisTraffic:
        for a in self.axes:
            if a.axis == name:
                return a
        raise KeyError(name)

    @classmethod
    def for_model(cls, cfg, axes: dict, *, seq: int = 4096,
                  batch_per_rank: int = 8, param_bytes: int = 2,
                  act_bytes: int = 2, tp_axis: str = "model",
                  overlap_gathers: bool = True,
                  pp_axis: Optional[str] = None,
                  microbatches: int = 8,
                  peak_flops: Optional[float] = None,
                  hbm_bw: Optional[float] = None) -> "CollectiveMix":
        """Analytic mix for a model config on logical ``axes``
        (``{"data": fsdp_degree, "model": tp_degree, "stage": pp}``).

        Per layer and step: the TP axis carries 4 activation
        AllReduces (attention + MLP output, forward and backward);
        every other axis is FSDP-style - 2 parameter AllGathers
        (forward + backward) and one gradient ReduceScatter of the
        layer's parameter bytes.  With ``overlap_gathers`` the gathers
        get the roofline residency of one layer's compute as their
        overlap window (the double-buffered prefetch of
        ``core.overlap`` hides them behind the previous layer).

        A pipeline axis (``pp_axis`` of degree ``p > 1``) carries the
        stage handoff instead: ``2 * microbatches`` p2p hops per step
        (forward activations + backward grads), each one microbatch's
        activation slab.  Pipelining also shrinks every *other* axis's
        per-layer traffic by ``1/p`` - a rank owns only its stage's
        slice of the stack, which is exactly why a PP x FSDP placement
        can beat FSDP-only at the same device count.

        ``peak_flops`` / ``hbm_bw`` price the roofline window (default:
        ``costmodel.roofline_compute_time``'s H100 constants).
        """
        n_layers = max(1, cfg.n_layers)
        pp = int(axes.get(pp_axis, 1)) if pp_axis else 1
        local_layers = n_layers / max(1, pp)
        layer_bytes = int(cfg.param_count() // n_layers) * param_bytes
        act = batch_per_rank * seq * cfg.d_model * act_bytes
        # fwd+bwd FLOPs of one layer's matmuls on this rank's tokens
        layer_flops = 6.0 * (cfg.param_count() / n_layers) \
            * batch_per_rank * seq
        roof = {k: v for k, v in (("peak_flops", peak_flops),
                                  ("hbm_bw", hbm_bw)) if v is not None}
        window = costmodel.roofline_compute_time(layer_flops, **roof) \
            if overlap_gathers else 0.0
        loads = []
        for name, size in axes.items():
            if size <= 1:
                # kept (traffic-free) so the mesh still carries the axis
                loads.append(AxisTraffic(name, int(size), ()))
                continue
            if pp_axis is not None and name == pp_axis:
                calls = (CollectiveCall(
                    "p2p", max(1, act // max(1, microbatches)),
                    calls=2.0 * microbatches),)
            elif name == tp_axis:
                calls = (CollectiveCall("all_reduce", act,
                                        calls=4.0 * local_layers),)
            else:
                calls = (CollectiveCall("all_gather",
                                        layer_bytes // max(1, size),
                                        calls=2.0 * local_layers,
                                        overlap_s=window),
                         CollectiveCall("reduce_scatter", layer_bytes,
                                        calls=1.0 * local_layers))
            loads.append(AxisTraffic(name, int(size), calls))
        if not any(a.size > 1 for a in loads):
            raise ValueError(f"no axis with size > 1 in {axes}")
        return cls(axes=tuple(loads))

    @classmethod
    def from_dryrun(cls, record: dict,
                    axis_sizes: Optional[dict] = None) -> "CollectiveMix":
        """Mix from a dry-run JSON record's ``auto_choices`` audit
        (``launch/dryrun --backend auto``).  Entries tagged with a
        topology level aggregate per level axis; untagged entries are
        attributed to the axis in ``axis_sizes`` (``{name: size}``)
        whose size matches their rank count."""
        choices = (record.get("ledger") or {}).get("auto_choices") or []
        sizes = dict(axis_sizes or {})
        per_axis: dict = {}
        nranks_seen: dict = {}
        for ch in choices:
            ax = ch.get("level")
            if ax is None:
                for name, size in sizes.items():
                    if size == ch["nranks"]:
                        ax = name
                        break
            if ax is None:
                continue
            per_axis.setdefault(ax, []).append(CollectiveCall(
                ch["primitive"], int(ch["msg_bytes"]),
                calls=float(ch.get("calls", 1.0)),
                overlap_s=0.0))
            nranks_seen[ax] = max(nranks_seen.get(ax, 1),
                                  int(ch["nranks"]))
        loads = [AxisTraffic(ax, int(sizes.get(ax, nranks_seen[ax])),
                             tuple(calls))
                 for ax, calls in per_axis.items()]
        if not loads:
            raise ValueError(
                "record carries no attributable auto_choices (run the "
                "dry-run with --backend auto, and either a --topology "
                "or pass axis_sizes)")
        return cls(axes=tuple(loads))


# --------------------------------------------------------------------- #
# pricing one axis on one run of levels
# --------------------------------------------------------------------- #

def _link_penalty(level: Level, backend: str,
                  penalties: Optional[dict]) -> float:
    """Measured-slowdown multiplier for pricing ``backend`` on
    ``level``.  Keys are "axis/fabric" (the link-health registry's
    keying) or a bare fabric kind.  On a cxl level the ``ring``
    backend is exempt: it rides the level's *alternative IB transport*
    (``level.ib_cfg``), which does not share the pool's fault - that
    exemption is what makes a penalized ranking fail over instead of
    writing the level off."""
    if not penalties:
        return 1.0
    if level.fabric == "cxl" and backend == "ring":
        return 1.0
    f = penalties.get(f"{level.axis}/{level.fabric}",
                      penalties.get(level.fabric, 1.0))
    return max(1.0, float(f))


def _best_level_time(level: Level, primitive: str, nranks: int,
                     msg_bytes: int,
                     penalties: Optional[dict] = None) -> float:
    """Cheapest backend the fabric can execute, under the level's own
    oracle (times any measured link penalty) - what the per-level
    tuner sweep would resolve to."""
    if nranks <= 1 or msg_bytes <= 0:
        return 0.0
    s = max(1, int(msg_bytes))
    if primitive == "p2p":
        # one full-payload hop; cxl sweeps the doorbell-chunking factor
        # exactly as the plan sweep does (costmodel.predict_p2p_time)
        best = math.inf
        for b in level.backends():
            factors = (1, 2, 4, 8, 16) if b == "cxl" else (1,)
            t = min(costmodel.predict_level_p2p_time(
                level, s, backend=b, slicing_factor=f) for f in factors)
            best = min(best, t * _link_penalty(level, b, penalties))
        return best
    return min(costmodel.predict_level_time(
        level, primitive, nranks, s, backend=b)
        * _link_penalty(level, b, penalties)
        for b in level.backends())


def _ragged_call_time(level: Level, parent: Optional[Level],
                      primitive: str, msg_bytes: int,
                      penalties: Optional[dict] = None) -> float:
    """Predicted wire time of one collective on a ragged level: the
    grouped decomposition the Communicator actually runs (within-group
    schedule on this fabric, sub-root exchange on the parent fabric)."""
    shape = level.shape
    s = max(1, int(msg_bytes))
    max_g, n_g, n = max(shape), len(shape), sum(shape)
    p = parent if parent is not None else level
    pen = penalties
    if primitive == "all_reduce":
        return (_best_level_time(level, "all_reduce", max_g, s, pen)
                + _best_level_time(p, "all_reduce", n_g, s, pen)
                + _best_level_time(level, "broadcast", max_g, s, pen))
    if primitive in ("all_gather", "gather"):
        return (_best_level_time(level, "all_gather", max_g, s, pen)
                + _best_level_time(p, "all_gather", n_g, s * max_g, pen)
                + _best_level_time(level, "broadcast", max_g, s * n, pen))
    # flat single-axis fallback (what the Communicator executes for
    # the remaining primitives): all n ranks on whichever fabric is
    # slower - cross-group hops physically ride the parent fabric.
    return max(_best_level_time(level, primitive, n, s, pen),
               _best_level_time(p, primitive, n, s, pen))


def _run_call_time(levels_sizes: Sequence[tuple], primitive: str,
                   msg_bytes: int,
                   parents: Optional[dict] = None,
                   penalties: Optional[dict] = None) -> float:
    """Predicted wire time of one collective on a run of levels
    (outermost first).  Single-level runs dispatch directly (ragged
    levels via the grouped decomposition); multi-level runs price the
    hierarchical decomposition the Communicator lowers tuple axes to.
    """
    s = max(1, int(msg_bytes))
    pen = penalties
    if primitive == "p2p":
        # the ring hop moves the full payload over exactly one link per
        # tick: a split or grouped axis is gated by the slowest boundary
        # a neighbor pair crosses, never the sum of the fabrics
        times = []
        for lv, n in levels_sizes:
            t = _best_level_time(lv, "p2p", n, s, pen)
            if lv.grouped:
                parent = (parents or {}).get(lv.axis) or lv
                t = max(t, _best_level_time(parent, "p2p", 2, s, pen))
            times.append(t)
        return max(times)
    if len(levels_sizes) == 1:
        level, n = levels_sizes[0]
        if level.grouped:
            parent = (parents or {}).get(level.axis)
            return _ragged_call_time(level, parent, primitive, s, pen)
        return _best_level_time(level, primitive, n, s, pen)
    outer, n0 = levels_sizes[0]
    inner = list(levels_sizes[1:])
    prod_inner = 1
    for _, n in inner:
        prod_inner *= n
    if primitive == "all_reduce":
        # RS down the inner levels, AR across the outer on the shard,
        # AG back out (mc.hierarchical_all_reduce)
        t, seg = 0.0, float(s)
        for lv, n in reversed(inner):
            t += _best_level_time(lv, "reduce_scatter", n, int(seg), pen)
            seg /= n
        t += _best_level_time(outer, "all_reduce", n0, int(seg), pen)
        for lv, n in inner:
            t += _best_level_time(lv, "all_gather", n, int(seg), pen)
            seg *= n
        return t
    if primitive == "all_gather":
        # inner (minor) level first, payload grows level by level
        t, seg = 0.0, float(s)
        for lv, n in reversed(levels_sizes):
            t += _best_level_time(lv, "all_gather", n, int(seg), pen)
            seg *= n
        return t
    if primitive == "reduce_scatter":
        # outer level first, payload shrinks before the next fabric
        t, seg = 0.0, float(s)
        for lv, n in levels_sizes:
            t += _best_level_time(lv, "reduce_scatter", n, int(seg), pen)
            seg /= n
        return t
    if primitive == "broadcast":
        # scatter in the root's inner group, cross-outer broadcast of
        # the 1/prod(inner) pieces, allgather within every inner group
        t = 0.0
        for lv, n in inner:
            t += _best_level_time(lv, "scatter", n, s, pen)
        t += _best_level_time(outer, "broadcast", n0,
                              max(1, s // prod_inner), pen)
        for lv, n in inner:
            t += _best_level_time(lv, "all_gather", n,
                                  max(1, s // prod_inner), pen)
        return t
    # rooted recursion: full payload per level (conservative)
    return sum(_best_level_time(lv, primitive, n, s, pen)
               for lv, n in levels_sizes)


def _axis_time(traffic: AxisTraffic, levels_sizes: Sequence[tuple],
               parents: dict,
               penalties: Optional[dict] = None) -> float:
    """Predicted exposed seconds/step of one axis's traffic on a run."""
    total = 0.0
    for c in traffic.calls:
        wire = _run_call_time(levels_sizes, c.primitive, c.msg_bytes,
                              parents=parents, penalties=penalties)
        total += max(0.0, wire - max(0.0, c.overlap_s)) * c.calls
    return total


def predict_call_time(topology: Topology, axis: str, primitive: str,
                      msg_bytes: int,
                      penalties: Optional[dict] = None) -> float:
    """Public single-call pricing: predicted wire seconds of one
    collective over ``axis``'s level (ragged levels priced as the
    grouped decomposition the Communicator actually runs), with
    optional measured link penalties.  This is what the resilience
    layer uses to compare a survivor/failover schedule's step time
    against the healthy one without executing either."""
    lv = topology.level_for(axis)
    if lv is None:
        raise KeyError(f"no level for axis {axis!r}")
    parents = {lv.axis: topology.parent_of(lv.axis)}
    n = lv.size if lv.size is not None else 2
    return _run_call_time(((lv, n),), primitive, msg_bytes,
                          parents=parents, penalties=penalties)


# --------------------------------------------------------------------- #
# assignment enumeration
# --------------------------------------------------------------------- #

def _absorbed(levels: Sequence[Level], i: int) -> bool:
    """A level immediately followed by a grouped level is its virtual
    cross-group parent: it is consumed by the ragged decomposition and
    cannot carry a mesh axis of its own."""
    return i + 1 < len(levels) and levels[i + 1].grouped


def _run_feasible(levels: Sequence[Level], idxs: Sequence[int],
                  size: int) -> Optional[tuple]:
    """Level sizes for a run carrying an axis of ``size`` ranks, or
    None when infeasible.  Single-level runs accept an undeclared size
    (the mesh axis supplies it); multi-level runs need every level's
    size declared so the mesh factorization is unambiguous, and a
    grouped level never joins a multi-level run (it already spans two
    fabrics)."""
    run = [levels[i] for i in idxs]
    if len(run) == 1:
        lv = run[0]
        if lv.size is not None and lv.size != size:
            return None
        return ((lv, size),)
    if any(lv.grouped or lv.size is None for lv in run):
        return None
    prod = 1
    for lv in run:
        prod *= lv.size
    if prod != size:
        return None
    return tuple((lv, lv.size) for lv in run)


def _assignments(levels: Sequence[Level], axes: Sequence[AxisTraffic]):
    """Yield every assignment of axes to disjoint contiguous runs of
    placeable levels (unused levels allowed), as tuples of
    ``(AxisTraffic, level index tuple)`` ordered outermost first."""
    placeable = [i for i in range(len(levels))
                 if not _absorbed(levels, i)]

    def rec(pos, remaining, acc):
        if not remaining:
            yield tuple(acc)
            return
        if pos >= len(placeable):
            return
        # leave this level unused
        yield from rec(pos + 1, remaining, acc)
        # or start a run here for one of the remaining axes
        for k, a in enumerate(remaining):
            for run_len in range(1, len(placeable) - pos + 1):
                idxs = placeable[pos:pos + run_len]
                if idxs != list(range(idxs[0], idxs[0] + run_len)):
                    break   # runs must be adjacent levels
                sizes = _run_feasible(levels, idxs, a.size)
                if sizes is None:
                    continue
                acc.append((a, tuple(idxs)))
                yield from rec(pos + run_len,
                               remaining[:k] + remaining[k + 1:], acc)
                acc.pop()

    yield from rec(0, tuple(axes), [])


# --------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Placement:
    """One scored axis->level assignment.  ``assignment`` is ordered
    outermost level first: ``((axis name, (level axis, ...)), ...)``;
    a multi-level entry is an axis split across adjacent levels."""

    assignment: tuple
    predicted_exposed_s: float
    per_axis_s: tuple      # ((axis name, seconds), ...)

    def levels_for(self, axis: str) -> Optional[tuple]:
        for name, levels in self.assignment:
            if name == axis:
                return levels
        return None

    @property
    def split_axes(self) -> tuple:
        return tuple(name for name, levels in self.assignment
                     if len(levels) > 1)

    def describe(self) -> str:
        return ", ".join(f"{name}->{'+'.join(levels)}"
                         for name, levels in self.assignment)

    def to_json(self) -> dict:
        return {"assignment": [{"axis": n, "levels": list(ls)}
                               for n, ls in self.assignment],
                "predicted_exposed_s": self.predicted_exposed_s,
                "per_axis_s": {n: t for n, t in self.per_axis_s}}

    @classmethod
    def from_json(cls, doc: dict) -> "Placement":
        return cls(
            assignment=tuple((e["axis"], tuple(e["levels"]))
                             for e in doc["assignment"]),
            predicted_exposed_s=float(doc["predicted_exposed_s"]),
            per_axis_s=tuple(sorted(doc.get("per_axis_s", {}).items())))


@dataclasses.dataclass
class PlacementPlan:
    """Ranked placements (ascending predicted exposed step time) for
    one (collective mix, topology) pair - the placement analog of the
    tuner's ``Plan``."""

    topology: Topology
    ranked: tuple           # of Placement, best first
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def best(self) -> Placement:
        return self.ranked[0]

    def best_with_unsplit(self, axes: Sequence[str]) -> Placement:
        """Best placement that keeps every axis in ``axes`` on a single
        level - what launchers apply when an axis's collectives cannot
        span a tuple axis (e.g. in-row TP AllReduces).  Raises
        ``ValueError`` when every feasible assignment splits one of
        them: applying a split placement anyway would build a mesh
        without the axis the model expects."""
        for p in self.ranked:
            if all(len(p.levels_for(a) or ("x",)) == 1 for a in axes):
                return p
        raise ValueError(
            f"every feasible placement splits one of {tuple(axes)} "
            f"across levels (candidates: "
            f"{[p.describe() for p in self.ranked[:5]]}); declare a "
            f"level whose size matches the axis degree, or change the "
            f"mesh degrees")

    def find(self, assignment: dict) -> Optional[Placement]:
        """The ranked entry matching ``{axis: (level, ...)}`` (levels a
        name or tuple of names), e.g. the hand-tuned assignment a
        benchmark compares against."""
        want = {a: (ls,) if isinstance(ls, str) else tuple(ls)
                for a, ls in assignment.items()}
        for p in self.ranked:
            if dict(p.assignment) == want:
                return p
        return None

    def to_json(self) -> dict:
        return {"topology": self.topology.to_json(),
                "topology_fingerprint": self.topology.fingerprint(),
                "meta": self.meta,
                "ranked": [p.to_json() for p in self.ranked]}

    @classmethod
    def from_json(cls, doc: dict) -> "PlacementPlan":
        return cls(topology=Topology.from_json(doc["topology"]),
                   ranked=tuple(Placement.from_json(p)
                                for p in doc["ranked"]),
                   meta=dict(doc.get("meta", {})))


def save_placement(plan: PlacementPlan, path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(plan.to_json(), f, indent=1, sort_keys=True)


def load_placement(path: str) -> PlacementPlan:
    with open(path) as f:
        return PlacementPlan.from_json(json.load(f))


def plan_placement(mix: CollectiveMix, topology: Topology, *,
                   top_k: Optional[int] = None,
                   link_penalties: Optional[dict] = None
                   ) -> PlacementPlan:
    """Enumerate and rank every feasible axis->level assignment.

    Each candidate is priced per axis with the tuner's per-level
    oracles: a single-level run at the axis's degree, a multi-level
    run as the hierarchical decomposition the Communicator lowers
    tuple axes to, and a ragged level as its grouped decomposition
    (cross-group sub-root traffic on the parent level's fabric).
    ``link_penalties`` ("axis/fabric" or bare fabric -> measured
    slowdown multiplier, e.g. from ``tuner.runtime.get_link_health``)
    re-ranks candidates against the fabric as it measures *now*: a
    degraded pool loses its cells to the level's IB alternative or to
    another level entirely.  Raises ``ValueError`` when no assignment
    fits (axis degrees vs declared level sizes).
    """
    levels = topology.levels
    parents = {lv.axis: topology.parent_of(lv.axis) for lv in levels}
    # size-1 axes carry no traffic and need no fabric level; the mesh
    # still gets them (innermost) via mesh_spec
    place_axes = tuple(a for a in mix.axes if a.size > 1)
    scored = []
    seen = set()
    for assign in _assignments(levels, place_axes):
        key = tuple(sorted((a.axis, idxs) for a, idxs in assign))
        if key in seen:
            continue
        seen.add(key)
        per_axis = []
        total = 0.0
        for a, idxs in assign:
            sizes = _run_feasible(levels, idxs, a.size)
            t = _axis_time(a, sizes, parents, penalties=link_penalties)
            per_axis.append((a.axis, t))
            total += t
        ordered = sorted(assign, key=lambda e: e[1][0])
        scored.append(Placement(
            assignment=tuple((a.axis,
                              tuple(levels[i].axis for i in idxs))
                             for a, idxs in ordered),
            predicted_exposed_s=total,
            per_axis_s=tuple(sorted(per_axis))))
    if not scored:
        raise ValueError(
            f"no feasible axis->level assignment: axes "
            f"{[(a.axis, a.size) for a in mix.axes]} vs levels "
            f"{[(lv.axis, lv.size) for lv in levels]}")
    scored.sort(key=lambda p: (p.predicted_exposed_s, p.describe()))
    if top_k is not None:
        scored = scored[:top_k]
    return PlacementPlan(
        topology=topology, ranked=tuple(scored),
        meta={"axes": {a.axis: a.size for a in mix.axes},
              "bytes_per_step": {a.axis: a.bytes_per_step
                                 for a in mix.axes},
              **({"link_penalties": {k: float(v) for k, v
                                     in link_penalties.items()}}
                 if link_penalties else {})})


# --------------------------------------------------------------------- #
# applying a placement
# --------------------------------------------------------------------- #

def placed_topology(placement: Placement,
                    topology: Topology) -> Topology:
    """Relabel the assigned levels with the logical axis names so the
    runtime decomposes the placed mesh against them.  Split axes keep
    the physical level names (the mesh carries one axis per level,
    bridged by the ``models.sharding`` aliases); absorbed cross-group
    parents and unused levels keep their names too.  Because topology
    fingerprints ignore axis names, a plan tuned against the physical
    topology still matches the relabeled one."""
    renames = {}
    for axis, level_names in placement.assignment:
        if len(level_names) == 1:
            renames[level_names[0]] = axis
    new = tuple(dataclasses.replace(lv, axis=renames.get(lv.axis,
                                                         lv.axis))
                for lv in topology.levels)
    return Topology(levels=new)


def mesh_spec(placement: Placement, mix: CollectiveMix,
              topology: Topology) -> tuple:
    """(axis sizes, axis names, aliases) for ``jax.make_mesh``, ordered
    outermost level first.  Single-level axes keep their logical name;
    a split axis contributes one mesh axis per level (named after the
    level) plus an alias ``logical -> (level, ...)`` for
    ``models.sharding.set_axis_aliases``.  A ragged level's axis spans
    ``sum(shape)`` ranks flat."""
    shape, names = [], []
    aliases = {}
    for axis, level_names in placement.assignment:
        traffic = mix.axis(axis)
        if len(level_names) == 1:
            names.append(axis)
            shape.append(traffic.size)
        else:
            aliases[axis] = tuple(level_names)
            for ln in level_names:
                lv = topology.level_for(ln)
                names.append(ln)
                shape.append(lv.size)
    # traffic-free size-1 axes ride innermost so model code still finds
    # its named axes in the mesh
    placed = {n for n, _ in placement.assignment}
    for a in mix.axes:
        if a.axis not in placed:
            names.append(a.axis)
            shape.append(a.size)
    return tuple(shape), tuple(names), aliases


def format_report(plan: PlacementPlan, top: int = 5,
                  chosen: Optional[Placement] = None) -> str:
    """Human-readable ranked table for launcher/CLI output.  ``chosen``
    marks the placement the caller actually applies (launchers pick
    ``best_with_unsplit``, which is not always rank #0); default: the
    top-ranked one."""
    chosen = chosen if chosen is not None else plan.ranked[0]
    lines = ["placement  (predicted exposed comm s/step, best first)"]
    shown = False
    for i, p in enumerate(plan.ranked[:top]):
        mark = " <- chosen" if p == chosen else ""
        shown = shown or bool(mark)
        per = ", ".join(f"{a}={t:.3e}" for a, t in p.per_axis_s)
        lines.append(f"  #{i} {p.describe():40s} "
                     f"{p.predicted_exposed_s:.3e}s  [{per}]{mark}")
    if len(plan.ranked) > top:
        lines.append(f"  ... {len(plan.ranked) - top} more candidates")
    if not shown:
        lines.append(f"  chosen (below top {top}): {chosen.describe()}")
    return "\n".join(lines)
