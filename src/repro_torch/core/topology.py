"""First-class cluster topology: ordered axis levels, one fabric each.

The paper expects a single CXL pool to span only a handful of nodes
(Sec. 5.3), so a production deployment is necessarily hierarchical:
rack-scale CXL pools stitched together over IB/Ethernet, with an
intra-node ring (ICI/NVLink-class) underneath.  A ``Topology`` makes
that explicit instead of letting one global ``CXLPoolConfig`` price
every level:

* each mesh axis binds to a ``Level`` with a fabric kind - ``cxl``
  (its own ``CXLPoolConfig`` + the IB config of the alternative
  transport the tuner compares against), ``ib`` (its own
  ``InfiniBandConfig``) or ``ici`` (its own ``ICIConfig``);
* levels are ordered outermost first, matching the repo's tuple-axis
  convention (``("pod", "node", "gpu")`` = rank-major, pod most
  significant);
* every level has a stable ``fingerprint()`` (hash of fabric kind +
  config + shape) so tuner plan cells can be keyed by (level, fabric)
  and a plan tuned for one fabric never silently drives another;
* a level may carry a **shape vector** instead of a single radix
  (``shape=(4, 2)``: the first outer group spans 4 ranks, the second
  2).  Irregular (mixed fan-out) levels cannot be a regular mesh axis
  of their own; they live on one *flat* mesh axis of ``sum(shape)``
  ranks, and the Communicator decomposes collectives over that axis
  into within-group schedules on this level's fabric plus a sub-root
  exchange on the *parent* level's fabric
  (``core.mesh_collectives`` grouped/ragged schedules).

Spec formats (CLI ``--topology`` accepts either):

* compact string: ``"pod:ib,node:cxl,gpu:ici"``; an optional third
  field declares the level shape - ``"node:cxl:4+2"`` (irregular
  fan-out) or ``"gpu:ici:8"`` (declared size, single group);
* JSON file: ``{"levels": [{"axis": "pod", "fabric": "ib",
  "ib": {"link_bw": 5e10}}, {"axis": "node", "fabric": "cxl",
  "shape": [4, 2]}, ...]}`` where the per-fabric objects
  override individual ``hw`` dataclass fields.

The process-wide active topology (``set_active_topology``) is what a
``Communicator`` resolves its axes against, so one activation reaches
every collective of the process.

Copied from ``repro.core.topology`` (framework-free).  Two changes: an
``ici`` level defaults to the port's NVLink-class ``hw.ICI`` instead of
the reference's chip-to-chip links, and :func:`warn_uncovered` takes
the mesh's axis sizes by name instead of a JAX mesh.  Level and
topology fingerprints hash the configs' fields, so a topology with an
``ici`` level fingerprints differently in the two packages unless the
same ``ICIConfig`` values are given.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import Mapping, Optional, Sequence

from repro_torch.core.hw import (CXL_POOL, ICI, INFINIBAND, CXLPoolConfig,
                                 ICIConfig, InfiniBandConfig)

FABRICS = ("cxl", "ib", "ici")


def _cfg_fingerprint(tag: str, cfg) -> str:
    blob = json.dumps({tag: dataclasses.asdict(cfg)}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class Level:
    """One axis of the hierarchy bound to the fabric that carries it."""

    axis: str
    fabric: str = "cxl"
    # Per-level hardware overrides; None = the repo-wide defaults.
    pool: Optional[CXLPoolConfig] = None   # cxl levels
    ib: Optional[InfiniBandConfig] = None  # ib levels; also the
    #                                        alternative transport the
    #                                        tuner prices cxl against
    ici: Optional[ICIConfig] = None        # ici levels
    # Shape vector: per-outer-group fan-out of this level.  None means
    # the level is regular with its size taken from the mesh axis;
    # ``(6,)`` declares the size (one group of 6); ``(4, 2)`` declares
    # an irregular level - two groups under the parent level, one of 4
    # ranks and one of 2, carried by a single flat mesh axis of 6.
    shape: Optional[tuple] = None

    def __post_init__(self):
        if self.fabric not in FABRICS:
            raise ValueError(
                f"level {self.axis!r}: fabric must be one of {FABRICS}, "
                f"got {self.fabric!r}")
        if self.shape is not None:
            shape = tuple(int(g) for g in self.shape)
            if not shape or any(g < 1 for g in shape):
                raise ValueError(
                    f"level {self.axis!r}: shape must be a non-empty "
                    f"vector of positive group sizes, got {self.shape!r}")
            object.__setattr__(self, "shape", shape)

    @property
    def size(self) -> Optional[int]:
        """Total ranks this level spans (None when undeclared)."""
        return sum(self.shape) if self.shape is not None else None

    @property
    def grouped(self) -> bool:
        """True when the level decomposes a flat mesh axis into more
        than one rank group (the ragged/hierarchical-on-one-axis case)."""
        return self.shape is not None and len(self.shape) > 1

    @property
    def irregular(self) -> bool:
        """True when the level's groups have mixed fan-out."""
        return self.grouped and len(set(self.shape)) > 1

    @property
    def pool_cfg(self) -> CXLPoolConfig:
        return self.pool if self.pool is not None else CXL_POOL

    @property
    def ib_cfg(self) -> InfiniBandConfig:
        return self.ib if self.ib is not None else INFINIBAND

    @property
    def ici_cfg(self) -> ICIConfig:
        return self.ici if self.ici is not None else ICI

    def backends(self) -> tuple:
        """Backends executable on this fabric: the pool schedule only
        exists where there is a pool."""
        return ("ring", "cxl") if self.fabric == "cxl" else ("ring",)

    def fingerprint(self) -> str:
        if self.fabric == "cxl":
            blob = (_cfg_fingerprint("pool", self.pool_cfg)
                    + _cfg_fingerprint("ib", self.ib_cfg))
        elif self.fabric == "ib":
            blob = _cfg_fingerprint("ib", self.ib_cfg)
        else:
            blob = _cfg_fingerprint("ici", self.ici_cfg)
        # The shape vector is part of the hardware identity: plan cells
        # tuned for a 4+2 level must not drive a 3+3 one.  Shapeless
        # levels keep their pre-shape fingerprints (old plans load).
        tag = self.fabric
        if self.shape is not None:
            tag += "[" + "+".join(str(g) for g in self.shape) + "]"
        return hashlib.sha256(
            (tag + ":" + blob).encode()).hexdigest()[:12]

    # -- serialization ----------------------------------------------------

    def to_json(self) -> dict:
        doc: dict = {"axis": self.axis, "fabric": self.fabric}
        if self.shape is not None:
            doc["shape"] = list(self.shape)
        for name in ("pool", "ib", "ici"):
            cfg = getattr(self, name)
            if cfg is not None:
                doc[name] = dataclasses.asdict(cfg)
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> "Level":
        kw: dict = {}
        if doc.get("shape") is not None:
            kw["shape"] = tuple(int(g) for g in doc["shape"])
        for name, klass in (("pool", CXLPoolConfig),
                            ("ib", InfiniBandConfig), ("ici", ICIConfig)):
            if doc.get(name) is not None:
                kw[name] = klass(**doc[name])
        return cls(axis=doc["axis"], fabric=doc.get("fabric", "cxl"),
                   **kw)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Ordered (outermost first) levels of the cluster hierarchy."""

    levels: tuple = ()

    def __post_init__(self):
        if not self.levels:
            raise ValueError("a Topology needs at least one level")
        object.__setattr__(self, "levels", tuple(self.levels))
        axes = [lv.axis for lv in self.levels]
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate axes in topology: {axes}")

    @property
    def axes(self) -> tuple:
        return tuple(lv.axis for lv in self.levels)

    def level_for(self, axis: str) -> Optional[Level]:
        for lv in self.levels:
            if lv.axis == axis:
                return lv
        return None

    def index_of(self, axis: str) -> int:
        for i, lv in enumerate(self.levels):
            if lv.axis == axis:
                return i
        raise KeyError(axis)

    def parent_of(self, axis: str) -> Optional[Level]:
        """The level immediately outside ``axis`` (None at the
        outermost).  For a grouped level this is the fabric the
        cross-group sub-root exchange rides - e.g. a ``node`` level
        with ``shape=(4, 2)`` under a ``pod:ib`` level sends its two
        pod sums across IB."""
        i = self.index_of(axis)
        return self.levels[i - 1] if i > 0 else None

    def covers(self, axes: Sequence[str]) -> bool:
        return all(self.level_for(a) is not None for a in axes)

    def level_key(self, axis: str) -> str:
        """Stable plan-cell key for a level: ``"<index>:<fabric fp>"``.
        The index pins the position in the hierarchy, the fingerprint
        pins the fabric hardware."""
        i = self.index_of(axis)
        return f"{i}:{self.levels[i].fingerprint()}"

    def fingerprint(self) -> str:
        """Hash of the ordered level fingerprints.  Deliberately
        *excludes* axis names: a placement relabels levels with the
        logical mesh axes it assigned to them (``tuner.placement``),
        and a plan tuned against the physical topology must keep
        matching the relabeled one - the hardware did not change.
        (Pre-PR-5 fingerprints hashed the axis names too, so plans
        cached by the old scheme regenerate once.)"""
        blob = "|".join(f"{i}={lv.fingerprint()}"
                        for i, lv in enumerate(self.levels))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- serialization ----------------------------------------------------

    def to_json(self) -> dict:
        return {"levels": [lv.to_json() for lv in self.levels]}

    @classmethod
    def from_json(cls, doc: dict) -> "Topology":
        return cls(levels=tuple(Level.from_json(d)
                                for d in doc["levels"]))


def parse_topology(spec: str) -> Topology:
    """Parse a CLI topology spec: a JSON file path or the compact
    ``"axis:fabric[:shape],..."`` string (outermost level first).
    The optional shape field is ``+``-separated group sizes:
    ``"node:cxl:4+2"`` declares an irregular level of two groups
    (4 and 2 ranks), ``"gpu:ici:8"`` just declares the size."""
    if os.path.exists(spec) or spec.endswith(".json"):
        with open(spec) as f:
            return Topology.from_json(json.load(f))
    levels = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = [p.strip() for p in part.split(":")]
        axis = fields[0]
        fabric = fields[1] if len(fields) > 1 and fields[1] else "cxl"
        shape = None
        if len(fields) > 2 and fields[2]:
            shape = tuple(int(g) for g in fields[2].split("+"))
        levels.append(Level(axis=axis, fabric=fabric, shape=shape))
    return Topology(levels=tuple(levels))


def save_topology(topo: Topology, path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(topo.to_json(), f, indent=1, sort_keys=True)


def default_topology(axis_names: Sequence[str]) -> Topology:
    """The production default for a mesh: the outermost axis rides IB
    across pods, intermediate axes ride rack-scale CXL pools, and the
    innermost axis is the intra-node ring."""
    names = list(axis_names)
    levels = []
    for i, a in enumerate(names):
        if len(names) == 1:
            fabric = "cxl"                     # the paper's base case
        elif i == len(names) - 1:
            fabric = "ici"
        elif i == 0 and len(names) >= 3:
            fabric = "ib"
        else:
            fabric = "cxl"
        levels.append(Level(axis=a, fabric=fabric))
    return Topology(levels=tuple(levels))


def warn_uncovered(topo: Topology, axis_sizes: Mapping[str, int]) -> tuple:
    """Warn when mesh axes (of size > 1; ``axis_sizes`` maps each axis
    name of the mesh to its size) have no topology level: their
    collectives silently resolve untuned (ring baseline), which is
    almost always a topology spec whose axis names don't match the
    mesh (e.g. tuning ``node``/``gpu`` while the mesh says
    ``data``/``model``).  Returns the uncovered axes."""
    missing = tuple(a for a, n in axis_sizes.items()
                    if n > 1 and topo.level_for(a) is None)
    if missing:
        warnings.warn(
            f"mesh axes {missing} are not covered by the active "
            f"topology (levels: {topo.axes}); collectives over them "
            f"fall back to the untuned flat path - check the "
            f"--topology axis names against the mesh")
    return missing


# -- process-wide active topology -----------------------------------------
# Mirrors the tuner's active-plan registry: ``tuner.activate_plan_file``
# activates a plan's topology, and every Communicator resolves the axes
# it covers against that topology's levels.

_ACTIVE: list = [None]


def set_active_topology(topo: Optional[Topology]) -> None:
    _ACTIVE[0] = topo


def get_active_topology() -> Optional[Topology]:
    return _ACTIVE[0]


def clear_active_topology() -> None:
    _ACTIVE[0] = None
