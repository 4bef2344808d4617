"""Autotuning plan subsystem (cost-model-driven backend selection).

Offline, ``generate_plan`` sweeps every (primitive, message size, axis
size, slicing factor, allreduce mode) cell through the pool simulator
and the IB alpha-beta model and records the predicted-fastest choice;
with a ``core.topology.Topology`` the sweep runs once per level.
Online, ``Communicator(backend="auto")`` consults the plan at every
collective call and the ledger audits every decision taken::

    python -m repro_torch.launch.tune --nranks 4 --out plan.json
    python -m repro_torch.launch.train --arch llama3.2-1b --mesh 4x1 \\
        --backend auto --plan plan.json

``tuner.placement`` chooses the mesh-axis -> fabric-level assignment:
``plan_placement(CollectiveMix, Topology)`` ranks every feasible
assignment (axis splits across adjacent levels, grouped shape-vector
levels priced by their grouped decomposition) by predicted exposed step
time; ``train --placement auto`` applies the winner, and ``tune
--placement-report`` embeds the ranked table in the plan's metadata
(``Plan.placement()`` reads it back).

``tuner.online`` folds measured per-call times back into a plan
(``OnlineTuner``; ``train --online-retune`` hot-swaps the refreshed plan
through the epoch-versioned registry, ``tune --measurements`` folds a
run's samples offline).  Ported from ``repro.tuner``.
"""
from repro_torch.tuner.costmodel import (cache_clear, epilogue_flops,
                                         fused_window, ici_time,
                                         predict_exposed_time,
                                         predict_level_p2p_time,
                                         predict_level_time,
                                         predict_p2p_time, predict_time,
                                         roofline_compute_time)
from repro_torch.tuner.online import (OnlineTuner, choices_changed,
                                      fold_measurements)
from repro_torch.tuner.placement import (AxisTraffic, CollectiveCall,
                                         CollectiveMix, Placement,
                                         PlacementPlan, format_report,
                                         load_placement, mesh_spec,
                                         placed_topology, plan_placement,
                                         predict_call_time, save_placement)
from repro_torch.tuner.plan import (PLAN_VERSION, Choice, Plan,
                                    PlanVersionError, hardware_fingerprint,
                                    load_plan, save_plan, size_bucket)
from repro_torch.tuner.runtime import (activate_plan_file,
                                       clear_active_plan, default_plan_path,
                                       ensure_default_plan, get_active_plan,
                                       get_active_plan_versioned,
                                       plan_cache_dir, plan_epoch,
                                       set_active_plan)
from repro_torch.tuner.sweep import (DEFAULT_GRID, SMOKE_GRID, TuneGrid,
                                     generate_plan,
                                     overlap_windows_from_dryrun)

__all__ = [
    "Choice", "Plan", "PlanVersionError", "PLAN_VERSION", "TuneGrid",
    "DEFAULT_GRID", "SMOKE_GRID",
    "predict_time", "predict_exposed_time", "predict_level_time",
    "predict_p2p_time", "predict_level_p2p_time", "ici_time",
    "roofline_compute_time", "epilogue_flops", "fused_window",
    "cache_clear",
    "generate_plan", "overlap_windows_from_dryrun",
    "AxisTraffic", "CollectiveCall", "CollectiveMix", "Placement",
    "PlacementPlan", "format_report", "load_placement", "mesh_spec",
    "placed_topology", "plan_placement", "predict_call_time",
    "save_placement",
    "hardware_fingerprint", "size_bucket", "load_plan", "save_plan",
    "activate_plan_file", "clear_active_plan", "default_plan_path",
    "ensure_default_plan", "get_active_plan", "get_active_plan_versioned",
    "plan_cache_dir", "plan_epoch", "set_active_plan",
    "OnlineTuner", "choices_changed", "fold_measurements",
]
