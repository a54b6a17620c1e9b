"""Speed-of-light roofline accounting: attained against attainable rate per
stage (mythril_tpu.observe.roofline on the port's sources).

build(stats) assembles the "roofline" section of the stats JSON from
three sources:

  SolverStatistics   settle work/wall (cdcl_clauses / settle_wall), the
                     fork epilogue's rows/wall, and the solver-wall timers
                     for the decomposition.
  device backend     pack, ship, ragged and kernel work and busy seconds
                     (gpu/backend.py stats(): pack_bytes, ship_bytes,
                     paged_stream_bytes, cells_stepped against pack,
                     ship, ragged and solve seconds).
  router rates       ceilings from the router's calibration
                     (gpu/router.attainable_rates: kernel_cells_s for K1,
                     pack_bytes_s, ragged_bytes_s, settle_clauses_s).
                     The calibration measures no ship rate, so the ship
                     stage reports attained with no ceiling, as does any
                     stage when the router never calibrated.

Each stage row carries `sol_gap_s`, the seconds the stage would get back
at its attainable rate (busy_s - work/attainable), the one unit
comparable across stages; top_gaps ranks them. Ceilings are cold-path
measurements on one small shape, so a warm stage can attain more than its
ceiling: that clamps to headroom 1.0 / sol_gap_s 0.0. The wall
decomposition reconciles by construction: the measured components
(prepare / settle / crosscheck / device) plus the `other_s` residual sum
to the solver wall, and `attributed_frac` says how much of it the named
components explain.

Everything here reads counters already collected. It launches nothing,
synchronizes nothing and never raises: build() degrades to an
empty-ceiling report on any internal error.
"""

import logging
from typing import Optional

log = logging.getLogger(__name__)

# the stages with measured work, busy wall and (where calibrated) a
# ceiling; "ragged" is the flat-stream assembly + upload of the ragged
# dispatch (circuit.RaggedStream, ragged_kernel.device_flat)
STAGES = ("pack", "ship", "ragged", "kernel", "settle", "frontier.fork")

_UNITS = {
    "pack": "bytes/s",
    "ship": "bytes/s",
    "ragged": "bytes/s",
    "kernel": "cells/s",
    "settle": "clauses/s",
    # rows forked batch-wise per second of fork-epilogue wall; no
    # calibrated ceiling, so top_gaps ranks it last
    "frontier.fork": "rows/s",
}


def _stage_row(work, busy_s: float, attainable: Optional[float],
               units: str) -> dict:
    attained = (work / busy_s) if busy_s else 0.0
    row = {
        "units": units,
        "work": int(work),
        "busy_s": round(busy_s, 4),
        "attained": round(attained, 2),
        "attainable": round(attainable, 2) if attainable else None,
    }
    if attainable and busy_s:
        row["sol_gap_s"] = round(max(busy_s - work / attainable, 0.0), 4)
        row["headroom"] = round(min(attained / attainable, 1.0), 4)
    else:
        row["sol_gap_s"] = None
        row["headroom"] = None
    return row


def _router_rates() -> dict:
    from mythril_tpu_torch.gpu import router as router_mod

    if router_mod._router is None:
        return {}
    return router_mod._router.attainable_rates()


def build(stats) -> dict:
    """The stats-JSON "roofline" section for a SolverStatistics snapshot.
    Never raises: a telemetry report must not break the run it reports."""
    try:
        return _build(stats)
    except Exception:
        log.exception("roofline accounting failed; emitting empty report")
        return {
            "stages": {name: _stage_row(0, 0.0, None, _UNITS[name])
                       for name in STAGES},
            "wall": {"solver_total_s": 0.0},
        }


def _build(stats) -> dict:
    device = stats.device_stats()
    rates = _router_rates()

    stages = {
        "pack": _stage_row(
            device.get("pack_bytes", 0),
            device.get("pack_seconds", 0.0),
            rates.get("pack_bytes_s"),
            _UNITS["pack"]),
        "ship": _stage_row(
            device.get("ship_bytes", 0),
            device.get("ship_seconds", 0.0),
            rates.get("ship_bytes_s"),
            _UNITS["ship"]),
        "ragged": _stage_row(
            device.get("paged_stream_bytes", 0),
            device.get("ragged_seconds", 0.0),
            rates.get("ragged_bytes_s"),
            _UNITS["ragged"]),
        "kernel": _stage_row(
            device.get("cells_stepped", 0),
            device.get("solve_seconds", 0.0),
            rates.get("kernel_cells_s"),
            _UNITS["kernel"]),
        "settle": _stage_row(
            stats.cdcl_clauses,
            stats.settle_wall,
            rates.get("settle_clauses_s"),
            _UNITS["settle"]),
        "frontier.fork": _stage_row(
            stats.frontier_fork_rows,
            stats.frontier_fork_wall,
            None,
            _UNITS["frontier.fork"]),
    }

    total = stats.solver_time
    prepare = stats.prepare_wall
    settle = stats.settle_wall
    crosscheck = stats.crosscheck_wall
    device_s = stats.route_device_seconds
    attributed = prepare + settle + crosscheck + device_s
    wall = {
        # named components + other_s == solver_total_s (other_s: cache
        # probes, memo lookups, marshalling, measured as the residual)
        "solver_total_s": round(total, 4),
        "prepare_s": round(prepare, 4),
        "settle_s": round(settle, 4),
        "crosscheck_s": round(crosscheck, 4),
        "device_s": round(device_s, 4),
        "other_s": round(max(total - attributed, 0.0), 4),
        "attributed_frac": round(min(attributed / total, 1.0), 4)
        if total else 1.0,
        # the engine-side counterpart, outside the solver wall
        "interp_s": round(stats.interp_wall, 4),
    }
    return {"stages": stages, "wall": wall}


def top_gaps(roofline: dict, n: int = 3) -> list:
    """Top-`n` stages by sol_gap_s (descending) of a built roofline
    section. Stages without a ceiling rank last: gap unknown is not gap
    zero."""
    stages = (roofline or {}).get("stages", {})
    ranked = sorted(
        stages.items(),
        key=lambda item: (item[1].get("sol_gap_s") is None,
                          -(item[1].get("sol_gap_s") or 0.0)),
    )
    return [
        {"stage": name,
         "sol_gap_s": row.get("sol_gap_s"),
         "attained": row.get("attained"),
         "attainable": row.get("attainable"),
         "units": row.get("units")}
        for name, row in ranked[:n]
    ]
