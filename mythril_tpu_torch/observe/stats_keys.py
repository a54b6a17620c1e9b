"""Lint: every SolverStatistics counter reaches everything that reads the
port's telemetry (the JAX package's tools/check_stats_keys.py, on the
port).

    python -m mythril_tpu_torch.observe.stats_keys

Four invariants, numbered as in the JAX package's lint:

  1. every counter and timer of SolverStatistics._COUNTERS/_TIMERS is in
     the MYTHRIL_GPU_STATS_JSON emission (as_dict());
  4. as_dict() emits a "roofline" section whose stage set equals
     observe.roofline.STAGES, and the "trace_spans" span summary;
  6. no orphan instruments: every instrument of the live registry
     (observe/metrics.REGISTRY) reaches the heartbeat snapshot
     (metrics.snapshot()), every stats-sourced one reaches as_dict(), and
     every SolverStatistics counter and timer is a registered instrument;
  7. the autotune loop's telemetry: every counter of tune.TUNE_COUNTERS is
     a SolverStatistics field in as_dict(), and both as_dict() and the
     heartbeat snapshot carry the "knobs" stamp with every registered
     knob (tune/space.py).

The JAX package's invariants 2, 3 and 5 hold the counters against its
benchmark's roll-up, which the port does not have yet.

Exits 1 listing the violations, 0 otherwise.
"""

import sys
from typing import List


def violations() -> List[str]:
    from mythril_tpu_torch.observe import metrics, roofline
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    fields = tuple(SolverStatistics._COUNTERS) + tuple(
        SolverStatistics._TIMERS)
    emitted_dict = SolverStatistics().as_dict()
    emitted = set(emitted_dict)
    failures = []

    missing = sorted(set(fields) - emitted)
    if missing:
        failures.append("missing from the MYTHRIL_GPU_STATS_JSON emission "
                        "(as_dict): " + ", ".join(missing))

    section = emitted_dict.get("roofline")
    if not isinstance(section, dict):
        failures.append("as_dict() does not emit the \"roofline\" section")
    else:
        stages = set(section.get("stages", {}))
        if stages != set(roofline.STAGES):
            failures.append(
                f"roofline stages emitted by as_dict() ({sorted(stages)}) "
                f"do not match observe.roofline.STAGES "
                f"({sorted(roofline.STAGES)})")
    if "trace_spans" not in emitted_dict:
        failures.append(
            "as_dict() does not emit the \"trace_spans\" span summary")

    snap = metrics.snapshot()
    for instrument in metrics.REGISTRY:
        if not metrics.snapshot_covers(instrument, snap):
            failures.append(
                f"registered instrument {instrument.name!r} "
                f"({instrument.kind}) missing from the heartbeat snapshot "
                "(metrics.snapshot())")
        if instrument.source == "stats" and instrument.name not in emitted:
            failures.append(
                f"registered instrument {instrument.name!r} missing from "
                "the MYTHRIL_GPU_STATS_JSON emission (as_dict)")
    from mythril_tpu_torch.tune import TUNE_COUNTERS
    from mythril_tpu_torch.tune import space as tune_space

    for name in TUNE_COUNTERS:
        if name not in fields or name not in emitted:
            failures.append(
                f"tune counter {name!r} is not a SolverStatistics field "
                "emitted in the stats JSON (as_dict)")
    for section_name, section in (("as_dict()", emitted_dict.get("knobs")),
                                  ("metrics.snapshot()", snap.get("knobs"))):
        if not isinstance(section, dict):
            failures.append(f"{section_name} does not emit the \"knobs\" "
                            "configuration stamp")
            continue
        absent = sorted(set(tune_space.knob_names()) - set(section))
        if absent:
            failures.append(f"{section_name} \"knobs\" stamp is missing "
                            "registered knobs: " + ", ".join(absent))
    registered = {instrument.name for instrument in metrics.REGISTRY}
    unregistered = sorted(set(fields) - registered)
    if unregistered:
        failures.append(
            "SolverStatistics fields not registered as live-metrics "
            "instruments (observe/metrics.REGISTRY): "
            + ", ".join(unregistered))
    return failures


def main() -> int:
    failures = violations()
    if failures:
        print("FAIL: SolverStatistics telemetry is not fully emitted:",
              file=sys.stderr)
        for failure in failures:
            print(f"  {failure}", file=sys.stderr)
        return 1
    from mythril_tpu_torch.observe import metrics
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    fields = len(SolverStatistics._COUNTERS) + len(SolverStatistics._TIMERS)
    print(f"ok: {fields} SolverStatistics fields and "
          f"{len(metrics.REGISTRY)} registered instruments, all emitted in "
          "the stats JSON and the heartbeat snapshot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
