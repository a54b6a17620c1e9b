"""Lint: the port's fault-site registry stays load-bearing (the JAX
package's tools/check_fault_sites.py, on the port).

    python -m mythril_tpu_torch.resilience.lint [repo_root]

Invariants, numbered as in the JAX package's lint:

  1. the registry is structurally valid (registry.validate());
  2. every registered site is WIRED: its name appears in a
     maybe_inject("<site>"), corrupt_text("<site>" or
     run_with_deadline("<site>" crossing under mythril_tpu_torch/;
  3. every registered site is EXERCISED: its name appears in
     tests/test_torch_chaos.py, tests/test_torch_resilience.py,
     tests/test_torch_chaos_serve.py or tests/test_torch_fleet.py (the
     fleet sites cross processes, so their cases live with the fleet's);
  4. every crossing in the code names a REGISTERED site;
  5. every resilience event counter rolls up: each counter of
     SolverStatistics._RESILIENCE_EVENT_COUNTERS is a _COUNTERS member and
     is in the as_dict() emission; as_dict() emits the "resilience"
     section with every registered site; every literal
     record_event(site, event) uses a known event name;
  6. the flight recorder stays wired to the fault plane: its trigger
     events are known resilience events, resilience.record_event calls
     flightrec.notify, and core.fire_lasers' finally calls
     notify_run_incomplete.

Sites in registry.NOT_PORTED (their surface is not ported yet) are exempt
from 2 and 3, and only from those. Invariant 5's benchmark roll-up row
waits for the port's benchmark.

Exits 1 listing the violations, 0 otherwise.
"""

import os
import re
import sys
from typing import List, Optional

# any registered-site crossing the code can make: injection hooks, the
# data-path corrupt hook, and the hard-deadline runner
_CROSSING_RE = re.compile(
    r'(?:maybe_inject|corrupt_text|run_with_deadline)\(\s*"([a-z_.]+)"')
_EVENT_RE = re.compile(r'record_event\(\s*"([a-z_.]+)",\s*"([a-z_]+)"')
CHAOS_TESTS = ("test_torch_chaos.py", "test_torch_resilience.py",
               "test_torch_chaos_serve.py", "test_torch_fleet.py")

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python_files(root: str):
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as fd:
        return fd.read()


def violations(repo_root: Optional[str] = None) -> List[str]:
    from mythril_tpu_torch.observe import flightrec
    from mythril_tpu_torch.resilience import registry
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    repo_root = repo_root or os.path.dirname(_PACKAGE_ROOT)
    failures = []
    exempt = set(registry.NOT_PORTED)

    # 1. structural validity
    try:
        registry.validate()
    except AssertionError as error:
        failures.append(f"registry invalid: {error}")

    # 2./4. wiring: crossings in the package against the registry
    crossings = {}
    events_used = set()
    resilience_dir = os.path.join(_PACKAGE_ROOT, "resilience") + os.sep
    for path in _python_files(_PACKAGE_ROOT):
        if path.startswith(resilience_dir):
            continue  # the framework itself, not a wired stage
        text = _read(path)
        for site in _CROSSING_RE.findall(text):
            crossings.setdefault(site, []).append(
                os.path.relpath(path, repo_root))
        events_used.update(_EVENT_RE.findall(text))
    unwired = sorted(set(registry.FAULT_SITES) - set(crossings) - exempt)
    if unwired:
        failures.append(
            "registered fault sites never crossed under mythril_tpu_torch/ "
            "(no maybe_inject/corrupt_text/run_with_deadline): "
            + ", ".join(unwired))
    orphans = sorted(set(crossings) - set(registry.FAULT_SITES))
    if orphans:
        failures.append(
            "code crosses UNREGISTERED fault sites: " + ", ".join(
                f"{site} ({crossings[site][0]})" for site in orphans))

    # 3. chaos coverage: every site named in the port's chaos suite
    tested = set()
    for name in CHAOS_TESTS:
        path = os.path.join(repo_root, "tests", name)
        if os.path.isfile(path):
            text = _read(path)
            tested.update(site for site in registry.FAULT_SITES
                          if f'"{site}"' in text)
    untested = sorted(set(registry.FAULT_SITES) - tested - exempt)
    if untested:
        failures.append(
            "registered fault sites no chaos test names (tests/"
            + " / tests/".join(CHAOS_TESTS) + "): " + ", ".join(untested))

    # 5. counter roll-up
    event_counters = SolverStatistics._RESILIENCE_EVENT_COUNTERS
    counters = set(SolverStatistics._COUNTERS)
    emitted = SolverStatistics().as_dict()
    for event, counter in sorted(event_counters.items()):
        if counter not in counters:
            failures.append(
                f"resilience event {event!r} rolls up into {counter!r}, "
                "which is not a SolverStatistics._COUNTERS member")
        if counter not in emitted:
            failures.append(
                f"resilience counter {counter!r} missing from the "
                "MYTHRIL_GPU_STATS_JSON emission (as_dict)")
    section = emitted.get("resilience")
    if not isinstance(section, dict) or "sites" not in section:
        failures.append('as_dict() does not emit the "resilience" section')
    else:
        missing = sorted(set(registry.FAULT_SITES) - set(section["sites"]))
        if missing:
            failures.append(
                'stats JSON "resilience" section is missing registered '
                "sites: " + ", ".join(missing))
    unknown = sorted({event for _site, event in events_used}
                     - set(event_counters))
    if unknown:
        failures.append("record_event() called with event names no "
                        "counter rolls up: " + ", ".join(unknown))

    # 6. the flight recorder's wiring
    bad_triggers = sorted(set(flightrec.TRIGGER_EVENTS) - set(event_counters))
    if bad_triggers:
        failures.append("flight-recorder trigger events are not registered "
                        "resilience events: " + ", ".join(bad_triggers))
    if "flightrec.notify(" not in _read(os.path.join(resilience_dir,
                                                     "__init__.py")):
        failures.append("resilience.record_event does not call "
                        "flightrec.notify")
    if "notify_run_incomplete" not in _read(os.path.join(_PACKAGE_ROOT,
                                                         "core.py")):
        failures.append("core.fire_lasers' finally does not call "
                        "flightrec.notify_run_incomplete")
    return failures


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    failures = violations(argv[1] if len(argv) > 1 else None)
    if failures:
        print("FAIL: the fault-site registry is not load-bearing:",
              file=sys.stderr)
        for failure in failures:
            print(f"  {failure}", file=sys.stderr)
        return 1
    from mythril_tpu_torch.resilience import registry

    print(f"ok: {len(registry.FAULT_SITES)} fault sites "
          f"({len(registry.NOT_PORTED)} not ported yet) — declared, wired, "
          "chaos-tested and rolled up")
    return 0


if __name__ == "__main__":
    sys.exit(main())
