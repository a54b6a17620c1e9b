"""The port's fault-site lint (python -m mythril_tpu_torch.resilience.lint,
the twin of tools/check_fault_sites.py): it passes on the tree, and it
fails when a registered site is never crossed, when a crossing names no
registered site, and when a resilience event's counter does not roll up."""

import os
import subprocess
import sys

from mythril_tpu_torch.resilience import lint, registry
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lint_passes_on_the_tree(capsys):
    rc = lint.main(["lint", REPO_ROOT])
    captured = capsys.readouterr()
    assert rc == 0, f"fault-site registry violations:\n{captured.err}"
    assert captured.out.startswith("ok: 17 fault sites")


def test_lint_runs_as_a_module():
    done = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch.resilience.lint"],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
    assert done.returncode == 0, done.stderr


def test_lint_detects_a_ghost_site(monkeypatch):
    """A registered site nothing crosses or tests fails the lint (the
    crossing scanner does not match vacuously)."""
    ghost = registry.FaultSite(
        "ghost.stage", "nowhere", "disable", ("raise",),
        "nothing: this site is a lint fixture")
    monkeypatch.setitem(registry.FAULT_SITES, "ghost.stage", ghost)
    failures = lint.violations(REPO_ROOT)
    assert any("never crossed" in f and "ghost.stage" in f
               for f in failures)
    assert any("no chaos test names" in f and "ghost.stage" in f
               for f in failures)
    assert lint.main(["lint", REPO_ROOT]) == 1


def test_lint_detects_a_crossing_of_an_unregistered_site(monkeypatch):
    monkeypatch.delitem(registry.FAULT_SITES, "aig.session")
    failures = lint.violations(REPO_ROOT)
    assert any("UNREGISTERED" in f and "aig.session" in f
               for f in failures)


def test_not_ported_exempts_only_wiring_and_tests(monkeypatch):
    ghost = registry.FaultSite(
        "ghost.stage", "nowhere", "disable", ("raise",), "a lint fixture")
    monkeypatch.setitem(registry.FAULT_SITES, "ghost.stage", ghost)
    monkeypatch.setitem(registry.NOT_PORTED, "ghost.stage", 12)
    assert lint.violations(REPO_ROOT) == []
    monkeypatch.setattr(SolverStatistics, "as_dict", lambda self: {})
    assert any('"resilience" section' in f
               for f in lint.violations(REPO_ROOT))


def test_lint_detects_an_unrolled_counter(monkeypatch):
    """An event whose counter is not a SolverStatistics counter fails."""
    patched = dict(SolverStatistics._RESILIENCE_EVENT_COUNTERS)
    patched["ghost_event"] = "resilience_ghosts"
    monkeypatch.setattr(
        SolverStatistics, "_RESILIENCE_EVENT_COUNTERS", patched)
    failures = lint.violations(REPO_ROOT)
    assert any("resilience_ghosts" in f and "_COUNTERS" in f
               for f in failures)
    assert any("resilience_ghosts" in f and "as_dict" in f
               for f in failures)


def test_lint_detects_an_unknown_trigger(monkeypatch):
    from mythril_tpu_torch.observe import flightrec

    monkeypatch.setattr(flightrec, "TRIGGER_EVENTS",
                        flightrec.TRIGGER_EVENTS + ("meltdown",))
    assert any("meltdown" in f for f in lint.violations(REPO_ROOT))
