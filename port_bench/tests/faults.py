"""Faulty analyze workers for the pool's fault tests: each runs the real
worker with the timed path broken underneath it, in the worker process
(spawned workers import this module by name)."""

from port_bench.runners import analyze_pool


def _patch_reports(alter):
    from mythril_tpu_torch.core import MythrilAnalyzer

    original = MythrilAnalyzer.fire_lasers
    calls = {"n": 0}

    def fire_lasers(self, *args, **kwargs):
        report = original(self, *args, **kwargs)
        calls["n"] += 1
        alter(report, calls["n"])
        return report

    MythrilAnalyzer.fire_lasers = fire_lasers


def altered_worker(conn, envelope, device, warm_task, control):
    """A finding altered where it is produced: its address moves."""

    def alter(report, _n):
        for issue in report.issues.values():
            issue.address += 1

    _patch_reports(alter)
    analyze_pool._worker(conn, envelope, device, warm_task, control)


def half_worker(conn, envelope, device, warm_task, control):
    """Half of the batch left out: every other contract's report comes
    back empty."""

    def alter(report, n):
        if n % 2 == 0:
            report.issues.clear()

    _patch_reports(alter)
    analyze_pool._worker(conn, envelope, device, warm_task, control)


def jax_worker(conn, envelope, device, warm_task, control):
    """A worker that loads a module named jax (a stand-in) in the middle
    of its run, as a lazy import inside the analysis would."""
    import sys
    import types

    def alter(_report, n):
        if n == 2:               # the first contract after the warm-up
            sys.modules.setdefault("jax", types.ModuleType("jax"))

    _patch_reports(alter)
    analyze_pool._worker(conn, envelope, device, warm_task, control)
