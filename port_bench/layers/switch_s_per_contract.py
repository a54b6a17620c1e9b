"""Seconds of engine-context switching a contract: SolverStatistics.
interleave_switch_wall (the coordinator's saves and restores of each
contract's engine state at its hand-offs, service/tenancy.py) over the
contracts the window ran. Layer: coordinator. None without contracts or
without the counter."""


def read(run):
    wall = run.stats.get("interleave_switch_wall")
    if wall is None or not run.items_run:
        return None
    return wall / run.items_run
