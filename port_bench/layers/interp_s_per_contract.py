"""Interpreter seconds a contract: SolverStatistics.interp_wall summed
over the contracts the window ran, over their number. Layer: laser."""


def read(run):
    if not run.items_run:
        return None
    return run.stats["interp_wall"] / run.items_run
