"""Host CDCL seconds a contract: SolverStatistics.settle_wall over the
contracts the window ran. Layer: host CDCL (smt/solver/sat_backend)."""


def read(run):
    if not run.items_run:
        return None
    return run.stats["settle_wall"] / run.items_run
