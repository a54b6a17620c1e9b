"""Solver prepare milliseconds a query: SolverStatistics.prepare_wall over
the queries the window sent. Layer: smt solver prepare."""


def read(run):
    if not run.queries_run:
        return None
    return 1000.0 * run.stats["prepare_wall"] / run.queries_run
