"""Solver prepare seconds a contract (simplify, lower, blast, aig_opt,
cnf_prep): SolverStatistics.prepare_wall over the contracts the window
ran. Layer: smt solver prepare."""


def read(run):
    if not run.items_run:
        return None
    return run.stats["prepare_wall"] / run.items_run
