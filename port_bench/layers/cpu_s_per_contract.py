"""CPU seconds a contract: the CPU time (user and system, every thread)
each worker spent inside its fire_lasers calls, summed over the contracts
the window ran, over their number. Steadier than the contracts' walls
where the host's cores are shared. Layer: front (core.MythrilAnalyzer)."""


def read(run):
    if not run.items_run:
        return None
    return run.stats["cpu_s"] / run.items_run
