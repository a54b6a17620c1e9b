"""Share of the cones dispatched to the device that rode a stream of two
or more contracts, in percent: SolverStatistics.xcontract_cones_packed
over device_dispatched_queries (both counted where the router dispatches
a ragged stream, gpu/router.py). Layer: router and backend. None when no
cone was dispatched or a counter is absent."""


def read(run):
    packed = run.stats.get("xcontract_cones_packed")
    dispatched = run.stats.get("device_dispatched_queries")
    if packed is None or not dispatched:
        return None
    return 100.0 * packed / dispatched
