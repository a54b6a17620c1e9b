"""Share of the queries routed to the device that it answered, in
percent: device_batch_hits over device_batch_queries (SolverStatistics).
Layer: router and backend (gpu/router, gpu/backend). None when no query
reached the device."""


def read(run):
    queries = run.stats["device_batch_queries"]
    if not queries:
        return None
    return 100.0 * run.stats["device_batch_hits"] / queries
