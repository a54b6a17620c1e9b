"""Contracts a flush of the shared window carried, on average:
SolverStatistics.interleave_flush_origins over interleave_flushes (the
interleave coordinator's flushes, service/interleave.py). Layer:
coordinator. None when the coordinator flushed nothing or a counter is
absent."""


def read(run):
    origins = run.stats.get("interleave_flush_origins")
    flushes = run.stats.get("interleave_flushes")
    if origins is None or not flushes:
        return None
    return origins / flushes
