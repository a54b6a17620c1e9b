"""Tail of the service's window wall: the 95th percentile (nearest rank)
of the harness's clock around each solve_batch call that completed inside
the window, in milliseconds. Layer: service (service/scheduler)."""

from port_bench.common import percentile


def read(run):
    wall = percentile(run.samples, 0.95)
    return None if wall is None else 1000.0 * wall
