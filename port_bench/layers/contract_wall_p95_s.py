"""Tail of the analyze wall: the 95th percentile (nearest rank) of the
harness's clock around each fire_lasers call that completed inside the
window, over every worker. Layer: front (core.MythrilAnalyzer)."""

from port_bench.common import percentile


def read(run):
    return percentile(run.samples, 0.95)
