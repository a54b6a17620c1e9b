"""K1's share of its roofline over the interleaved batches' traced window,
in percent: the least time its launches could take (reference/bounds.
k1_bound from each launch's shapes, recorded by trace.K1Recorder in the
one process) over the device time torch.profiler gave the kernel. Device
trace only: None without one, or when K1 did not run."""

from port_bench import trace
from port_bench.reference.bounds import k1_bound


def read(run):
    if run.device is None or not run.k1_launches:
        return None
    device_s = trace.kernel_seconds(run.device["activity"], trace.K1_KERNEL)
    if device_s <= 0:
        return None
    bound_s = sum(k1_bound(**launch)[0] for launch in run.k1_launches)
    return 100.0 * bound_s / device_s
