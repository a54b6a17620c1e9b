"""The card's idle share over the traced window of back-to-back
interleaved batches, in percent: one less the union of the CUDA activity
torch.profiler saw in the process, over the window's wall. Device trace
only: None without one."""


def read(run):
    if run.device is None or run.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
