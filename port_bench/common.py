"""What both runners share: the run's record, the configuration's envelope
applied to the port's flags, the program's counters, the run's private
state directory and the process clock."""

import math
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

from port_bench import trace

# top-level modules no process of a run may hold, compared whole
# (mythril_tpu_torch is not mythril_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "mythril_tpu")

# the SolverStatistics counters and timers the per-layer metrics read
STAT_KEYS = ("prepare_wall", "interp_wall", "settle_wall",
             "device_batch_queries", "device_batch_hits")


class RunRecord:
    """One run's readings; the layer readers (layers/<metric>.py) take it."""

    def __init__(self, setup_s: Optional[float] = None):
        self.setup_s = setup_s
        self.end_to_end: Dict[str, float] = {}
        self.correct = False
        self.attempted = self.failed = 0
        self.failures: List[str] = []
        # name -> (value, "<=" or ">=", limit)
        self.checks: Dict[str, tuple] = {}
        self.samples: List[float] = []   # each item's wall
        self.items_run = 0               # items run in the window
        self.queries_run = 0
        self.stats: Dict[str, float] = {}
        self.memory_peak_bytes = 0
        self.k1_launches: Optional[List[dict]] = None
        # forbidden top-level modules a worker process of the run held
        self.forbidden: List[str] = []
        self.notes: List[str] = []       # extra lines for standard error
        # set from a device trace only (never on the CPU)
        self.device: Optional[dict] = None

    def set_device(self, activity, spans, start_ns: int,
                   stop_ns: int) -> None:
        self.device = {
            "activity": activity,
            "busy_s": trace.busy_seconds(activity, start_ns, stop_ns),
            "window_s": (stop_ns - start_ns) / 1e9,
            "device_ops": trace.device_ops(activity),
            "idle_gaps": trace.idle_gaps(activity, spans, start_ns,
                                         stop_ns),
        }


def forbidden_modules() -> List[str]:
    """Top-level names of this process's loaded modules that are in
    FORBIDDEN."""
    import sys

    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def cpu_seconds() -> float:
    """CPU time this process has used so far, in all its threads, user
    and system."""
    import resource

    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_utime + usage.ru_stime


def percentile(values, share: float) -> Optional[float]:
    """The nearest-rank percentile (share in 0-1), None without samples."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(share * len(ordered)) - 1)]


def stat_snapshot() -> Dict[str, float]:
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    stats = SolverStatistics()
    return {key: getattr(stats, key) for key in STAT_KEYS}


def apply_envelope(envelope: dict, device: Optional[str]) -> None:
    """The port's analysis flags as the configuration states them; device
    None is the card, "cpu" the kernels' plain versions (tests only)."""
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support.args import args

    args.reset()
    for key, value in envelope.items():
        if key not in ("strategy", "modules"):
            setattr(args, key, value)
    args.torch_device = device
    SolverStatistics().enabled = True


def process_start() -> float:
    """time.monotonic() at which this process started (from its start
    time in /proc, which counts clock ticks since boot)."""
    with open("/proc/self/stat") as handle:
        fields = handle.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.monotonic() - (time.clock_gettime(time.CLOCK_BOOTTIME)
                               - started)


class PrivateState:
    """A directory of the run's own under TMPDIR for the port's per-user
    state: MYTHRIL_GPU_DIR (config, signatures), MYTHRIL_GPU_CACHE_DIR
    (calibration, a tuned profile, the disk tier) and the flight
    recorder's dumps. Each run starts from an empty one, so none inherits
    another's tuned profile, disk tier or result store; it is removed at
    the end. The kernels' builds (mythril_tpu_torch/_build) are not state:
    they stay in the checkout for the next run."""

    KEYS = {"MYTHRIL_GPU_DIR": "home", "MYTHRIL_GPU_CACHE_DIR": "cache",
            "MYTHRIL_GPU_FLIGHTREC_DIR": "flightrec"}

    def __init__(self):
        self.path = tempfile.mkdtemp(prefix="port_bench_state.")
        for key, sub in self.KEYS.items():
            os.makedirs(os.path.join(self.path, sub))
            os.environ[key] = os.path.join(self.path, sub)

    def close(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)
