"""What a traced run reads besides the program's counters: the device's
activity from torch.profiler (CUPTI), the program's spans from its tracer,
and the shapes of K1's launches.

The profiler part is a copy of chip_smoke.py's `_profile_device` idea
(device time by kernel name), kept here with the interval arithmetic the
idle share and the breakdown need: every device activity as an interval on
the host's clock (nanoseconds since the epoch, as the tracer's spans), the
union of those intervals, the gaps between them, and the host span open
in each gap."""

import time
from typing import Dict, List, Optional, Tuple

K1_KERNEL = "ragged_round_kernel"


class DeviceCapture:
    """torch.profiler over one measured window of this process."""

    def __init__(self):
        self._profile = None
        self.start_ns = self.stop_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._profile = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        self._profile.start()
        self.start_ns = time.time_ns()

    def stop(self) -> List[Tuple[str, int, int]]:
        """Stop; (name, start ns, end ns) of every device activity inside
        the window, on the host's clock."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.stop_ns = time.time_ns()
        self._profile.stop()
        out = []
        for event in self._profile.profiler.kineto_results.events():
            if event.device_type() != DeviceType.CUDA:
                continue
            start = max(int(event.start_ns()), self.start_ns)
            end = min(int(event.start_ns() + event.duration_ns()),
                      self.stop_ns)
            if end > start:
                out.append((event.name(), start, end))
        self._profile = None
        return out


def union(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(start, end) for start, end in merged]


def busy_seconds(activity, start_ns: int, stop_ns: int) -> float:
    """Seconds of [start_ns, stop_ns] in which any activity ran."""
    total = 0
    for start, end in union((max(s, start_ns), min(e, stop_ns))
                            for _name, s, e in activity):
        if end > start:
            total += end - start
    return total / 1e9


def device_ops(activity, top: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took most time."""
    by_name: Dict[str, int] = {}
    for name, start, end in activity:
        short = kernel_name(name)
        by_name[short] = by_name.get(short, 0) + end - start
    ranked = sorted(by_name.items(), key=lambda item: -item[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def kernel_name(name: str) -> str:
    """A device operation's name without its namespace, template and
    argument lists ("(anonymous namespace)::k(Flat, ...)" reads "k")."""
    name = name.replace("(anonymous namespace)::", "").strip()
    for mark in ("(", "<"):
        if name.find(mark) > 0:
            name = name[:name.find(mark)]
    return name.split("::")[-1].replace("void ", "").strip()[:96]


def idle_gaps(activity, spans, start_ns: int, stop_ns: int,
              top: int = 10) -> List[list]:
    """[what the host was doing, seconds] of the longest stretches of the
    window with no device activity. Each gap is named by the innermost
    host span (name, start ns, end ns) open at its middle."""
    gaps, cursor = [], start_ns
    for start, end in union((s, e) for _name, s, e in activity):
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if stop_ns > cursor:
        gaps.append((cursor, stop_ns))
    gaps.sort(key=lambda gap: gap[0] - gap[1])
    out = []
    for start, end in gaps[:top]:
        middle = (start + end) // 2
        open_spans = [(s_end - s_start, name) for name, s_start, s_end
                      in spans if s_start <= middle <= s_end]
        out.append([min(open_spans)[1] if open_spans else "no span open",
                    (end - start) / 1e9])
    return out


def program_spans(events) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of the program tracer's complete events
    (their ts and dur are microseconds on the host's clock)."""
    return [(event["name"], int(event["ts"] * 1e3),
             int((event["ts"] + event["dur"]) * 1e3))
            for event in events if event.get("ph") == "X"]


class K1Recorder:
    """Records the shapes of every K1 launch while installed, by wrapping
    mythril_tpu_torch.gpu.ragged_kernel.run_round_ragged_kernel (the
    traced run only: it reads the live roots of each new stream once,
    which waits for the device)."""

    def __init__(self):
        self.launches: List[dict] = []
        self._original = None
        self._last_flat = None
        self._last_roots = 0

    def install(self) -> None:
        from mythril_tpu_torch.gpu import ragged_kernel

        self._original = original = ragged_kernel.run_round_ragged_kernel

        def recorded(flat, x, seed, steps, walk_depth, caps):
            if flat is not self._last_flat:
                self._last_flat = flat
                self._last_roots = int(
                    (flat.arrays["root_mask"] == 1).sum().item())
            self.launches.append({
                "num_gates": int(flat.num_gates),
                "num_levels": int(flat.num_levels),
                "v1": int(flat.cones.v1), "live_roots": self._last_roots,
                "lanes": int(x.shape[0]), "steps": int(steps),
                "var_cap": int(caps.var_cap),
                "cone_cap": int(caps.cone_cap)})
            return original(flat, x, seed, steps, walk_depth, caps)

        ragged_kernel.run_round_ragged_kernel = recorded

    def uninstall(self) -> None:
        from mythril_tpu_torch.gpu import ragged_kernel

        if self._original is not None:
            ragged_kernel.run_round_ragged_kernel = self._original
            self._original = None
        self._last_flat = None


def kernel_seconds(activity, name: str) -> float:
    return sum(end - start for kernel, start, end in activity
               if name in kernel) / 1e9


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = done.stdout.strip().splitlines()
    return lines[0] if lines else None
