"""Live metrics plane: typed registry, heartbeat stream, Prometheus text
(mythril_tpu.observe.metrics on the port's sources).

The spans and the roofline are exit-time artifacts. This module is the
live view:

  registry     every emitted metric declared as a typed Instrument
               (counter / gauge / histogram) with its source.
               SolverStatistics stays the single write path; the registry
               enumerates the live view, so the stats-key lint
               (observe/stats_keys.py) can prove every instrument reaches
               the stats JSON and the heartbeat snapshot.
  snapshot()   one point-in-time reading of everything the registry
               names: SolverStatistics scalars (monotone within a run),
               occupancy gauges, the histograms, roofline attained /
               attainable per stage, the per-site resilience events and
               the run stamp.
  heartbeat    a daemon thread appending snapshot JSONL lines every
               MYTHRIL_GPU_HEARTBEAT_INTERVAL seconds to the
               MYTHRIL_GPU_HEARTBEAT (or --heartbeat) path. The final
               beat, written from fire_lasers' finally, carries
               final=true and agrees with the exit stats JSON: both
               sample the same singleton.
  prometheus   text exposition of a snapshot; with MYTHRIL_GPU_PROM=<path>
               the heartbeat rewrites that file atomically each beat.

Every snapshot, stats JSON and flight-recorder dump carries stamp():
schema_version, the git revision and the platform. Nothing here touches
the card: the platform is read on the main thread only, and the
heartbeat thread reads host counters.
"""

import json
import logging
import os
import re
import sys
import threading
import time
from typing import NamedTuple, Optional, Tuple

from mythril_tpu_torch.support.env import env_float

log = logging.getLogger(__name__)

# bump when the snapshot/stats-JSON envelope changes shape (keys moved or
# re-typed; additive keys do not bump)
SCHEMA_VERSION = 1

HEARTBEAT_ENV = "MYTHRIL_GPU_HEARTBEAT"
INTERVAL_ENV = "MYTHRIL_GPU_HEARTBEAT_INTERVAL"
PROM_ENV = "MYTHRIL_GPU_PROM"
DEFAULT_INTERVAL_S = 10.0


class Instrument(NamedTuple):
    name: str          # metric name (SolverStatistics field for source=stats)
    kind: str          # counter | gauge | histogram
    source: str        # stats | roofline | resilience


# gauges derived from counters (SolverStatistics properties) and the
# non-scalar histograms as_dict() emits; counters and timers come from
# SolverStatistics itself, so a new counter is registered by construction
_GAUGE_NAMES = (
    "device_occupancy", "coalesce_occupancy", "frontier_batch_occupancy",
    "serve_tenant_window_share")
_HISTOGRAM_NAMES = ("prepare_suffix_hist", "interp_opcode_wall")
_ROOFLINE_FIELDS = ("attained", "attainable", "sol_gap_s")


def _build_registry() -> Tuple[Instrument, ...]:
    from mythril_tpu_torch.observe import roofline
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    instruments = [Instrument(name, "counter", "stats")
                   for name in (SolverStatistics._COUNTERS
                                + SolverStatistics._TIMERS)]
    instruments += [Instrument(name, "gauge", "stats")
                    for name in _GAUGE_NAMES]
    instruments += [Instrument(name, "histogram", "stats")
                    for name in _HISTOGRAM_NAMES]
    instruments += [Instrument(f"roofline.{stage}.{field}", "gauge",
                               "roofline")
                    for stage in roofline.STAGES
                    for field in _ROOFLINE_FIELDS]
    # the per-(site, event) breakdown behind the resilience_* scalars
    instruments.append(
        Instrument("resilience_events", "counter", "resilience"))
    return tuple(instruments)


REGISTRY: Tuple[Instrument, ...] = _build_registry()


def snapshot_covers(instrument: Instrument, snap: dict) -> bool:
    """Does this heartbeat snapshot carry the instrument?"""
    if instrument.source == "stats":
        section = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms"}[instrument.kind]
        return instrument.name in snap.get(section, {})
    if instrument.source == "roofline":
        # a stage name may itself be dotted ("frontier.fork"): the field
        # is the last component, the stage what lies between it and the
        # "roofline." prefix
        stem, field = instrument.name.rsplit(".", 1)
        stage = stem.split(".", 1)[1]
        return field in snap.get("roofline", {}).get(stage, {})
    if instrument.source == "resilience":
        return isinstance(snap.get("resilience"), dict)
    return False


# -- run stamp (heartbeat, stats JSON, flight recorder) -----------------------

_git_rev_cache: Optional[str] = None
_platform: Optional[str] = None


def git_revision() -> str:
    """The checkout's git revision, read from .git (no subprocess);
    "unknown" outside a checkout."""
    global _git_rev_cache
    if _git_rev_cache is not None:
        return _git_rev_cache
    _git_rev_cache = "unknown"
    root = os.path.dirname(os.path.abspath(__file__))
    for _ in range(8):
        git_dir = os.path.join(root, ".git")
        if os.path.isdir(git_dir):
            _git_rev_cache = _read_git_rev(git_dir)
            break
        parent = os.path.dirname(root)
        if parent == root:
            break
        root = parent
    return _git_rev_cache


def _read_git_rev(git_dir: str) -> str:
    try:
        with open(os.path.join(git_dir, "HEAD")) as fd:
            head = fd.read().strip()
        if not head.startswith("ref:"):
            return head[:40] or "unknown"
        ref = head.split(None, 1)[1]
        ref_path = os.path.join(git_dir, *ref.split("/"))
        if os.path.isfile(ref_path):
            with open(ref_path) as fd:
                return fd.read().strip()[:40] or "unknown"
        packed = os.path.join(git_dir, "packed-refs")
        if os.path.isfile(packed):
            with open(packed) as fd:
                for line in fd:
                    parts = line.strip().split()
                    if len(parts) == 2 and parts[1] == ref:
                        return parts[0][:40]
    except OSError:
        pass
    return "unknown"


def torch_platform() -> str:
    """The card's name once this process initialized CUDA; "cpu" when the
    run asked for the CPU (a CPU torch device or the host backend);
    "uninitialized" otherwise. It never initializes CUDA, and it is read
    on the main thread only: other threads (the heartbeat) get the main
    thread's last reading and make no CUDA call."""
    global _platform
    if threading.current_thread() is not threading.main_thread():
        return _platform or "uninitialized"
    from mythril_tpu_torch.support.args import args

    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        _platform = torch.cuda.get_device_name()
    elif args.solver_backend == "cpu" or str(args.torch_device) == "cpu":
        _platform = "cpu"
    else:
        _platform = "uninitialized"
    return _platform


def stamp() -> dict:
    """The self-description every telemetry artifact carries."""
    return {
        "schema_version": SCHEMA_VERSION,
        "git_rev": git_revision(),
        "platform": torch_platform(),
    }


# -- snapshots ----------------------------------------------------------------


def snapshot(seq: int = 0, final: bool = False) -> dict:
    """One live reading of every registered instrument. `seq` and `ts`
    order and gap-check the stream; `final` marks the last beat."""
    from mythril_tpu_torch.observe import roofline
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    stats = SolverStatistics()
    counters = {name: getattr(stats, name)
                for name in SolverStatistics._COUNTERS}
    counters.update({name: round(getattr(stats, name), 4)
                     for name in SolverStatistics._TIMERS})
    gauges = {name: round(getattr(stats, name), 4)
              for name in _GAUGE_NAMES}
    histograms = {
        "prepare_suffix_hist": dict(stats.prepare_suffix_hist),
        "interp_opcode_wall": {
            op: [count, round(seconds, 4)]
            for op, (count, seconds)
            in list(stats.interp_opcode_wall.items())},
    }
    roof = roofline.build(stats)
    roofline_view = {
        stage: {field: row.get(field) for field in _ROOFLINE_FIELDS}
        for stage, row in roof.get("stages", {}).items()
    }
    # the sites that recorded an event so far
    sites = {site: dict(events)
             for site, events in list(stats.resilience_events.items())}
    snap = stamp()
    snap.update({
        "seq": seq,
        "ts": round(time.time(), 3),
        "pid": os.getpid(),
        "final": bool(final),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "roofline": roofline_view,
        "resilience": sites,
    })
    return snap


def merge_snapshots(snaps) -> dict:
    """Fold several processes' snapshots into one view
    (mythril_tpu/observe/metrics.py:270): counters and timers sum, the
    histograms and the per-site resilience events merge, and the ratio
    gauges are recomputed from the summed counters (averaging each
    process's ratio would weigh an idle worker like a busy one). The
    roofline view is left out: each process calibrates its own ceilings,
    and they do not add. The stamp, seq and ts are the newest
    snapshot's."""
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    snaps = [snap for snap in snaps if snap]
    if not snaps:
        return snapshot()
    merged = dict(max(snaps, key=lambda snap: snap.get("ts", 0)))
    counters = {}
    for name in SolverStatistics._COUNTERS:
        counters[name] = sum(
            int(snap.get("counters", {}).get(name, 0)) for snap in snaps)
    for name in SolverStatistics._TIMERS:
        counters[name] = round(sum(
            float(snap.get("counters", {}).get(name, 0.0))
            for snap in snaps), 4)
    merged["counters"] = counters

    def ratio(numerator, denominator) -> float:
        return round(numerator / denominator, 4) if denominator else 0.0

    merged["gauges"] = {
        "device_occupancy": ratio(counters["device_dispatched_queries"],
                                  counters["device_slots"]),
        "coalesce_occupancy": ratio(counters["coalesced_queries"],
                                    counters["window_flushes"]),
        "frontier_batch_occupancy": ratio(
            counters["frontier_states_stepped"]
            + counters["frontier_batch_bails"]
            + counters["frontier_fork_cohort_rows"],
            counters["frontier_batch_slots"]),
        "serve_tenant_window_share": ratio(
            counters["serve_batch_requests"],
            counters["serve_batch_tenants"]),
    }
    histograms = {name: {} for name in _HISTOGRAM_NAMES}
    for snap in snaps:
        for name, buckets in (snap.get("histograms") or {}).items():
            section = histograms.setdefault(name, {})
            for bucket, value in buckets.items():
                if isinstance(value, (list, tuple)):
                    record = section.setdefault(bucket, [0, 0.0])
                    record[0] += int(value[0])
                    record[1] = round(record[1] + float(value[1]), 4)
                else:
                    section[bucket] = section.get(bucket, 0) + int(value)
    merged["histograms"] = histograms
    sites = {}
    for snap in snaps:
        for site, events in (snap.get("resilience") or {}).items():
            per_site = sites.setdefault(site, {})
            for event, count in events.items():
                per_site[event] = per_site.get(event, 0) + int(count)
    merged["resilience"] = sites
    merged["roofline"] = {}
    merged["pid"] = os.getpid()
    merged["final"] = all(snap.get("final") for snap in snaps)
    return merged


# -- Prometheus text exposition -----------------------------------------------

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
PROM_PREFIX = "mythril_tpu_torch_"


def _prom_name(name: str) -> str:
    return PROM_PREFIX + _PROM_NAME_RE.sub("_", name)


def _prom_escape(value) -> str:
    return str(value).replace("\\", r"\\").replace('"', r'\"')


def prometheus_text(snap: Optional[dict] = None,
                    scrape_stamp: bool = False) -> str:
    """A snapshot in the Prometheus text exposition format (the file a
    node-exporter textfile collector reads, and the serve daemon's and
    the fleet's GET /metrics). scrape_stamp adds the snapshot_ts gauge,
    the second the snapshot was taken: only the live scrapes set it, so
    the file stays byte-identical for equal counters."""
    snap = snap or snapshot()
    build_info = _prom_name("build_info")
    lines = [
        f"# HELP {build_info} run stamp (constant 1)",
        f"# TYPE {build_info} gauge",
        '%s{git_rev="%s",platform="%s",schema_version="%d"} 1' % (
            build_info,
            _prom_escape(snap.get("git_rev", "unknown")),
            _prom_escape(snap.get("platform") or "none"),
            snap.get("schema_version", SCHEMA_VERSION)),
    ]
    ts = snap.get("ts") if scrape_stamp else None
    if ts is not None:
        stamp_name = _prom_name("snapshot_ts")
        lines.append(f"# TYPE {stamp_name} gauge")
        lines.append(f"{stamp_name} {ts}")
    for name, value in sorted(snap.get("counters", {}).items()):
        prom = _prom_name(name)
        lines.append(f"# TYPE {prom} counter")
        lines.append(f"{prom} {value}")
    for name, value in sorted(snap.get("gauges", {}).items()):
        prom = _prom_name(name)
        lines.append(f"# TYPE {prom} gauge")
        lines.append(f"{prom} {value}")
    for name, buckets in sorted(snap.get("histograms", {}).items()):
        prom = _prom_name(name)
        lines.append(f"# TYPE {prom} gauge")
        for bucket, value in sorted(buckets.items()):
            # interp_opcode_wall buckets are [count, seconds] pairs;
            # suffix-hist buckets are plain counts
            count = value[0] if isinstance(value, (list, tuple)) else value
            lines.append(
                f'{prom}{{bucket="{_prom_escape(bucket)}"}} {count}')
    roof_rows = sorted(snap.get("roofline", {}).items())
    for field in _ROOFLINE_FIELDS:
        prom = _prom_name(f"roofline_{field}")
        lines.append(f"# TYPE {prom} gauge")
        for stage, row in roof_rows:
            value = row.get(field)
            if value is not None:
                lines.append(
                    f'{prom}{{stage="{_prom_escape(stage)}"}} {value}')
    prom = _prom_name("resilience_events")
    lines.append(f"# TYPE {prom} counter")
    for site, events in sorted(snap.get("resilience", {}).items()):
        for event, count in sorted(events.items()):
            lines.append(
                f'{prom}{{site="{_prom_escape(site)}",'
                f'event="{_prom_escape(event)}"}} {count}')
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, snap: Optional[dict] = None) -> bool:
    """Atomically (re)write the exposition file: a scraper never reads a
    torn write."""
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fd:
            fd.write(prometheus_text(snap))
        os.replace(tmp, path)
        return True
    except OSError as error:
        log.warning("could not write prometheus exposition to %s (%s)",
                    path, error)
        return False


# -- heartbeat ----------------------------------------------------------------


class Heartbeat:
    """Daemon-thread JSONL metrics stream, one writer per process (the
    analyzer's fire_lasers)."""

    # floor for any configured cadence: a zero or negative interval must
    # never turn the thread into a busy loop
    MIN_INTERVAL_S = 0.05

    def __init__(self, path: str, interval_s: Optional[float] = None,
                 prom_path: Optional[str] = None):
        self.path = path
        resolved = (interval_s if interval_s and interval_s > 0
                    else env_float(INTERVAL_ENV, DEFAULT_INTERVAL_S))
        if resolved <= 0:
            resolved = DEFAULT_INTERVAL_S
        self.interval_s = max(resolved, self.MIN_INTERVAL_S)
        self.prom_path = prom_path or os.environ.get(PROM_ENV) or None
        self.beats = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name="mythril-tpu-torch-heartbeat",
            daemon=True)

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def beat(self, final: bool = False) -> Optional[dict]:
        """Append one snapshot line (and refresh the Prometheus file),
        under a lock so the final beat cannot interleave with a timer
        beat. Never raises: a beat racing a counter mutation must not kill
        the stream, and the final beat runs in fire_lasers' finally,
        where an escape would mask the run's own exception and cost the
        stats JSON behind it."""
        with self._lock:
            try:
                snap = snapshot(seq=self.beats, final=final)
                line = json.dumps(snap)
                with open(self.path, "a") as fd:
                    fd.write(line + "\n")
            except Exception as error:
                log.warning("heartbeat beat to %s failed (%s)",
                            self.path, error)
                return None
            self.beats += 1
            if self.prom_path:
                write_prometheus(self.prom_path, snap)
            return snap

    def stop(self, final: bool = True) -> None:
        """Stop the timer and write the final beat, which samples the same
        SolverStatistics singleton the exit stats JSON serializes."""
        self._stop.set()
        self._thread.join(timeout=self.interval_s + 5.0)
        if final:
            self.beat(final=True)


def start_heartbeat(cli_path: Optional[str] = None,
                    interval_s: Optional[float] = None
                    ) -> Optional[Heartbeat]:
    """Start the heartbeat if --heartbeat or MYTHRIL_GPU_HEARTBEAT names a
    path; None (no thread at all) otherwise. Reads the platform first, on
    the calling (main) thread, so the beats carry it."""
    path = cli_path or os.environ.get(HEARTBEAT_ENV) or None
    if not path:
        return None
    torch_platform()
    heartbeat = Heartbeat(path, interval_s=interval_s)
    heartbeat.start()
    log.info("heartbeat metrics stream: %s every %.1fs",
             path, heartbeat.interval_s)
    return heartbeat
