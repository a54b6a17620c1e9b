"""The port's live telemetry: the metrics registry and heartbeat stream,
the Prometheus file and the always-on flight recorder (the counterparts of
tests/test_observe_live.py; its --jobs worker-death case waits for the
port's corpus runs, and its bench_compare and stats-dump cases for the
port's benchmark)."""

import glob
import json
import os
import threading
import time
from collections import deque

import pytest

from mythril_tpu_torch.observe import flightrec, metrics
from mythril_tpu_torch.observe.tracer import get_tracer, span
from mythril_tpu_torch.resilience import registry
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args

TINY = "0x600035600055600056"


@pytest.fixture(autouse=True)
def fresh_live_telemetry_state(tmp_path, monkeypatch):
    # dumps land in a private directory, so workers never share them
    monkeypatch.setenv(flightrec.DIR_ENV, str(tmp_path / "flightrec"))
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    tracer = get_tracer()
    tracer.reset()
    flightrec.reset()
    yield
    tracer.reset()
    flightrec.reset()
    stats.reset()
    args.reset()


def _dumps():
    return sorted(glob.glob(
        os.path.join(os.environ[flightrec.DIR_ENV], "*.json")))


def _stop(heartbeat):
    heartbeat.stop(final=True)
    assert not heartbeat._thread.is_alive()


# -- metrics registry ---------------------------------------------------------


def test_registry_has_no_orphan_instruments():
    snap = metrics.snapshot()
    for instrument in metrics.REGISTRY:
        assert metrics.snapshot_covers(instrument, snap), (
            f"registered instrument {instrument.name} "
            f"({instrument.kind}/{instrument.source}) missing from the "
            "heartbeat snapshot")
    registered = {inst.name for inst in metrics.REGISTRY}
    fields = set(SolverStatistics._COUNTERS) | set(SolverStatistics._TIMERS)
    assert fields <= registered


def test_snapshot_counters_are_monotone_and_stamped():
    stats = SolverStatistics()
    first = metrics.snapshot(seq=0)
    stats.add_query(0.25)
    stats.add_cdcl_settle(clauses=10, seconds=0.01)
    second = metrics.snapshot(seq=1)
    for name in SolverStatistics._COUNTERS:
        assert second["counters"][name] >= first["counters"][name]
    assert second["counters"]["query_count"] == 1
    assert second["counters"]["cdcl_clauses"] == 10
    for snap in (first, second):
        assert snap["schema_version"] == metrics.SCHEMA_VERSION
        assert snap["git_rev"]
        assert snap["platform"] in ("uninitialized", "cpu")
        assert snap["pid"] == os.getpid()
    assert second["seq"] > first["seq"]
    json.dumps(second)  # the whole snapshot is the heartbeat line


def test_platform_stamp_never_wakes_the_device(monkeypatch):
    """"cpu" for a CPU run; on another thread, the main thread's last
    reading and no call into torch.cuda."""
    import torch

    args.solver_backend = "cpu"
    assert metrics.stamp()["platform"] == "cpu"
    args.solver_backend = "gpu"
    args.torch_device = "cpu"
    assert metrics.torch_platform() == "cpu"
    args.torch_device = None
    assert metrics.torch_platform() == "uninitialized"

    def no_cuda(*_args, **_kwargs):
        raise AssertionError("a CUDA call off the main thread")

    monkeypatch.setattr(torch.cuda, "is_initialized", no_cuda)
    monkeypatch.setattr(torch.cuda, "get_device_name", no_cuda)
    seen = []
    thread = threading.Thread(
        target=lambda: seen.append(metrics.snapshot()["platform"]))
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert seen == ["uninitialized"]


def test_heartbeat_stream_monotone_and_final_reconciles(tmp_path):
    stats = SolverStatistics()
    path = str(tmp_path / "hb.jsonl")
    heartbeat = metrics.Heartbeat(path, interval_s=0.05).start()
    try:
        for _ in range(6):
            stats.add_query(0.001)
            time.sleep(0.05)
    finally:
        _stop(heartbeat)
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) >= 3
    assert [line["seq"] for line in lines] == list(range(len(lines)))
    for prev, cur in zip(lines, lines[1:]):
        for name in SolverStatistics._COUNTERS:
            assert cur["counters"][name] >= prev["counters"][name], (
                f"counter {name} went backwards in the heartbeat stream")
    assert lines[-1]["final"] is True
    assert all(line["final"] is False for line in lines[:-1])
    exit_stats = stats.as_dict()
    for name in SolverStatistics._COUNTERS:
        assert lines[-1]["counters"][name] == exit_stats[name]
    for name in SolverStatistics._TIMERS:
        assert lines[-1]["counters"][name] == pytest.approx(
            exit_stats[name], abs=1e-4)


def test_prometheus_exposition_well_formed(tmp_path):
    stats = SolverStatistics()
    stats.add_query(0.5)
    stats.add_resilience_event("device.dispatch", "breaker_probe")
    text = metrics.prometheus_text()
    lines = text.splitlines()
    prefix = metrics.PROM_PREFIX
    assert f"{prefix}build_info{{" in text
    assert f"# TYPE {prefix}query_count counter" in lines
    assert f"{prefix}query_count 1" in lines
    assert f"# TYPE {prefix}device_occupancy gauge" in lines
    assert (f'{prefix}resilience_events{{site="device.dispatch",'
            'event="breaker_probe"} 1') in lines
    for line in lines:
        if line.startswith("#"):
            continue
        name, _sep, value = line.rpartition(" ")
        assert name and value
        float(value)
    prom_path = str(tmp_path / "metrics.prom")
    assert metrics.write_prometheus(prom_path)
    assert open(prom_path).read() == metrics.prometheus_text()


def test_heartbeat_refreshes_prometheus_file(tmp_path):
    hb_path = str(tmp_path / "hb.jsonl")
    prom_path = str(tmp_path / "metrics.prom")
    heartbeat = metrics.Heartbeat(hb_path, interval_s=60.0,
                                  prom_path=prom_path)
    heartbeat.beat()
    assert os.path.isfile(prom_path)
    assert f"{metrics.PROM_PREFIX}build_info" in open(prom_path).read()


def test_heartbeat_arg_flows_into_global_args():
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.interfaces import cli

    class _Ns:
        heartbeat = "/tmp/some_heartbeat.jsonl"

    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode("0x6000", bin_runtime=True)
    MythrilAnalyzer(disassembler, cmd_args=_Ns())
    assert args.heartbeat == "/tmp/some_heartbeat.jsonl"
    parsed = cli.build_parser().parse_args(
        ["analyze", "-c", "6000", "--heartbeat", "/tmp/hb.jsonl"])
    assert parsed.heartbeat == "/tmp/hb.jsonl"


# -- flight recorder ----------------------------------------------------------


def test_ring_captures_spans_with_tracing_unarmed():
    flightrec.install()
    tracer = get_tracer()
    assert not tracer.enabled
    with span("laser.exec", cat="laser"):
        with span("solver.settle", cat="solver"):
            pass
    names = [event["name"] for event in tracer.ring_events()]
    assert names == ["solver.settle", "laser.exec"]  # completion order
    assert tracer.events() == []  # the full buffer stayed empty


def test_ring_is_bounded():
    tracer = get_tracer()
    old_ring = tracer._ring
    tracer.attach_ring(deque(maxlen=8))
    try:
        for i in range(50):
            with span(f"stage.{i}", cat="x"):
                pass
        events = tracer.ring_events()
        assert len(events) == 8
        assert events[-1]["name"] == "stage.49"  # the newest survives
    finally:
        tracer.attach_ring(old_ring)


def test_install_sizes_the_ring_from_the_knobs(monkeypatch):
    """Each fire_lasers' install() reads the knobs anew: a new capacity
    resizes the ring, MYTHRIL_GPU_FLIGHTREC=0 detaches it (span() is the
    shared no-op again)."""
    from mythril_tpu_torch.observe.tracer import NULL_SPAN

    tracer = get_tracer()
    try:
        monkeypatch.setenv(flightrec.CAP_ENV, "8")
        flightrec.install()
        assert tracer._ring.maxlen == 8
        monkeypatch.setenv(flightrec.FLIGHTREC_ENV, "0")
        flightrec.install()
        assert tracer._ring is None
        assert span("anything") is NULL_SPAN
    finally:
        monkeypatch.delenv(flightrec.FLIGHTREC_ENV)
        monkeypatch.delenv(flightrec.CAP_ENV)
        flightrec.install()
    assert tracer._ring.maxlen == flightrec.DEFAULT_CAP


def test_trigger_events_auto_dump_postmortem():
    """A breaker trip dumps the ring: the artifact holds the trip and the
    spans before it, stamped and JSON-valid, with the per-site counts."""
    from mythril_tpu_torch import resilience

    flightrec.install()
    with span("router.dispatch", cat="router"):
        pass
    resilience.record_event("device.dispatch", "breaker_probe")
    resilience.record_event("device.dispatch", "breaker_trip")
    dumps = _dumps()
    assert len(dumps) == 1
    artifact = json.load(open(dumps[0]))
    assert artifact["trigger"] == {"site": "device.dispatch",
                                   "event": "breaker_trip"}
    assert artifact["schema_version"] == metrics.SCHEMA_VERSION
    assert artifact["git_rev"]
    names = [event["name"] for event in artifact["events"]]
    assert names == ["router.dispatch", "resilience.breaker_probe",
                     "resilience.breaker_trip"]
    assert artifact["resilience"]["device.dispatch"] == {
        "breaker_probe": 1, "breaker_trip": 1}
    stats = SolverStatistics()
    assert stats.resilience_breaker_trips == 1
    sites = stats.as_dict()["resilience"]["sites"]
    assert {site: events for site, events in sites.items() if events} == {
        "device.dispatch": {"breaker_probe": 1, "breaker_trip": 1}}
    assert set(sites) == set(registry.FAULT_SITES)  # zero-filled


def test_breaker_trip_reaches_the_recorder():
    """The router's breaker (resilience/breaker.py) trips through
    record_event unchanged, and the trip dumps the ring."""
    from mythril_tpu_torch.resilience.breaker import StageBreaker

    flightrec.install()
    breaker = StageBreaker("device.dispatch", failure_threshold=1)
    breaker.record_failure()
    dumps = _dumps()
    assert len(dumps) == 1
    assert json.load(open(dumps[0]))["trigger"]["event"] == "breaker_trip"


def test_non_trigger_events_do_not_dump():
    from mythril_tpu_torch import resilience

    flightrec.install()
    resilience.record_event("prepare.incremental", "degraded")
    resilience.record_event("device.dispatch", "breaker_probe")
    assert not _dumps()


def test_dumps_capped_per_process():
    from mythril_tpu_torch import resilience

    flightrec.install()
    for _ in range(flightrec.MAX_DUMPS + 3):
        resilience.record_event("device.dispatch", "breaker_trip")
    assert len(_dumps()) == flightrec.MAX_DUMPS


def test_flightrec_env_opt_out(monkeypatch):
    monkeypatch.setenv(flightrec.FLIGHTREC_ENV, "0")
    assert flightrec.ring_capacity() == 0
    assert flightrec.notify("device.dispatch", "breaker_trip") is None
    assert not _dumps()
    # CAP=0 is the other off switch: no ring, no dumps
    monkeypatch.setenv(flightrec.FLIGHTREC_ENV, "1")
    monkeypatch.setenv(flightrec.CAP_ENV, "0")
    assert flightrec.ring_capacity() == 0
    assert flightrec.notify("device.dispatch", "breaker_trip") is None
    assert not _dumps()


def test_incomplete_run_dumps_flight_recorder(monkeypatch):
    """fire_lasers' finally with completed=False leaves a post-mortem
    artifact with --trace unarmed."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler

    args.solver_backend = "cpu"
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode(TINY, bin_runtime=True)
    analyzer = MythrilAnalyzer(disassembler, strategy="bfs")
    monkeypatch.setattr(
        MythrilAnalyzer, "_analyze_one_contract",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError):
        analyzer.fire_lasers(transaction_count=1)
    dumps = _dumps()
    assert len(dumps) == 1
    artifact = json.load(open(dumps[0]))
    assert artifact["trigger"]["event"] == flightrec.RUN_INCOMPLETE


# -- end to end: heartbeat and stamp through a real analyze ---------------------


def test_tiny_analyze_heartbeat_reconciles_with_stats_json(
        tmp_path, monkeypatch):
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler

    stats_path = str(tmp_path / "stats.json")
    hb_path = str(tmp_path / "hb.jsonl")
    prom_path = str(tmp_path / "metrics.prom")
    monkeypatch.setenv("MYTHRIL_GPU_STATS_JSON", stats_path)
    monkeypatch.setenv(metrics.HEARTBEAT_ENV, hb_path)
    monkeypatch.setenv(metrics.INTERVAL_ENV, "0.1")
    monkeypatch.setenv(metrics.PROM_ENV, prom_path)
    args.solver_backend = "cpu"
    args.execution_timeout = 60
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode(TINY, bin_runtime=True)
    analyzer = MythrilAnalyzer(disassembler, strategy="bfs")
    analyzer.fire_lasers(transaction_count=1)
    assert not any(thread.name == "mythril-tpu-torch-heartbeat"
                   for thread in threading.enumerate())
    payload = json.load(open(stats_path))
    assert payload["schema_version"] == metrics.SCHEMA_VERSION
    assert payload["git_rev"]
    assert payload["platform"] == "cpu"
    lines = [json.loads(line) for line in open(hb_path)]
    assert lines, "the heartbeat never wrote a snapshot"
    final = lines[-1]
    assert final["final"] is True
    for name in SolverStatistics._COUNTERS:
        assert final["counters"][name] == payload[name], (
            f"final heartbeat counter {name} does not reconcile with "
            "the exit stats JSON")
    assert "query_count" in open(prom_path).read()
