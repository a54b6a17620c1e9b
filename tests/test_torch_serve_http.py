"""The port's serve daemon: its listener, its deadlines and its lifecycle
(the counterparts of tests/test_serve.py's endpoint, deadline, SIGTERM and
soak cases), the abandoned-batch fence, and the port's device-fault rule.

  * /healthz, /metrics (a live scrape) and /analyze over HTTP; malformed
    bytecode answers 400;
  * a batch past its deadline is abandoned, requeued once, then answered
    `incomplete`, and the daemon serves on;
  * the fence: an abandoned batch body ends (slot threads joined,
    coordinator uninstalled) before the next batch starts, so no two
    batches' engine threads overlap, and a DeviceFault it meets on its
    way out is the batch's answer;
  * a DeviceFault inside a request: the request and its siblings answer
    `device_fault`, none `ok`, /healthz turns `ok: false` with the reason,
    admission stops and the daemon's wait returns 2;
  * `serve` without a card and without --torch-device exits 2;
  * SIGTERM drains; the soak (slow) holds contamination, drain and warmth
    under a fault schedule with concurrent clients."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from mythril_tpu_torch.serve import daemon as daemon_mod
from mythril_tpu_torch.serve.daemon import ServeDaemon
from mythril_tpu_torch.support.args import args
from tests.test_analysis import KILLBILLY, OVERFLOW_ADD, wrap_creation
from tests.torch_serve_helpers import (
    REQUEST_WAIT_S,
    device_args,
    drain,
    fresh_stats,
    full_reset,
    http_get,
    http_post,
    issue_set,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def serve_env(monkeypatch, tmp_path):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("MYTHRIL_GPU_FLIGHTREC_DIR", str(tmp_path / "rec"))
    full_reset()
    device_args()
    stats = fresh_stats()
    yield stats
    full_reset()
    stats.reset()


# -- the listener ---------------------------------------------------------------


def test_healthz_and_metrics_endpoints(serve_env, tmp_path):
    args.heartbeat = str(tmp_path / "beat.jsonl")
    daemon = ServeDaemon(tx_count=1, deadline_s=120, http_port=0).start()
    try:
        assert daemon.port
        out = daemon.submit("alice", wrap_creation(KILLBILLY)).wait(
            REQUEST_WAIT_S)
        assert out["status"] == "ok"
        code, text = http_get(daemon.port, "/healthz")
        health = json.loads(text)
        assert code == 200 and health["status"] == "ok" and health["ok"]
        assert health["reason"] is None
        assert health["requests"]["admitted"] == 1
        assert health["requests"]["completed"] == 1
        _code, metrics_text = http_get(daemon.port, "/metrics")
        assert "mythril_tpu_torch_serve_requests_admitted 1" in metrics_text
        assert "mythril_tpu_torch_serve_tenant_window_share" in metrics_text
        assert "mythril_tpu_torch_cdcl_settles" in metrics_text
    finally:
        drain(daemon)
    with open(args.heartbeat, encoding="utf-8") as fd:
        lines = [json.loads(line) for line in fd]
    assert lines and lines[-1]["final"] is True
    assert lines[-1]["counters"]["serve_requests_completed"] == 1
    assert serve_env.serve_drain_wall > 0.0


def test_http_analyze_endpoint_round_trip():
    daemon = ServeDaemon(tx_count=1, deadline_s=120, http_port=0).start()
    try:
        code, outcome = http_post(
            daemon.port, "/analyze",
            {"tenant": "http-client", "code": wrap_creation(KILLBILLY)},
            timeout=REQUEST_WAIT_S)
        assert code == 200
        assert outcome["status"] == "ok"
        assert outcome["tenant"] == "http-client"
        assert issue_set(outcome["issues"])
    finally:
        drain(daemon)


def test_http_malformed_code_answers_400():
    daemon = ServeDaemon(tx_count=1, http_port=0).start()
    try:
        code, outcome = http_post(daemon.port, "/analyze",
                                  {"tenant": "a", "code": "zz-not-hex"})
        assert code == 400
        assert outcome["status"] == "rejected"
    finally:
        drain(daemon)


def test_daemon_metrics_scrape_is_live_not_heartbeat_replay(serve_env):
    """Two scrapes with no heartbeat configured show a counter bump
    between them, and each carries its snapshot's stamp."""
    assert args.heartbeat is None
    daemon = ServeDaemon(tx_count=1, deadline_s=120, http_port=0).start()
    try:
        _code, first = http_get(daemon.port, "/metrics")
        assert "mythril_tpu_torch_net_tier_hits 0" in first
        assert "mythril_tpu_torch_snapshot_ts" in first
        serve_env.add_net_tier_hit(count=5)
        _code, second = http_get(daemon.port, "/metrics")
        assert "mythril_tpu_torch_net_tier_hits 5" in second
        _code, raw = http_get(daemon.port, "/snapshot")
        snap = json.loads(raw)
        assert snap["counters"]["net_tier_hits"] == 5
        assert snap["pid"] == os.getpid()
        assert snap["final"] is False
    finally:
        drain(daemon)


# -- deadlines and the abandoned-batch fence -------------------------------------


def test_legit_deadline_overrun_cancels_requeues_then_incomplete(
        serve_env, monkeypatch):
    import mythril_tpu_torch.core as core_mod

    real = core_mod.MythrilAnalyzer._analyze_one_contract

    def stalled(self, contract, modules, tx_count, stats=None):
        time.sleep(1.5)  # well past the 0.2 s deadline, every time
        return real(self, contract, modules, tx_count, stats=stats)

    monkeypatch.setattr(core_mod.MythrilAnalyzer, "_analyze_one_contract",
                        stalled)
    daemon = ServeDaemon(tx_count=1, deadline_s=0.2).start()
    try:
        outcome = daemon.submit("slow", wrap_creation(KILLBILLY)).wait(
            REQUEST_WAIT_S)
        assert outcome["status"] == "incomplete"
        assert serve_env.resilience_deadline_trips >= 2
        assert serve_env.serve_requests_requeued == 1
        assert serve_env.serve_requests_incomplete == 1
        healthy = daemon.submit("ok", wrap_creation(OVERFLOW_ADD),
                                deadline_s=120.0)
        assert healthy.wait(REQUEST_WAIT_S)["status"] == "ok"
        assert daemon.healthz()["ok"]
    finally:
        drain(daemon)


def test_abandoned_batch_ends_before_its_successor_starts(monkeypatch):
    """No two batches' engine threads overlap: the requeued batch starts
    only once the abandoned body joined its slots and uninstalled its
    coordinator, and its successor's coordinator is never popped."""
    from mythril_tpu_torch.service import interleave

    events = []
    lock = threading.Lock()

    def slow_request(self, request):
        with lock:
            events.append("enter")
        try:
            time.sleep(0.8)  # past the deadline; dies at its next yield
            interleave.tick()
            request.result = {"status": "ok", "issues": [],
                              "exceptions": [], "origin": request.origin}
        finally:
            with lock:
                events.append("exit")

    monkeypatch.setattr(ServeDaemon, "_analyze_request", slow_request)
    daemon = ServeDaemon(tx_count=1, deadline_s=0.2).start()
    try:
        outcome = daemon.submit("slow", wrap_creation(KILLBILLY)).wait(
            REQUEST_WAIT_S)
        assert outcome["status"] == "incomplete"
    finally:
        drain(daemon)
    assert events.count("enter") == 2, events  # the batch and its requeue
    depth = 0
    for kind in events:
        depth += 1 if kind == "enter" else -1
        assert depth <= 1, f"two batches' analyses overlapped: {events}"
    assert interleave.active() is None


def test_a_device_fault_met_by_an_abandoned_body_is_not_lost(monkeypatch):
    """A batch abandoned at its deadline whose slot then meets a
    DeviceFault: the batch answers `device_fault` (it is not requeued onto
    another run) and the daemon stops."""
    from mythril_tpu_torch.gpu.device import DeviceFault

    def faulting(self, request):
        time.sleep(0.8)  # past the deadline, then the device fails
        raise DeviceFault("device path failed: launch error")

    monkeypatch.setattr(ServeDaemon, "_analyze_request", faulting)
    monkeypatch.setattr(daemon_mod, "FAULT_LINGER_S", 0.1)
    daemon = ServeDaemon(tx_count=1, deadline_s=0.2).start()
    outcome = daemon.submit("alice", wrap_creation(KILLBILLY)).wait(
        REQUEST_WAIT_S)
    assert outcome["status"] == "device_fault"
    assert "launch error" in outcome["reason"]
    assert daemon_mod.wait_until_stopped(daemon) == 2


def test_an_abandoned_batch_that_does_not_end_stops_the_daemon(
        monkeypatch):
    """A batch past its deadline whose body does not end within the drain
    timeout: rather than run a batch beside it, the daemon answers it
    `incomplete`, reports `stopped` on /healthz and its wait returns 2."""
    release = threading.Event()

    def wedged(self, request):
        release.wait(30.0)  # no yield point: the cancel cannot reach it

    monkeypatch.setenv("MYTHRIL_GPU_SERVE_DRAIN_TIMEOUT", "0.5")
    monkeypatch.setattr(ServeDaemon, "_analyze_request", wedged)
    monkeypatch.setattr(daemon_mod, "FAULT_LINGER_S", 0.1)
    daemon = ServeDaemon(tx_count=1, deadline_s=0.2).start()
    try:
        outcome = daemon.submit("alice", wrap_creation(KILLBILLY)).wait(
            REQUEST_WAIT_S)
        assert outcome["status"] == "incomplete"
        assert "did not end" in outcome["reason"]
        health = daemon.healthz()
        assert health["status"] == "stopped" and health["ok"] is False
        late = daemon.submit("bob", wrap_creation(OVERFLOW_ADD))
        assert late.outcome["reason"] == "stopped"
    finally:
        release.set()
    assert daemon_mod.wait_until_stopped(daemon) == 2


def test_device_fault_answers_the_batch_and_stops_the_daemon(
        serve_env, monkeypatch):
    """The port's rule: a DeviceFault inside one request is never that
    request's `error`. It and its sibling answer `device_fault` (the
    sibling finished first, and still does not answer `ok`), nothing is
    requeued, /healthz is not ok and names the fault, admission stops,
    and the wait returns 2."""
    from mythril_tpu_torch.gpu.device import DeviceFault

    def one_faults(self, request):
        if request.tenant == "alice":
            raise DeviceFault("device path failed: injected launch error")
        request.result = {"status": "ok", "issues": [], "exceptions": [],
                          "origin": request.origin}

    monkeypatch.setattr(ServeDaemon, "_analyze_request", one_faults)
    monkeypatch.setattr(daemon_mod, "FAULT_LINGER_S", 0.1)
    daemon = ServeDaemon(tx_count=1, deadline_s=120, http_port=0)
    bob = daemon.submit("bob", wrap_creation(OVERFLOW_ADD))
    alice = daemon.submit("alice", wrap_creation(KILLBILLY))
    daemon.start()
    outcomes = [bob.wait(REQUEST_WAIT_S), alice.wait(REQUEST_WAIT_S)]
    assert [o["status"] for o in outcomes] == ["device_fault"] * 2
    code, text = http_get(daemon.port, "/healthz")
    health = json.loads(text)
    assert code == 503 and health["ok"] is False
    assert "injected launch error" in health["reason"]
    late = daemon.submit("carol", wrap_creation(KILLBILLY))
    assert late.outcome["status"] == "rejected"
    assert late.outcome["reason"] == "device_fault"
    assert serve_env.serve_requests_requeued == 0
    assert serve_env.serve_requests_completed == 0
    assert daemon_mod.wait_until_stopped(daemon) == 2


def test_serve_without_a_card_exits_two():
    """`serve` on the device backend with no card and no --torch-device
    exits 2 before it listens, as analyze does."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO_ROOT)
    result = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "serve", "--port", "0"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert result.returncode == 2, result.stderr[-2000:]
    assert "no CUDA device" in result.stderr
    assert "listening" not in result.stdout


# -- lifecycle --------------------------------------------------------------------


def test_sigterm_drains_cleanly():
    from mythril_tpu_torch.serve.daemon import install_signal_handlers

    daemon = ServeDaemon(tx_count=1, deadline_s=120).start()
    saved_term = signal.getsignal(signal.SIGTERM)
    saved_int = signal.getsignal(signal.SIGINT)
    try:
        install_signal_handlers(daemon)
        out = daemon.submit("alice", wrap_creation(KILLBILLY))
        os.kill(os.getpid(), signal.SIGTERM)
        assert daemon.drained.wait(timeout=REQUEST_WAIT_S)
        assert out.wait(1)["status"] == "ok"
        late = daemon.submit("bob", wrap_creation(KILLBILLY))
        assert late.outcome["reason"] == "draining"
    finally:
        signal.signal(signal.SIGTERM, saved_term)
        signal.signal(signal.SIGINT, saved_int)


@pytest.mark.slow
def test_soak_concurrent_clients_with_fault_schedule(serve_env):
    """Three concurrent HTTP clients (a cold phase, then a warm one) over
    KILLBILLY, OVERFLOW_ADD and the smallest corpus contract, under a
    seeded host fault schedule: no cross-request contamination (each ok
    answer's findings equal its contract's clean serve), a clean drain,
    and a warm phase with fewer CDCL settles than the cold one."""
    corpus_dir = os.path.join(REPO_ROOT, "bench_inputs", "corpus")
    smallest = min((name for name in os.listdir(corpus_dir)
                    if name.endswith(".hex")),
                   key=lambda name: os.path.getsize(
                       os.path.join(corpus_dir, name)))
    with open(os.path.join(corpus_dir, smallest)) as fd:
        codes = [wrap_creation(KILLBILLY), wrap_creation(OVERFLOW_ADD),
                 fd.read().strip()]
    clean = {}
    daemon = ServeDaemon(tx_count=1, deadline_s=60.0, http_port=0).start()
    try:
        for index, code in enumerate(codes):
            out = daemon.submit(f"clean-{index}", code).wait(REQUEST_WAIT_S)
            assert out["status"] == "ok"
            clean[index] = issue_set(out["issues"])
    finally:
        drain(daemon)
    full_reset()
    device_args(inject_fault="serve.worker:raise:n2,serve.request:raise:n3")
    serve_env.reset()
    serve_env.enabled = True
    daemon = ServeDaemon(tx_count=1, deadline_s=60.0, http_port=0).start()
    results, settles = [], {}
    try:
        def client(index):
            code, out = http_post(
                daemon.port, "/analyze",
                {"tenant": f"tenant-{index}", "code": codes[index]},
                timeout=REQUEST_WAIT_S)
            results.append((index, code, out))

        for phase in ("cold", "warm"):
            before = serve_env.cdcl_settles
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(codes))]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=2 * REQUEST_WAIT_S)
            settles[phase] = serve_env.cdcl_settles - before
    finally:
        assert daemon.drain(timeout=120.0)
    contamination = [(index, out["status"]) for index, _code, out in results
                     if out.get("status") == "ok"
                     and issue_set(out["issues"]) != clean[index]]
    assert contamination == []
    tallies = {}
    for _index, _code, out in results:
        tallies[out["status"]] = tallies.get(out["status"], 0) + 1
    assert tallies.get("ok", 0) >= 4, tallies
    assert tallies.get("error", 0) <= 1
    assert settles["warm"] < settles["cold"], settles
