"""The port's serve chaos cases (the counterparts of tests/test_chaos.py's
serve cases, :420-600): a fault injected into a two-tenant serve degrades
the faulted request by its site's declared action while the other
tenant's findings stay those of the no-fault serve (issue granularity:
the device backend's K1 plain version may pick other witnesses across
schedules), and the stats JSON's resilience section records the event.

The port's rule at the device site: device.dispatch raising inside a
served batch is never quarantined or requeued. Both tenants answer
`device_fault`, /healthz is not ok, and the daemon's wait returns 2.

Faults are armed through the production path (args.inject_fault ->
ServeDaemon.start -> faults.configure_from_env)."""

import time

import pytest

from mythril_tpu_torch.resilience import faults
from mythril_tpu_torch.serve import daemon as daemon_mod
from mythril_tpu_torch.serve.daemon import ServeDaemon
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args
from tests.test_analysis import KILLBILLY, OVERFLOW_ADD, wrap_creation
from tests.torch_serve_helpers import (
    REQUEST_WAIT_S,
    device_args,
    fresh_stats,
    full_reset,
    issue_set,
)

_SERVE_TENANTS = (("alice", KILLBILLY, 1), ("bob", OVERFLOW_ADD, 1))


@pytest.fixture(autouse=True)
def chaos_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_FLIGHTREC_DIR", str(tmp_path / "rec"))
    # the hang plan's sleep outlives the test in an abandoned daemon thread
    monkeypatch.setattr(faults, "HANG_SECONDS", 20.0)
    monkeypatch.setattr(daemon_mod, "FAULT_LINGER_S", 0.1)
    full_reset()
    device_args(solve_cache="disk")
    stats = fresh_stats()
    yield stats
    full_reset()
    stats.reset()


def _events(site: str) -> dict:
    return SolverStatistics().as_dict()["resilience"]["sites"][site]


def _serve_run(spec=None, deadline_s=60.0, keep=None):
    """One two-tenant serve with `spec` armed; {tenant: outcome}. With
    `keep`, the daemon is left running and stored there."""
    device_args(solve_cache="disk", inject_fault=spec)
    daemon = ServeDaemon(tx_count=1, deadline_s=deadline_s)
    requests = [(tenant, daemon.submit(tenant, wrap_creation(code),
                                       tx_count=tx))
                for tenant, code, tx in _SERVE_TENANTS]
    daemon.start()
    try:
        outcomes = {tenant: request.wait(REQUEST_WAIT_S)
                    for tenant, request in requests}
    finally:
        if keep is None:
            assert daemon.drain(timeout=120.0), "serve drain hung"
        else:
            keep.append(daemon)
        args.inject_fault = None
    for tenant, outcome in outcomes.items():
        assert outcome is not None, f"{tenant}'s request never resolved"
    return outcomes


_SERVE_BASELINE = {}


def _serve_baseline() -> dict:
    """The no-fault serve's outcomes, computed once on fresh state."""
    if not _SERVE_BASELINE:
        full_reset()
        _SERVE_BASELINE.update(_serve_run())
        full_reset()
    return _SERVE_BASELINE


# (spec, site, events that must reach the stats JSON, tenants whose
# findings must equal the baseline's, alice's expected status)
SERVE_CHAOS_MATRIX = [
    pytest.param("serve.request:raise:n1", "serve.request",
                 ("injected", "quarantine"), ("bob",), "error",
                 id="serve.request-raise"),
    pytest.param("serve.admission:raise:n1", "serve.admission",
                 ("injected", "degraded"), ("alice", "bob"), "ok",
                 id="serve.admission-raise"),
    pytest.param("serve.worker:raise:n1", "serve.worker",
                 ("injected", "worker_requeue"), ("alice", "bob"), "ok",
                 id="serve.worker-raise"),
    pytest.param("serve.worker:hang:n1", "serve.worker",
                 ("injected", "deadline", "worker_requeue"),
                 ("alice", "bob"), "ok", id="serve.worker-hang"),
]


@pytest.mark.parametrize(
    "spec,site,expected_events,identical_tenants,alice_status",
    SERVE_CHAOS_MATRIX)
def test_serve_fault_contains_to_one_request(chaos_env, spec, site,
                                             expected_events,
                                             identical_tenants,
                                             alice_status):
    baseline = _serve_baseline()
    full_reset()
    chaos_env.reset()
    chaos_env.enabled = True
    faulted = _serve_run(spec=spec, deadline_s=6.0)
    assert faulted["alice"]["status"] == alice_status
    assert faulted["bob"]["status"] == "ok", \
        "the other tenant must never notice the fault"
    for tenant in identical_tenants:
        assert issue_set(faulted[tenant]["issues"]) == \
            issue_set(baseline[tenant]["issues"]), \
            f"{tenant}'s findings changed under injected fault {spec}"
    recorded = _events(site)
    for event in expected_events:
        assert recorded.get(event, 0) >= 1, (
            f"{spec}: expected {event!r} at {site} in the stats JSON "
            f"resilience section, got {recorded}")


def test_serve_device_dispatch_fault_answers_device_fault(chaos_env):
    """device.dispatch:raise inside a served batch: both tenants answer
    `device_fault` (never `ok`, never requeued), the event is recorded at
    device.dispatch, /healthz is not ok, and the daemon stops (2)."""
    running = []
    outcomes = _serve_run(spec="device.dispatch:raise:n1", keep=running)
    daemon = running[0]
    assert {tenant: o["status"] for tenant, o in outcomes.items()} == \
        {"alice": "device_fault", "bob": "device_fault"}
    for outcome in outcomes.values():
        assert "device.dispatch" in outcome["reason"]
    assert _events("device.dispatch").get("injected", 0) >= 1
    health = daemon.healthz()
    assert health["ok"] is False and "device" in health["reason"]
    assert chaos_env.serve_requests_requeued == 0
    assert daemon_mod.wait_until_stopped(daemon) == 2


def test_serve_worker_hang_bounded_and_requeued_once(chaos_env):
    """A wedged serve worker is deadline-killed and the request completes
    through one requeue, in a wall bounded by the deadlines and the
    analysis, never by the injected sleep."""
    _serve_baseline()
    full_reset()
    chaos_env.reset()
    chaos_env.enabled = True
    start = time.monotonic()
    outcomes = _serve_run(spec="serve.worker:hang:n1", deadline_s=4.0)
    assert time.monotonic() - start < 90.0
    assert outcomes["alice"]["status"] == "ok"
    assert outcomes["bob"]["status"] == "ok"
    assert chaos_env.serve_requests_requeued >= 1
    assert chaos_env.resilience_deadline_trips >= 1
    assert chaos_env.serve_requests_incomplete == 0


def test_serve_corrupt_disk_entry_degrades_to_safe_miss_per_request(
        chaos_env):
    """disk.entry:corrupt through the daemon: a warm disk tier whose
    entries are corrupted mid-serve quarantines per lookup and re-solves,
    every tenant's findings those of the no-fault serve."""
    baseline = _serve_baseline()
    full_reset()
    populate = _serve_run()
    for tenant in ("alice", "bob"):
        assert issue_set(populate[tenant]["issues"]) == \
            issue_set(baseline[tenant]["issues"])
    full_reset()  # the memory tiers go; the disk tier survives
    chaos_env.reset()
    chaos_env.enabled = True
    faulted = _serve_run(spec="disk.entry:corrupt:*")
    for tenant in ("alice", "bob"):
        assert faulted[tenant]["status"] == "ok"
        assert issue_set(faulted[tenant]["issues"]) == \
            issue_set(baseline[tenant]["issues"])
    assert _events("disk.entry").get("quarantine", 0) >= 1
