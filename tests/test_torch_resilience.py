"""The port's fault-containment layer (mythril_tpu_torch/resilience/), the
counterparts of tests/test_resilience.py: the registry held to the JAX
package's, the breaker state machine, the hard deadline runner, the
injection harness's grammar and seeded schedules, jittered retries and
session fuses, stale-lock breaking (support/lock.py), per-query flush
isolation (service/scheduler.py, with a DeviceFault never retried) and
cache-corruption quarantine (service/store.py). The end-to-end property
lives in tests/test_torch_chaos.py."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from mythril_tpu.resilience import faults as reference_faults
from mythril_tpu.resilience import registry as reference_registry
from mythril_tpu_torch import resilience
from mythril_tpu_torch.resilience import breaker as breaker_mod
from mythril_tpu_torch.resilience import deadline as deadline_mod
from mythril_tpu_torch.resilience import faults, registry
from mythril_tpu_torch.resilience.breaker import StageBreaker
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics


@pytest.fixture(autouse=True)
def fresh_resilience_state():
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    resilience.reset_session()
    faults.configure(None)
    yield
    faults.configure(None)
    reference_faults.configure(None)
    resilience.reset_session()
    deadline_mod.reset()
    stats.reset()


# -- the registry ---------------------------------------------------------------


def test_registry_equals_the_reference_sites_kinds_and_actions():
    """The same 17 sites with the same layer-independent contract (name,
    action, kinds); the device sites say that the analysis stops."""
    registry.validate()
    assert {name: (site.action, site.kinds)
            for name, site in registry.FAULT_SITES.items()} == {
        name: (site.action, site.kinds)
        for name, site in reference_registry.FAULT_SITES.items()}
    assert registry.KINDS == reference_registry.KINDS
    assert registry.ACTIONS == reference_registry.ACTIONS
    for name in ("device.dispatch", "device.calibrate", "frontier.step"):
        assert registry.DEVICE_FAULT_STOPS in \
            registry.FAULT_SITES[name].degrades_to
        assert "host CDCL" not in registry.FAULT_SITES[name].degrades_to


def test_not_ported_names_the_corpus_and_serve_sites():
    """The corpus runs brought jobs.worker: it is registered and no longer
    exempt; the serve and fleet sites wait for item 9."""
    assert set(registry.NOT_PORTED) == {
        "serve.request", "serve.admission", "serve.worker",
        "fleet.shard", "fleet.route", "netstore.entry"}
    assert "jobs.worker" in registry.FAULT_SITES
    assert "jobs.worker" not in registry.NOT_PORTED
    assert set(registry.NOT_PORTED.values()) == {9}


# -- event accounting ---------------------------------------------------------


def test_record_event_bumps_scalar_and_per_site():
    resilience.record_event("disk.entry", "quarantine")
    resilience.record_event("disk.entry", "quarantine")
    resilience.record_event("device.dispatch", "breaker_trip")
    stats = SolverStatistics()
    assert stats.resilience_quarantines == 2
    assert stats.resilience_breaker_trips == 1
    assert stats.resilience_events["disk.entry"]["quarantine"] == 2
    assert stats.resilience_events["device.dispatch"]["breaker_trip"] == 1


def test_resilience_section_zero_filled():
    """The stats JSON resilience section lists every registered site (a
    stable shape), with the events recorded and the armed spec."""
    resilience.record_event("scheduler.flush", "retry")
    out = SolverStatistics().as_dict()
    assert set(out["resilience"]["sites"]) == set(registry.FAULT_SITES)
    assert out["resilience"]["sites"]["scheduler.flush"] == {"retry": 1}
    assert out["resilience"]["sites"]["disk.entry"] == {}
    assert out["resilience"]["faults_active"] == ""
    assert SolverStatistics().resilience_retries == 1


def test_active_spec_reaches_stats_json():
    faults.configure("disk.entry:corrupt:n1")
    assert SolverStatistics().as_dict()["resilience"]["faults_active"] \
        == "disk.entry:corrupt:n1"


# -- breaker (the cases test_torch_router.py does not carry) -------------------


def test_breaker_opens_on_count_threshold_and_reprobes():
    breaker = StageBreaker("device.dispatch", failure_threshold=3,
                           cooldown_s=0.05)
    for _ in range(2):
        breaker.record_failure()
        assert breaker.allow()
    breaker.record_failure()
    assert breaker.state == breaker_mod.OPEN
    assert not breaker.allow(), "open breaker refuses during cooldown"
    time.sleep(0.06)
    assert breaker.allow(), "cooldown elapsed: one half-open probe admitted"
    assert breaker.state == breaker_mod.HALF_OPEN
    assert not breaker.allow(), "only ONE probe in flight"
    breaker.record_success()
    assert breaker.state == breaker_mod.CLOSED
    assert breaker.failures == 0


def test_breaker_reprobe_failure_reopens():
    breaker = StageBreaker("device.dispatch", failure_threshold=1,
                           cooldown_s=0.05)
    breaker.record_failure()
    time.sleep(0.06)
    assert breaker.allow()
    breaker.record_failure()
    assert breaker.state == breaker_mod.OPEN
    assert not breaker.allow()


def test_breaker_outcome_less_probe_admission_expires():
    breaker = StageBreaker("device.dispatch", failure_threshold=1,
                           cooldown_s=0.05)
    breaker.record_failure()
    time.sleep(0.06)
    assert breaker.allow(), "cooldown elapsed: probe admitted"
    assert not breaker.allow(), "probe still notionally in flight"
    time.sleep(0.06)
    assert breaker.allow(), "outcome-less probe expired: fresh probe"
    breaker.record_success()
    assert breaker.state == breaker_mod.CLOSED


def test_breaker_half_open_zero_hit_probe_does_not_retrip():
    breaker = StageBreaker("device.dispatch", failure_threshold=1,
                           waste_budget_s=1.0, cooldown_s=0.05)
    breaker.record_failure()
    time.sleep(0.06)
    assert breaker.allow(), "probe admitted"
    breaker.record_failure(wasted_s=0.2, count=False)  # clean zero-hit
    assert breaker.state == breaker_mod.HALF_OPEN
    breaker.record_success()
    assert breaker.state == breaker_mod.CLOSED


def test_breaker_hard_failure_trips_immediately():
    breaker = StageBreaker("device.dispatch", failure_threshold=99,
                           cooldown_s=60.0)
    breaker.record_failure(hard=True)
    assert breaker.state == breaker_mod.OPEN
    assert SolverStatistics().resilience_breaker_trips == 1


def test_breaker_waste_budget_without_error_counting():
    breaker = StageBreaker("device.dispatch", failure_threshold=1,
                           waste_budget_s=1.0, cooldown_s=60.0)
    breaker.record_failure(wasted_s=0.6, count=False)
    assert breaker.state == breaker_mod.CLOSED
    assert breaker.failures == 0
    breaker.record_failure(wasted_s=0.6, count=False)
    assert breaker.state == breaker_mod.OPEN, "waste budget burned"


# -- hard deadline runner -------------------------------------------------------


def test_deadline_returns_value_and_propagates_exceptions():
    assert deadline_mod.run_with_deadline(
        "device.dispatch", lambda: 41 + 1, 5.0) == 42
    with pytest.raises(ValueError):
        deadline_mod.run_with_deadline(
            "device.dispatch", lambda: (_ for _ in ()).throw(
                ValueError("inner")), 5.0)


def test_deadline_trips_on_wedged_call_and_recovers():
    release = threading.Event()
    start = time.monotonic()
    with pytest.raises(deadline_mod.StageDeadlineExceeded):
        deadline_mod.run_with_deadline(
            "device.dispatch", lambda: release.wait(30.0), 0.1)
    assert time.monotonic() - start < 5.0, "rescued at the deadline"
    stats = SolverStatistics()
    assert stats.resilience_deadline_trips == 1
    assert stats.resilience_events["device.dispatch"] == {"deadline": 1}
    wedged = deadline_mod._runner
    assert wedged.wedged
    # the wedged runner is abandoned: the NEXT call gets a fresh runner
    # and cannot receive the stale call's (discarded) result
    assert deadline_mod.run_with_deadline(
        "device.dispatch", lambda: "fresh", 5.0) == "fresh"
    assert deadline_mod._runner is not wedged
    release.set()
    wedged._inbox.put(None)
    wedged._thread.join(5.0)
    assert not wedged._thread.is_alive()


def test_deadline_runs_on_one_persistent_thread():
    idents = {deadline_mod.run_with_deadline(
        "device.dispatch", threading.get_ident, 5.0) for _ in range(5)}
    assert len(idents) == 1
    assert threading.get_ident() not in idents


def test_runner_counts_its_handoff_without_the_call(monkeypatch):
    """Each guarded call counts once; its hand-off leaves out the call's
    own wall on the runner (here a 0.2 s sleep)."""
    for _ in range(3):
        deadline_mod.run_with_deadline(
            "device.dispatch", lambda: time.sleep(0.2), 5.0)
    stats = SolverStatistics()
    assert stats.deadline_runner_calls == 3
    assert 0.0 <= stats.deadline_handoff_wall < 0.2
    assert stats.as_dict()["deadline_runner_calls"] == 3


def test_no_runner_runs_inline_and_records_degraded(monkeypatch):
    def no_thread():
        raise RuntimeError("can't start new thread")

    monkeypatch.setattr(deadline_mod, "_get_runner", no_thread)
    assert deadline_mod.run_with_deadline(
        "device.dispatch", threading.get_ident, 5.0) == threading.get_ident()
    stats = SolverStatistics()
    assert stats.resilience_events["device.dispatch"] == {"degraded": 1}
    assert stats.deadline_runner_calls == 0


def test_nonpositive_deadline_runs_inline():
    assert deadline_mod.run_with_deadline("x", lambda: 7, 0) == 7
    assert deadline_mod.run_with_deadline("x", lambda: 7, -1.0) == 7
    assert deadline_mod.run_with_deadline(
        "x", threading.get_ident, 0) == threading.get_ident()


def test_deadline_trip_dumps_the_flight_recorder(tmp_path, monkeypatch):
    from mythril_tpu_torch.observe import flightrec

    monkeypatch.setenv(flightrec.DIR_ENV, str(tmp_path))
    flightrec.reset()
    flightrec.install()
    release = threading.Event()
    with pytest.raises(deadline_mod.StageDeadlineExceeded):
        deadline_mod.run_with_deadline(
            "device.dispatch", lambda: release.wait(30.0), 0.05)
    release.set()
    flightrec.reset()
    dumps = [name for name in os.listdir(tmp_path) if name.endswith(".json")]
    assert len(dumps) == 1
    artifact = json.load(open(tmp_path / dumps[0]))
    assert artifact["trigger"] == {"site": "device.dispatch",
                                   "event": "deadline"}
    assert "resilience.deadline" in [e["name"] for e in artifact["events"]]


# -- fault-injection harness ------------------------------------------------------


def test_spec_parse_rejects_unknown_site_kind_trigger():
    with pytest.raises(ValueError):
        faults.parse_spec("no.such.site:raise:n1")
    with pytest.raises(ValueError):
        faults.parse_spec("disk.entry:hang:n1")  # kind not meaningful there
    with pytest.raises(ValueError):
        faults.parse_spec("disk.entry:raise:whenever")
    with pytest.raises(ValueError):
        faults.parse_spec("disk.entry:raise")


def test_spec_rejects_duplicate_site():
    with pytest.raises(ValueError):
        faults.parse_spec("disk.entry:corrupt:n1,disk.entry:raise:n2")


def test_nth_trigger_fires_exactly_once():
    faults.configure("prepare.incremental:raise:n3")
    fired = 0
    for _ in range(6):
        try:
            faults.maybe_inject("prepare.incremental")
        except faults.InjectedFault:
            fired += 1
    assert fired == 1
    assert SolverStatistics().resilience_faults_injected == 1


def _rate_schedule(module, spec, crossings=32):
    module.configure(spec)
    hits = []
    for _ in range(crossings):
        try:
            module.maybe_inject("prepare.incremental")
            hits.append(False)
        except module.InjectedFault:
            hits.append(True)
    module.configure(None)
    return hits


def test_rate_trigger_reproducible_under_seed_and_equal_to_reference(
        monkeypatch):
    """The same seed gives the same schedule in every run, and the port's
    schedule equals the JAX package's for the same spec and seed (each
    read from its own knob)."""
    monkeypatch.setenv(faults.SEED_ENV, "7")
    monkeypatch.setenv(reference_faults.SEED_ENV, "7")
    spec = "prepare.incremental:raise:r0.5"
    first = _rate_schedule(faults, spec)
    assert first == _rate_schedule(faults, spec), "same seed, same schedule"
    assert any(first) and not all(first)
    assert first == _rate_schedule(reference_faults, spec)
    monkeypatch.setenv(faults.SEED_ENV, "8")
    assert _rate_schedule(faults, spec) != first


def test_the_port_never_reads_the_reference_knobs(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_FAULTS", "disk.write:raise:*")
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    faults.configure_from_env(None)
    assert faults.active_spec() == ""
    faults.configure_from_env("disk.write:raise:n1")
    assert faults.active_spec() == "disk.write:raise:n1"
    monkeypatch.setenv(faults.FAULTS_ENV, "aig.session:raise:*")
    faults.configure_from_env("disk.write:raise:n1")
    assert faults.active_spec() == "aig.session:raise:*", "env wins"


def test_corrupt_plan_acts_only_on_data_path():
    faults.configure("disk.entry:corrupt:n1")
    # control-path crossings must not consume the data-path trigger
    faults.maybe_inject("disk.entry")
    faults.maybe_inject("disk.entry")
    mangled = faults.corrupt_text("disk.entry", '{"ok": true}')
    assert mangled != '{"ok": true}'
    assert faults.corrupt_text("disk.entry", "later") == "later", \
        "n1 fired exactly once"
    reference_faults.configure("disk.entry:corrupt:n1")
    assert mangled == reference_faults.corrupt_text("disk.entry",
                                                    '{"ok": true}')


def test_hang_and_delay_kinds_block_at_the_site(monkeypatch):
    monkeypatch.setattr(faults, "HANG_SECONDS", 0.05)
    faults.configure("device.dispatch:hang:n1,disk.write:delay:*")
    start = time.monotonic()
    faults.maybe_inject("device.dispatch")
    faults.maybe_inject("disk.write")
    assert time.monotonic() - start >= 0.05 + faults.DELAY_SECONDS * 0.9
    assert SolverStatistics().resilience_faults_injected == 2


def test_disarmed_injection_is_one_check():
    """Disarmed, maybe_inject returns before it looks at the site."""
    faults.configure(None)
    assert faults._plans is None
    faults.maybe_inject("no.such.site")  # not even a lookup
    assert faults.corrupt_text("no.such.site", "text") == "text"
    assert SolverStatistics().resilience_faults_injected == 0


# -- retries + session fuses -------------------------------------------------------


def test_with_retries_retries_then_succeeds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("transient")
        return "ok"

    assert resilience.with_retries("disk.write", flaky,
                                   base_delay_s=0.0001) == "ok"
    assert len(calls) == 2
    assert SolverStatistics().resilience_retries == 1


def test_with_retries_exhaustion_propagates():
    def always():
        raise OSError("permanent")

    with pytest.raises(OSError):
        resilience.with_retries("disk.write", always, attempts=3,
                                base_delay_s=0.0001)
    assert SolverStatistics().resilience_retries == 2


def test_session_fuse_blows_on_deterministic_fault():
    site = "aig.session"
    assert not resilience.fuse_blown(site)
    for _ in range(resilience.FUSE_THRESHOLD):
        blew = resilience.note_stage_failure(site)
    assert blew, "threshold reached: fuse blows"
    assert resilience.fuse_blown(site)
    assert SolverStatistics().resilience_degraded == resilience.FUSE_THRESHOLD
    resilience.reset_session()
    assert not resilience.fuse_blown(site)


def test_hard_stage_failure_blows_fuse_immediately():
    assert resilience.note_stage_failure("prepare.incremental", hard=True)
    assert resilience.fuse_blown("prepare.incremental")


# -- stale lock breaking (support/lock.py) ------------------------------------------


def _flock_holder(path):
    import fcntl

    handle = open(path, "a+")
    fcntl.flock(handle, fcntl.LOCK_EX | fcntl.LOCK_NB)
    return handle


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def test_stale_lock_broken_when_owner_pid_dead(tmp_path):
    from mythril_tpu_torch.support.lock import LockFile

    path = str(tmp_path / "store.lock")
    holder = _flock_holder(path)  # flock conflicts even intra-process
    holder.write(f"{_dead_pid()} {int(time.time())}\n")
    holder.flush()
    lock = LockFile(path, timeout_seconds=30.0)
    start = time.monotonic()
    lock.acquire()
    assert time.monotonic() - start < 5.0, "broke the stale lock, fast"
    assert SolverStatistics().resilience_stale_lock_breaks == 1
    lock.release()
    holder.close()


def test_stale_lock_broken_by_max_age(tmp_path):
    from mythril_tpu_torch.support.lock import LockFile

    path = str(tmp_path / "store.lock")
    holder = _flock_holder(path)
    holder.write(f"{os.getpid()} {int(time.time())}\n")  # owner "alive"
    holder.flush()
    old = time.time() - 3600
    os.utime(path, (old, old))
    lock = LockFile(path, timeout_seconds=30.0, stale_age_seconds=60.0)
    start = time.monotonic()
    lock.acquire()
    assert time.monotonic() - start < 5.0
    assert SolverStatistics().resilience_stale_lock_breaks == 1
    lock.release()
    holder.close()


def test_live_fresh_holder_is_not_broken(tmp_path):
    from mythril_tpu_torch.support.lock import LockFile

    path = str(tmp_path / "store.lock")
    holder = _flock_holder(path)
    holder.write(f"{os.getpid()} {int(time.time())}\n")
    holder.flush()
    lock = LockFile(path, timeout_seconds=0.3)
    lock.acquire()  # returns (degraded), does not deadlock
    assert SolverStatistics().resilience_stale_lock_breaks == 0
    assert SolverStatistics().resilience_degraded == 1
    lock.release()
    holder.close()


def test_orphaned_inode_flock_is_not_mutual_exclusion(tmp_path, monkeypatch):
    import fcntl

    from mythril_tpu_torch.support.lock import LockFile

    path = str(tmp_path / "store.lock")
    lock = LockFile(path, timeout_seconds=0.5)
    real_flock = fcntl.flock
    raced = []

    def racing_flock(handle, flags):
        result = real_flock(handle, flags)
        if not raced and flags & fcntl.LOCK_EX:
            raced.append(True)
            os.unlink(path)
            open(path, "a+").close()
        return result

    monkeypatch.setattr(fcntl, "flock", racing_flock)
    lock.acquire()
    assert lock._holds_current_inode()
    assert SolverStatistics().resilience_degraded == 0
    lock.release()


def test_lock_normal_acquire_release(tmp_path):
    from mythril_tpu_torch.support.lock import LockFile

    path = str(tmp_path / "plain.lock")
    with LockFile(path) as lock:
        assert lock._handle is not None
        with open(path) as fd:
            assert int(fd.read().split()[0]) == os.getpid()
    assert SolverStatistics().resilience_degraded == 0


def test_injected_lock_fault_degrades_to_unlocked(tmp_path):
    from mythril_tpu_torch.support.lock import LockFile

    faults.configure("store.lock:raise:n1")
    with LockFile(str(tmp_path / "x.lock")) as lock:
        assert lock._handle is None  # unlocked: atomic renames keep it safe
    assert SolverStatistics().resilience_events["store.lock"] == {
        "injected": 1, "degraded": 1}
    with LockFile(str(tmp_path / "x.lock")) as lock:
        assert lock._handle is not None  # n1: the next acquire locks


# -- coalesced flush isolation (service/scheduler.py) -------------------------------


def _scheduler(monkeypatch, fake):
    from mythril_tpu_torch.service.scheduler import CoalescingScheduler
    from mythril_tpu_torch.support import model as model_mod

    monkeypatch.setattr(model_mod, "get_models_batch", fake)
    scheduler = CoalescingScheduler()
    scheduler.max_batch = 16
    return scheduler


def test_flush_failure_poisons_only_the_failing_query(monkeypatch):
    """A query raising inside a coalesced flush fails ONLY its own handle:
    the window is retried query by query, siblings get their real
    verdicts, and only the lone failure degrades to unknown."""
    poison = ["BAD"]

    def fake_get_models_batch(constraint_sets, crosscheck=None,
                              origins=None, fork_pairs=None):
        if any(cs == poison for cs in constraint_sets):
            raise RuntimeError("poisoned query")
        return [("sat", object()) for _ in constraint_sets]

    scheduler = _scheduler(monkeypatch, fake_get_models_batch)
    good_a = scheduler.submit(["A"])
    bad = scheduler.submit(poison)
    good_b = scheduler.submit(["B"])
    scheduler.flush()
    assert good_a.result()[0] == "sat"
    assert good_b.result()[0] == "sat"
    assert bad.result() == ("unknown", None)
    stats = SolverStatistics()
    assert stats.resilience_events["scheduler.flush"]["retry"] == 1
    assert stats.resilience_events["scheduler.flush"]["degraded"] == 1


def test_flush_success_path_untouched(monkeypatch):
    calls = []

    def fake_get_models_batch(constraint_sets, crosscheck=None,
                              origins=None, fork_pairs=None):
        calls.append(len(constraint_sets))
        return [("unsat", None) for _ in constraint_sets]

    scheduler = _scheduler(monkeypatch, fake_get_models_batch)
    handles = [scheduler.submit([f"q{i}"]) for i in range(3)]
    scheduler.flush()
    assert calls == [3], "one batched call, no per-query retries"
    assert all(h.result() == ("unsat", None) for h in handles)
    assert SolverStatistics().resilience_events.get("scheduler.flush") \
        is None


def test_injected_flush_fault_retries_each_query(monkeypatch):
    calls = []

    def fake_get_models_batch(constraint_sets, crosscheck=None,
                              origins=None, fork_pairs=None):
        calls.append(len(constraint_sets))
        return [("sat", object()) for _ in constraint_sets]

    scheduler = _scheduler(monkeypatch, fake_get_models_batch)
    faults.configure("scheduler.flush:raise:n1")
    handles = [scheduler.submit([f"q{i}"]) for i in range(3)]
    scheduler.flush()
    assert calls == [1, 1, 1]
    assert all(h.result()[0] == "sat" for h in handles)
    assert SolverStatistics().resilience_events["scheduler.flush"] == {
        "injected": 1, "retry": 1}


@pytest.mark.parametrize("error", ["DeviceFault", "NoDeviceError"])
def test_device_fault_in_a_flush_propagates_unretried(monkeypatch, error):
    """A device error is not a host error: it reaches the demanding caller
    at once, K1's seam is entered once (never again query by query), and
    every popped handle degrades to unknown so none dangles."""
    from mythril_tpu_torch.gpu import device

    fault = getattr(device, error)
    calls = []

    def fake_get_models_batch(constraint_sets, crosscheck=None,
                              origins=None, fork_pairs=None):
        calls.append(len(constraint_sets))
        raise fault("K1 failed")

    scheduler = _scheduler(monkeypatch, fake_get_models_batch)
    handles = [scheduler.submit([f"q{i}"]) for i in range(3)]
    with pytest.raises(fault):
        scheduler.flush()
    assert calls == [3]
    assert all(h.done and h.result() == ("unknown", None) for h in handles)
    assert "scheduler.flush" not in SolverStatistics().resilience_events


def test_device_fault_in_a_per_query_retry_propagates(monkeypatch):
    from mythril_tpu_torch.gpu.device import DeviceFault

    calls = []

    def fake_get_models_batch(constraint_sets, crosscheck=None,
                              origins=None, fork_pairs=None):
        calls.append(len(constraint_sets))
        if len(calls) == 1:
            raise RuntimeError("host error")
        raise DeviceFault("K1 failed")

    scheduler = _scheduler(monkeypatch, fake_get_models_batch)
    for i in range(3):
        scheduler.submit([f"q{i}"])
    with pytest.raises(DeviceFault):
        scheduler.flush()
    assert calls == [3, 1], "the retry stops at the first DeviceFault"
    assert SolverStatistics().resilience_events["scheduler.flush"] == {
        "retry": 1}


# -- cache-corruption quarantine (service/store.py) -----------------------------------


def _store(tmp_path):
    from mythril_tpu_torch.service.store import PersistentResultStore

    return PersistentResultStore(root=str(tmp_path / "solve-cache"))


@pytest.mark.parametrize("mangle", [
    pytest.param(lambda text: text[: len(text) // 2], id="truncated"),
    pytest.param(lambda text: "\x00\xff garbage not json", id="garbage"),
    pytest.param(
        lambda text: json.dumps(
            dict(json.loads(text), schema=999)), id="wrong-version"),
    pytest.param(
        lambda text: json.dumps(
            dict(json.loads(text), bits="!!!not-base64!!!")),
        id="bad-blob"),
])
def test_corrupt_entry_quarantined_and_safe_miss(tmp_path, mangle):
    store = _store(tmp_path)
    fingerprint = "cafe" * 16
    assert store.store_sat(fingerprint, 8, [True] * 9)
    path = store._path(fingerprint)
    with open(path) as fd:
        text = fd.read()
    with open(path, "w") as fd:
        fd.write(mangle(text))
    before = SolverStatistics().persistent_verify_rejects
    assert store.lookup(fingerprint) is None, "safe miss, not a crash"
    assert SolverStatistics().persistent_verify_rejects == before + 1
    assert SolverStatistics().resilience_quarantines == 1
    assert not os.path.exists(path), "corrupt entry moved aside"
    assert os.path.exists(path + ".quarantined"), "kept for forensics"
    assert store.lookup(fingerprint) is None, "quarantined: never re-read"
    assert SolverStatistics().resilience_quarantines == 1


def test_injected_entry_faults_quarantine(tmp_path):
    store = _store(tmp_path)
    for fingerprint in ("a1" * 32, "b2" * 32):
        assert store.store_unsat(fingerprint, crosschecked=True)
    faults.configure("disk.entry:raise:n1")
    assert store.lookup("a1" * 32) is None
    assert store.lookup("b2" * 32).verdict == "unsat"
    faults.configure("disk.entry:corrupt:*")
    assert store.lookup("b2" * 32) is None
    assert SolverStatistics().resilience_events["disk.entry"] == {
        "injected": 2, "quarantine": 2}


def test_quarantine_corpses_bounded(tmp_path):
    store = _store(tmp_path)
    keep = store._QUARANTINE_KEEP
    now = time.time()
    for i in range(keep + 5):
        fingerprint = f"{i:04x}" * 16
        assert store.store_unsat(fingerprint, crosschecked=True)
        path = store._path(fingerprint)
        with open(path, "w") as fd:
            fd.write("garbage")
        os.utime(path, (now - (keep + 5) + i, now - (keep + 5) + i))
        assert store.lookup(fingerprint) is None
    corpses = [name for name in os.listdir(store.root)
               if name.endswith(".quarantined")]
    assert len(corpses) == keep
    assert f"{keep + 4:04x}" * 16 + ".json.quarantined" in corpses


def test_healthy_entry_roundtrip_unaffected(tmp_path):
    store = _store(tmp_path)
    fingerprint = "beef" * 16
    bits = [True, False] * 4 + [True]
    assert store.store_sat(fingerprint, 8, bits)
    entry = store.lookup(fingerprint)
    assert entry is not None and entry.verdict == "sat"
    assert entry.bits == bits
    assert SolverStatistics().resilience_quarantines == 0


def test_injected_disk_write_fault_retries(tmp_path):
    """disk.write is a retry site: a transient write fault costs one
    jittered retry, not the entry."""
    store = _store(tmp_path)
    faults.configure("disk.write:raise:n1")
    assert store.store_unsat("feed" * 16, crosschecked=True)
    stats = SolverStatistics()
    assert stats.resilience_retries == 1
    assert stats.resilience_faults_injected == 1
    entry = store.lookup("feed" * 16)
    assert entry is not None and entry.verdict == "unsat"


def test_persistent_disk_write_fault_degrades_to_not_persisted(tmp_path):
    store = _store(tmp_path)
    faults.configure("disk.write:raise:*")
    assert not store.store_unsat("dead" * 16, crosschecked=True)
    assert store.lookup("dead" * 16) is None
    assert SolverStatistics().resilience_events["disk.write"] == {
        "injected": 2, "retry": 1, "degraded": 1}
