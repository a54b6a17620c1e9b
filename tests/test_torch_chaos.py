"""The port's chaos suite (the counterparts of tests/test_chaos.py's
non-serve cases): under every injected fault at a host site, `analyze`
completes with the findings of the no-fault run at issue granularity and
the stats JSON `resilience` section records the matching event; under a
fault at a device site (device.dispatch raising or hanging,
device.calibrate, frontier.step with the cuda step forced) the analysis
stops with a recorded DeviceFault, the CLI exits 2 and the event is
recorded. Runs take the device backend on `--torch-device cpu`, so K1's
plain version runs behind the same seam the card takes.

Faults are armed through the production path (`--inject-fault` ->
args.inject_fault -> faults.configure_from_env in fire_lasers)."""

import glob
import json
import os
import sys
import time
from types import SimpleNamespace

import pytest

from mythril_tpu_torch.resilience import deadline as deadline_mod
from mythril_tpu_torch.resilience import faults, registry
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args
from tests.test_analysis import KILLBILLY, OVERFLOW_ADD, wrap_creation
from tests.torch_helpers import issue_keys

EXECUTION_TIMEOUT = 60  # s, never reached by these contracts


def _full_reset():
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.support.model import clear_caches

    args.reset()
    clear_caches()  # the router, the session fuses and the store handle too
    frontend._global_blaster = None
    deadline_mod.reset()
    faults.configure(None)


@pytest.fixture(autouse=True)
def chaos_env(tmp_path, monkeypatch):
    """Fresh pipeline state per test, a private disk tier under
    solve_cache "disk" (so the disk.entry, disk.write and store.lock sites
    engage), calibration off unless a test is about it."""
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_FLIGHTREC_DIR", str(tmp_path / "rec"))
    stats = SolverStatistics()
    _full_reset()
    stats.reset()
    yield
    _full_reset()
    stats.reset()


def _analyze(code_hex: str, tx_count: int, spec=None):
    """One in-process analyze on the device backend (K1's plain version),
    fork pruning on, the disk tier on and `spec` armed through
    --inject-fault. Returns the report; asserts it is whole."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.smt.solver import frontend

    args.reset()
    frontend._global_blaster = None
    cmd_args = SimpleNamespace(
        execution_timeout=EXECUTION_TIMEOUT, transaction_count=tx_count,
        max_depth=128, solver_backend="gpu", torch_device="cpu",
        pruning_factor=1, solve_cache="disk", inject_fault=spec)
    try:
        disassembler = MythrilDisassembler()
        disassembler.load_from_bytecode(code_hex)
        report = MythrilAnalyzer(disassembler, cmd_args=cmd_args,
                                 strategy="bfs").fire_lasers(
            transaction_count=tx_count)
    finally:
        args.reset()
    assert not report.exceptions, report.exceptions
    return report


def _events(site: str) -> dict:
    """The per-site record of the stats JSON resilience section."""
    return SolverStatistics().as_dict()["resilience"]["sites"][site]


_BASELINES = {}


def _baseline(code_hex: str, tx_count: int):
    """The no-fault findings of (contract, tx count), from fresh state on
    a fresh disk tier."""
    key = (code_hex, tx_count)
    if key not in _BASELINES:
        _full_reset()
        _BASELINES[key] = issue_keys(_analyze(code_hex, tx_count))
        _full_reset()
        import shutil

        shutil.rmtree(os.environ["MYTHRIL_GPU_CACHE_DIR"],
                      ignore_errors=True)
    return _BASELINES[key]


# (site, spec, contract, tx, events that must reach the stats JSON)
HOST_MATRIX = [
    pytest.param("preanalysis.summary", "preanalysis.summary:raise:*",
                 KILLBILLY, 1, ("injected", "degraded"),
                 id="preanalysis.summary-raise"),
    pytest.param("prepare.incremental", "prepare.incremental:raise:*",
                 KILLBILLY, 1, ("injected", "degraded"),
                 id="prepare.incremental-raise"),
    pytest.param("aig.session", "aig.session:raise:*",
                 KILLBILLY, 1, ("injected", "degraded"),
                 id="aig.session-raise"),
    pytest.param("frontier.step", "frontier.step:raise:*",
                 KILLBILLY, 1, ("injected", "degraded"),
                 id="frontier.step-raise-numpy-step"),
    pytest.param("disk.write", "disk.write:raise:n1",
                 KILLBILLY, 1, ("injected", "retry"),
                 id="disk.write-raise"),
    pytest.param("disk.write", "disk.write:delay:n1",
                 KILLBILLY, 1, ("injected",), id="disk.write-delay"),
    pytest.param("store.lock", "store.lock:raise:n1",
                 KILLBILLY, 1, ("injected", "degraded"),
                 id="store.lock-raise"),
    pytest.param("scheduler.flush", "scheduler.flush:raise:*",
                 OVERFLOW_ADD, 2, ("injected", "retry"),
                 id="scheduler.flush-raise"),
]


@pytest.mark.parametrize("site,spec,corpus,tx,expected", HOST_MATRIX)
def test_injected_host_fault_preserves_findings(site, spec, corpus, tx,
                                                expected):
    code = wrap_creation(corpus)
    baseline = _baseline(code, tx)
    stats = SolverStatistics()
    stats.reset()
    faulted = _analyze(code, tx, spec=spec)
    assert issue_keys(faulted) == baseline, \
        f"findings changed under injected fault {spec}"
    recorded = _events(site)
    for event in expected:
        assert recorded.get(event, 0) >= 1, (
            f"{spec}: expected a {event!r} event at {site}, got {recorded}")
    assert stats.as_dict()["resilience"]["faults_active"] == spec


_WARM = {}


def _warm_tier(code_hex: str, tx_count: int, tmp_path_factory) -> str:
    """A disk tier filled by one no-fault run (K1's models included),
    made once and copied into each test's cache directory."""
    key = (code_hex, tx_count)
    if key not in _WARM:
        import shutil

        saved = os.environ["MYTHRIL_GPU_CACHE_DIR"]
        folder = str(tmp_path_factory.mktemp("warm"))
        os.environ["MYTHRIL_GPU_CACHE_DIR"] = folder
        try:
            _full_reset()
            stats = SolverStatistics()
            stats.reset()
            findings = issue_keys(_analyze(code_hex, tx_count))
            assert stats.persistent_stores > 0
            assert stats.kernel_launches > 0, "no model of K1 was stored"
            _full_reset()
        finally:
            os.environ["MYTHRIL_GPU_CACHE_DIR"] = saved
        shutil.rmtree(saved, ignore_errors=True)
        _WARM[key] = (folder, findings)
    return _WARM[key]


@pytest.mark.parametrize("spec", [
    pytest.param("disk.entry:corrupt:*", id="disk.entry-corrupt"),
    pytest.param("disk.entry:raise:n1", id="disk.entry-raise"),
])
def test_corrupt_disk_tier_is_a_safe_miss(spec, tmp_path_factory):
    """disk.entry engages on a warm tier: a run with fresh memory tiers on
    a filled directory, with the corruption armed, quarantines every
    poisoned lookup as a safe miss, findings unchanged."""
    import shutil

    code = wrap_creation(KILLBILLY)
    baseline = _baseline(code, 1)
    folder, warm_findings = _warm_tier(code, 1, tmp_path_factory)
    assert warm_findings == baseline
    shutil.copytree(folder, os.environ["MYTHRIL_GPU_CACHE_DIR"],
                    dirs_exist_ok=True)
    stats = SolverStatistics()
    stats.reset()
    assert issue_keys(_analyze(code, 1, spec=spec)) == baseline
    assert _events("disk.entry").get("quarantine", 0) >= 1
    assert stats.persistent_verify_rejects >= 1


def test_multi_site_spec_grammar_end_to_end():
    """The comma grammar arms several sites in one run; every degradation
    lands on the sound path together."""
    spec = ("preanalysis.summary:raise:n1,aig.session:raise:n1,"
            "disk.write:delay:n1")
    code = wrap_creation(KILLBILLY)
    baseline = _baseline(code, 1)
    SolverStatistics().reset()
    assert issue_keys(_analyze(code, 1, spec=spec)) == baseline
    sites = SolverStatistics().as_dict()["resilience"]["sites"]
    for site in ("preanalysis.summary", "aig.session", "disk.write"):
        assert sites[site].get("injected", 0) == 1, sites[site]


# -- the device sites: a recorded DeviceFault and exit 2 ----------------------


def _cli_fault(monkeypatch, tmp_path, spec, *extra):
    """The port's CLI in process on KILLBILLY at -t 2 with `spec` armed:
    (exit code, stats JSON, seconds)."""
    from mythril_tpu_torch.interfaces import cli

    stats_path = tmp_path / "stats.json"
    monkeypatch.setenv("MYTHRIL_GPU_STATS_JSON", str(stats_path))
    monkeypatch.setattr(sys, "argv", [
        "myth-gpu", "analyze", "-c", wrap_creation(KILLBILLY), "-t", "2",
        "--torch-device", "cpu", "--pruning-factor", "1",
        "--execution-timeout", str(EXECUTION_TIMEOUT), "-o", "json",
        "--inject-fault", spec, *extra])
    monkeypatch.setattr(cli, "configure_logging", lambda verbosity: None)
    start = time.monotonic()
    with pytest.raises(SystemExit) as exited:
        cli.main()
    seconds = time.monotonic() - start
    with open(stats_path) as fd:
        return exited.value.code, json.load(fd), seconds


def test_device_dispatch_raise_stops_with_device_fault(monkeypatch, tmp_path,
                                                       capsys):
    code, stats, _s = _cli_fault(monkeypatch, tmp_path,
                                 "device.dispatch:raise:n1")
    assert code == 2
    assert "injected fault at device.dispatch" in capsys.readouterr().err
    assert stats["completed"] is False
    assert stats["resilience"]["sites"]["device.dispatch"] == {"injected": 1}
    assert stats["resilience_faults_injected"] == 1
    assert stats["kernel_launches"] == 0, "no launch after the fault"


def test_device_dispatch_hang_is_abandoned_at_budget_plus_grace(
        monkeypatch, tmp_path):
    """A dispatch that never returns: the deadline runner abandons it at
    the dispatch budget plus MYTHRIL_GPU_STAGE_GRACE, the analysis stops
    with a recorded DeviceFault and exit 2, the stats JSON records the
    deadline event, and the flight recorder dumps on it."""
    from mythril_tpu_torch.observe import flightrec

    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_DEADLINE", "0.5")
    monkeypatch.setenv("MYTHRIL_GPU_STAGE_GRACE", "0.5")
    monkeypatch.setattr(faults, "HANG_SECONDS", 2.0)
    flightrec.reset()
    code, stats, seconds = _cli_fault(monkeypatch, tmp_path,
                                      "device.dispatch:hang:n1")
    wedged = deadline_mod._runner
    assert code == 2
    assert seconds < 0.5 + 0.5 + 30
    assert stats["completed"] is False
    assert stats["resilience"]["sites"]["device.dispatch"] == {
        "injected": 1, "deadline": 1}
    assert stats["resilience_deadline_trips"] == 1
    dumps = [json.load(open(path)) for path in glob.glob(
        os.path.join(os.environ["MYTHRIL_GPU_FLIGHTREC_DIR"], "*.json"))]
    triggers = [dump["trigger"] for dump in dumps]
    assert {"site": "device.dispatch", "event": "deadline"} in triggers
    # the abandoned call ends its sleep and its late dispatch, then the
    # runner thread ends: nothing outlives the test
    assert wedged is not None and wedged.wedged
    deadline_mod.reset()
    wedged._inbox.put(None)
    wedged._thread.join(60.0)
    assert not wedged._thread.is_alive()


def test_device_calibrate_raise_stops_with_device_fault(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "1")
    code, stats, _s = _cli_fault(monkeypatch, tmp_path,
                                 "device.calibrate:raise:n1")
    assert code == 2
    assert stats["resilience"]["sites"]["device.calibrate"] == {
        "injected": 1}
    assert stats["kernel_launches"] == 0


def test_cuda_frontier_step_raise_stops_with_device_fault(monkeypatch,
                                                          tmp_path):
    """frontier.step with the cuda step forced (the device is only
    named): the injected raise reaches the DeviceFault branch, never the
    per-state replay."""
    import torch

    from mythril_tpu_torch.laser.frontier import kernel

    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_BACKEND", "cuda")
    monkeypatch.setattr(kernel, "backend_device",
                        lambda backend: torch.device("cuda"))

    def unreached(run, dense, device):
        raise AssertionError("the injected fault fires before the step")

    monkeypatch.setattr(kernel, "_step_cuda", unreached)
    code, stats, _s = _cli_fault(monkeypatch, tmp_path,
                                 "frontier.step:raise:n1",
                                 "--solver-backend", "cpu")
    assert code == 2
    assert stats["resilience"]["sites"]["frontier.step"] == {"injected": 1}
    assert stats["frontier_vmap_steps"] == 0
    assert stats["resilience_degraded"] == 0, "no per-state replay"


# -- --jobs worker death (core.py) ---------------------------------------------


def _parallel_report(spec=None, jobs=2):
    """KILLBILLY and OVERFLOW_ADD in one run on the device backend (K1's
    plain version), in `jobs` spawn workers, with `spec` armed."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler

    args.reset()
    cmd_args = SimpleNamespace(
        execution_timeout=EXECUTION_TIMEOUT, transaction_count=1,
        max_depth=128, solver_backend="gpu", torch_device="cpu",
        pruning_factor=1, jobs=jobs, inject_fault=spec)
    try:
        disassembler = MythrilDisassembler()
        disassembler.load_from_bytecode(wrap_creation(KILLBILLY))
        disassembler.load_from_bytecode(wrap_creation(OVERFLOW_ADD))
        report = MythrilAnalyzer(disassembler, cmd_args=cmd_args,
                                 strategy="bfs").fire_lasers(
            transaction_count=1)
    finally:
        args.reset()
    assert not report.exceptions, report.exceptions
    return issue_keys(report)


@pytest.mark.parametrize("spec,expected_events", [
    pytest.param("jobs.worker:exit:n1", {"worker_requeue": 1, "degraded": 1},
                 id="jobs.worker-exit"),
    pytest.param("jobs.worker:raise:n1", {"degraded": 1},
                 id="jobs.worker-raise"),
])
def test_worker_death_requeues_then_degrades_in_process(spec,
                                                        expected_events):
    """jobs.worker: `exit` kills every spawn worker at its first crossing
    (a crashed worker's shape): the watchdog sees the death, the pending
    contracts go to a fresh pool once, and when those workers die too the
    corpus is analyzed in this process. `raise` comes back as a worker's
    host error: the contracts are analyzed in this process at once. Both
    find what the one-process run finds."""
    baseline = _parallel_report(jobs=1)
    _full_reset()
    SolverStatistics().reset()
    faulted = _parallel_report(spec=spec)
    assert faulted == baseline, f"findings changed under {spec}"
    assert _events("jobs.worker") == expected_events
    assert SolverStatistics().resilience_worker_requeues == \
        expected_events.get("worker_requeue", 0)


def test_every_wired_site_kind_pair_is_exercised():
    """Every (site, kind) pair the registry declares for a site the port
    wires appears as an injected spec in this file, in
    test_torch_resilience.py, or in the serve and fleet chaos files (the
    fleet's sites cross processes, so their cases live with the
    fleet's)."""
    here = os.path.dirname(os.path.abspath(__file__))
    text = ""
    for name in ("test_torch_chaos.py", "test_torch_resilience.py",
                 "test_torch_chaos_serve.py", "test_torch_fleet.py"):
        with open(os.path.join(here, name), encoding="utf-8") as fd:
            text += fd.read()
    missing = sorted(
        f"{site}:{kind}" for site, entry in registry.FAULT_SITES.items()
        if site not in registry.NOT_PORTED for kind in entry.kinds
        if f"{site}:{kind}:" not in text)
    assert not missing, f"fault kinds no test injects: {missing}"
