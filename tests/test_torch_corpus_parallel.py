"""Corpus runs in --jobs worker processes (core._fire_lasers_parallel) and
the worker merge: the counterparts of tests/test_corpus_parallel.py and
tests/test_parallel_semantics.py, with the port's own rule that a
DeviceFault from a worker stops the run and is never rerun in process.

  cli        --jobs 2 against --jobs 1 through the port's CLI on two
             bench_inputs/corpus contracts (host backend): the same
             findings per contract;
  semantics  against a scripted pool (no processes): only the incomplete
             contracts rerun, a keyboard interrupt keeps what is done,
             contract order is kept, a DeviceFault is re-raised;
  merge      SolverStatistics.absorb, Tracer.drain_events/absorb_events
             and metrics.merge_snapshots.

The jobs.worker fault cases (exit, raise) are in tests/test_torch_chaos.py.
"""

import json
import multiprocessing
import os
import subprocess
import sys

import pytest

from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
from mythril_tpu_torch.observe import get_tracer, metrics
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ("xc_dispatch_a.hex", "xc_dispatch_b.hex")


@pytest.fixture(autouse=True)
def fresh_stats():
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    get_tracer().reset()
    args.reset()
    yield stats
    get_tracer().reset()
    stats.reset()
    args.reset()


# -- the CLI ------------------------------------------------------------------


def _cli(jobs: int, tmp_path):
    cmd = [sys.executable, "-m", "mythril_tpu_torch", "analyze"]
    for name in CORPUS:
        cmd += ["-f", os.path.join(REPO_ROOT, "bench_inputs", "corpus",
                                   name)]
    cmd += ["-t", "1", "--pruning-factor", "1", "--solver-backend", "cpu",
            "-o", "json", "--jobs", str(jobs)]
    stats_path = tmp_path / f"stats-{jobs}.json"
    env = {key: value for key, value in os.environ.items()
           if not key.startswith("MYTHRIL_GPU_")}
    env.update(MYTHRIL_GPU_STATS_JSON=str(stats_path),
               MYTHRIL_GPU_FLIGHTREC_DIR=str(tmp_path / "rec"))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=REPO_ROOT, env=env)
    assert proc.returncode == 1, proc.stderr[-2000:]  # issues found
    report = json.loads(proc.stdout)
    keys = sorted((issue["contract"], issue["swc-id"], issue["function"],
                   issue["address"], issue["title"])
                  for issue in report["issues"])
    return keys, json.loads(stats_path.read_text())


def test_jobs_two_matches_jobs_one_through_the_cli(tmp_path):
    """Two corpus contracts in two spawn workers find what the one-process
    run finds, per contract at issue granularity; the workers' statistics
    come back merged into the parent's stats JSON."""
    sequential, seq_stats = _cli(1, tmp_path)
    parallel, par_stats = _cli(2, tmp_path)
    assert sequential == parallel
    assert {contract for contract, *_rest in sequential} == set(CORPUS)
    assert par_stats["completed"] is True
    assert par_stats["query_count"] > 0
    assert par_stats["frontier_vmap_steps"] > 0
    assert seq_stats["completed"] is True


# -- the scripted pool -------------------------------------------------------


class FakeContract:
    def __init__(self, name):
        self.name = name


class ScriptedPool:
    """imap_unordered yields scripted results, then raises `error`."""

    def __init__(self, results, error=None):
        self._results = results
        self._error = error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def imap_unordered(self, fn, payloads):
        for result in self._results:
            yield result
        if self._error is not None:
            raise self._error


class ScriptedContext:
    def __init__(self, pool):
        self._pool = pool

    def Pool(self, processes):
        return self._pool


def _analyzer(n_contracts):
    disassembler = MythrilDisassembler()
    disassembler.contracts = [FakeContract(f"c{i}")
                              for i in range(n_contracts)]
    return MythrilAnalyzer(disassembler)


def _patch_pool(monkeypatch, pool):
    monkeypatch.setattr(
        multiprocessing, "get_context", lambda kind: ScriptedContext(pool))


def _result(idx, issues, exceptions=(), snapshot=None, events=()):
    record = {"pid": 4000 + idx, "contract": idx,
              "launches": {"ragged_round": idx, "frontier_step": 1}}
    return (idx, list(issues), list(exceptions), snapshot or {},
            list(events), record)


def test_worker_failure_reruns_only_incomplete(monkeypatch, fresh_stats):
    args.jobs = 3
    analyzer = _analyzer(3)
    # workers finish contracts 2 and 0 (out of order), then the pool dies
    pool = ScriptedPool(
        results=[
            _result(2, ["issue-c2"], snapshot={"query_count": 7,
                                               "kernel_launches": 3}),
            _result(0, ["issue-c0"], ["boom-c0"],
                    snapshot={"query_count": 5, "kernel_launches": 2},
                    events=[{"name": "laser.exec", "cat": "laser",
                             "ph": "X", "ts": 0.0, "dur": 5.0,
                             "pid": 4242, "tid": 1}]),
        ],
        error=RuntimeError("worker lost"),
    )
    _patch_pool(monkeypatch, pool)
    rerun = []

    def fake_analyze_one(contract, modules, tx_count, stats=None):
        rerun.append(contract.name)
        return [f"issue-{contract.name}-seq"], []

    monkeypatch.setattr(analyzer, "_analyze_one_contract", fake_analyze_one)
    issues, exceptions = analyzer._fire_lasers_parallel(None, 1)
    assert rerun == ["c1"], "only the incomplete contract reruns"
    assert issues == ["issue-c0", "issue-c1-seq", "issue-c2"]
    assert exceptions == ["boom-c0"]
    assert fresh_stats.query_count == 12
    assert fresh_stats.kernel_launches == 5
    assert fresh_stats.resilience_events["jobs.worker"] == {"degraded": 1}
    assert [record["contract"] for record in analyzer.worker_records] == \
        [2, 0]
    merged = get_tracer().drain_events()
    assert any(e["pid"] == 4242 and e["name"] == "laser.exec"
               for e in merged)


def test_device_fault_from_a_worker_is_reraised_not_rerun(monkeypatch):
    """The port's rule: a DeviceFault that comes back through the pool
    stops the run; no contract is analyzed again in this process."""
    from mythril_tpu_torch.gpu.device import DeviceFault

    args.jobs = 2
    analyzer = _analyzer(3)
    pool = ScriptedPool(results=[_result(1, ["issue-c1"])],
                        error=DeviceFault("device path failed"))
    _patch_pool(monkeypatch, pool)
    monkeypatch.setattr(
        analyzer, "_analyze_one_contract",
        lambda *a, **k: pytest.fail("a DeviceFault is never rerun"))
    with pytest.raises(DeviceFault):
        analyzer._fire_lasers_parallel(None, 1)
    assert SolverStatistics().resilience_events == {}


def test_device_fault_pickles_through_the_pool():
    import pickle

    from mythril_tpu_torch.gpu.device import DeviceFault

    error = pickle.loads(pickle.dumps(DeviceFault("device path failed")))
    assert type(error) is DeviceFault
    assert str(error) == "device path failed"


def test_keyboard_interrupt_keeps_completed_work(monkeypatch):
    args.jobs = 2
    analyzer = _analyzer(3)
    pool = ScriptedPool(results=[_result(1, ["issue-c1"])],
                        error=KeyboardInterrupt())
    _patch_pool(monkeypatch, pool)
    rerun = []
    monkeypatch.setattr(
        analyzer, "_analyze_one_contract",
        lambda contract, modules, tx_count, stats=None: (
            rerun.append(contract.name) or ([], [])))
    issues, exceptions = analyzer._fire_lasers_parallel(None, 1)
    assert issues == ["issue-c1"], "completed results survive ^C"
    assert rerun == [], "an interrupt triggers no rerun"
    # the report says which contracts went unanalyzed
    assert len(exceptions) == 2
    assert any("c0" in e for e in exceptions)
    assert any("c2" in e for e in exceptions)


def test_clean_run_keeps_contract_order(monkeypatch):
    args.jobs = 2
    analyzer = _analyzer(2)
    pool = ScriptedPool(results=[_result(1, ["issue-c1"]),
                                 _result(0, ["issue-c0"])])
    _patch_pool(monkeypatch, pool)
    monkeypatch.setattr(
        analyzer, "_analyze_one_contract",
        lambda *a, **k: pytest.fail("nothing to rerun on a clean pass"))
    issues, exceptions = analyzer._fire_lasers_parallel(None, 1)
    assert issues == ["issue-c0", "issue-c1"]
    assert exceptions == []


# -- the worker merge --------------------------------------------------------


def test_absorb_folds_counters_timers_histograms_and_events(fresh_stats):
    worker = {
        "kernel_launches": 4, "kernel_cells_stepped": 100,
        "frontier_vmap_steps": 9, "deadline_runner_calls": 3,
        "deadline_handoff_wall": 0.25, "xcontract_windows": 1,
        "prepare_suffix_hist": {"2-4": 2},
        "interp_opcode_wall": {"SLOAD": [3, 0.5]},
        "resilience": {"sites": {"jobs.worker": {"degraded": 1}}},
    }
    fresh_stats.add_kernel_launch(10)
    fresh_stats.add_interp_opcode_wall("SLOAD", 0.25)
    fresh_stats.absorb(worker)
    fresh_stats.absorb(worker)
    assert fresh_stats.kernel_launches == 9
    assert fresh_stats.kernel_cells_stepped == 210
    assert fresh_stats.frontier_vmap_steps == 18
    assert fresh_stats.deadline_runner_calls == 6
    assert fresh_stats.deadline_handoff_wall == pytest.approx(0.5)
    assert fresh_stats.xcontract_windows == 2
    assert fresh_stats.prepare_suffix_hist == {"2-4": 4}
    assert fresh_stats.interp_opcode_wall["SLOAD"] == [7, 1.25]
    assert fresh_stats.resilience_events["jobs.worker"] == {"degraded": 2}
    fresh_stats.enabled = False
    fresh_stats.absorb(worker)
    assert fresh_stats.kernel_launches == 9, "a disabled parent absorbs none"


def test_absorb_of_a_real_snapshot_doubles_every_counter(fresh_stats):
    for name in SolverStatistics._COUNTERS:
        setattr(fresh_stats, name, 1)
    snapshot = fresh_stats.as_dict()
    fresh_stats.absorb(snapshot)
    assert all(getattr(fresh_stats, name) == 2
               for name in SolverStatistics._COUNTERS)


def test_tracer_drains_and_absorbs_with_a_lane_per_pid(tmp_path):
    from mythril_tpu_torch.observe.tracer import span

    tracer = get_tracer()
    tracer.enable(str(tmp_path / "trace.json"))
    with span("analyze.contract", cat="analyze"):
        pass
    own = tracer.drain_events()
    assert [event["name"] for event in own] == ["analyze.contract"]
    assert tracer.drain_events() == []
    worker = dict(own[0], pid=own[0]["pid"] + 1)
    tracer.absorb_events(own + [worker])
    tracer.absorb_events([])
    path = tracer.write()
    trace = json.load(open(path))
    lanes = {event["pid"]: event["args"]["name"]
             for event in trace["traceEvents"] if event["ph"] == "M"}
    assert lanes[own[0]["pid"]] == "mythril_tpu_torch"
    assert lanes[worker["pid"]].startswith("mythril_tpu_torch worker")
    assert sum(1 for event in trace["traceEvents"] if event["ph"] == "X") \
        == 2


def test_merge_snapshots_sums_counters_and_recomputes_gauges(fresh_stats):
    fresh_stats.add_device_dispatch(2, 4, 0.1)
    fresh_stats.add_window_flush(6)
    fresh_stats.add_interp_opcode_wall("ADD", 0.5)
    from mythril_tpu_torch import resilience

    resilience.record_event("jobs.worker", "worker_requeue", 2)
    first = metrics.snapshot(seq=3, final=True)
    fresh_stats.reset()
    fresh_stats.add_device_dispatch(6, 6, 0.2)
    fresh_stats.add_window_flush(2)
    second = metrics.snapshot(seq=5, final=False)
    merged = metrics.merge_snapshots([first, None, second])
    counters = merged["counters"]
    assert counters["device_dispatches"] == 2
    assert counters["device_dispatched_queries"] == 8
    assert counters["route_device_seconds"] == pytest.approx(0.3)
    assert merged["gauges"]["device_occupancy"] == 0.8
    assert merged["gauges"]["coalesce_occupancy"] == 4.0
    assert merged["histograms"]["interp_opcode_wall"]["ADD"] == [1, 0.5]
    assert merged["resilience"] == {"jobs.worker": {"worker_requeue": 2}}
    assert merged["roofline"] == {}
    assert merged["final"] is False
    assert merged["pid"] == os.getpid()
    assert set(merged["counters"]) == set(first["counters"])
    json.dumps(merged)
    assert metrics.merge_snapshots([])["seq"] == 0


@pytest.mark.parametrize("flag", ["--jobs", "--corpus-interleave"])
def test_no_card_and_no_device_exits_two_before_any_worker(monkeypatch,
                                                           capsys, flag):
    """With no CUDA card and no --torch-device, a corpus run stops with
    exit 2 in the parent: no worker process and no slot thread starts."""
    import threading

    import torch

    from mythril_tpu_torch.interfaces import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(
        multiprocessing, "get_context",
        lambda kind: pytest.fail("a worker pool was started"))
    started = []
    monkeypatch.setattr(threading.Thread, "start",
                        lambda thread: started.append(thread.name))
    argv = ["myth-gpu", "analyze"]
    for name in CORPUS:
        argv += ["-f", os.path.join(REPO_ROOT, "bench_inputs", "corpus",
                                    name)]
    monkeypatch.setattr(sys, "argv", argv + ["-t", "1", flag, "2"])
    with pytest.raises(SystemExit) as exited:
        cli.main()
    assert exited.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not [name for name in started
                if name.startswith("mythril-interleave-")]
