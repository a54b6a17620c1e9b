"""The port's observability (mythril_tpu_torch/observe/): the span tracer
and its Perfetto export, the roofline accounting, and the stats JSON that
fire_lasers writes from its finally. The counterparts of
tests/test_observe.py, plus the port's own case: a DeviceFault mid-run
still leaves the stats JSON (completed=false) and a flight-recorder dump,
and the CLI still exits 2."""

import glob
import json
import os
import sys
import threading
import time
from collections import deque

import pytest

from mythril_tpu_torch.observe import flightrec, get_tracer, roofline, span
from mythril_tpu_torch.observe import traced
from mythril_tpu_torch.observe.tracer import NULL_SPAN
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args
from tests.test_analysis import KILLBILLY, wrap_creation

TINY = "0x600035600055600056"


@pytest.fixture(autouse=True)
def fresh_observability_state(tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv(flightrec.DIR_ENV, str(tmp_path / "flightrec"))
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


def _busy(loops=2000):
    total = 0
    for i in range(loops):
        total += i
    return total


def _tiny_analyzer(code=TINY, bin_runtime=True, **options):
    """A host-backend analyzer of `code` (the tiny runtime by default)."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler

    args.solver_backend = "cpu"
    args.execution_timeout = 60
    for name, value in options.items():
        setattr(args, name, value)
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode(code, bin_runtime=bin_runtime)
    return MythrilAnalyzer(disassembler, strategy="bfs")


# -- trace export schema --------------------------------------------------------


def test_trace_export_schema_and_nesting(tmp_path):
    """A valid Chrome trace: every X event carries ph/ts/dur/pid/tid/name,
    and X events on one (pid, tid) lane are disjoint or nested."""
    tracer = get_tracer()
    path = str(tmp_path / "trace.json")
    tracer.enable(path)

    def worker():
        with span("worker.outer", cat="test"):
            with span("worker.inner", cat="test"):
                _busy()

    thread = threading.Thread(target=worker)
    with span("main.outer", cat="test", queries=3) as sp:
        with span("main.inner", cat="test"):
            _busy()
        with span("main.inner", cat="test"):
            _busy()
        sp.set(done=True)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert tracer.write() == path

    payload = json.load(open(path))
    events = payload["traceEvents"]
    x_events = [e for e in events if e["ph"] == "X"]
    assert len(x_events) == 5
    for event in x_events:
        for field in ("name", "ph", "ts", "dur", "pid", "tid"):
            assert field in event, f"missing {field}: {event}"
        assert event["ts"] >= 0 and event["dur"] >= 0
    assert any(e["ph"] == "M" and e["name"] == "process_name"
               for e in events)
    outer = next(e for e in x_events if e["name"] == "main.outer")
    assert outer["args"] == {"queries": 3, "done": True}

    lanes = {}
    for event in x_events:
        lanes.setdefault((event["pid"], event["tid"]), []).append(event)
    assert len(lanes) == 2  # the main thread and the worker
    eps = 0.01  # µs rounding slack
    for lane in lanes.values():
        for a in lane:
            for b in lane:
                if a is b:
                    continue
                a0, a1 = a["ts"], a["ts"] + a["dur"]
                b0, b1 = b["ts"], b["ts"] + b["dur"]
                disjoint = a1 <= b0 + eps or b1 <= a0 + eps
                a_in_b = a0 >= b0 - eps and a1 <= b1 + eps
                b_in_a = b0 >= a0 - eps and b1 <= a1 + eps
                assert disjoint or a_in_b or b_in_a, (a, b)


def test_spans_sum_to_wall_reconciliation(tmp_path):
    """On one lane, children never exceed their parent, and the top span
    never exceeds the measured wall of the traced region."""
    tracer = get_tracer()
    tracer.enable(str(tmp_path / "t.json"))
    wall_start = time.perf_counter()
    with span("root", cat="test"):
        for _ in range(10):
            with span("child", cat="test"):
                with span("grandchild", cat="test"):
                    _busy(500)
    wall = (time.perf_counter() - wall_start) * 1e6
    events = tracer.events()
    by_name = {}
    for event in events:
        by_name.setdefault(event["name"], []).append(event)
    root = by_name["root"][0]
    child_total = sum(e["dur"] for e in by_name["child"])
    grand_total = sum(e["dur"] for e in by_name["grandchild"])
    eps = len(events) * 0.01
    assert grand_total <= child_total + eps
    assert child_total <= root["dur"] + eps
    assert root["dur"] <= wall + eps


# -- roofline accounting --------------------------------------------------------


def test_roofline_wall_decomposition_reconciles():
    """The named components plus the residual sum to the solver wall."""
    stats = SolverStatistics()
    stats.add_prepare_seconds(0.8)
    stats.add_cdcl_settle(clauses=120_000, seconds=0.5)
    stats.add_crosscheck_seconds(0.1)
    stats.add_device_dispatch(queries=2, slots=2, seconds=0.4)
    stats.add_query(2.5)  # the solver wall

    report = roofline.build(stats)
    wall = report["wall"]
    total = wall["solver_total_s"]
    named = (wall["prepare_s"] + wall["settle_s"] + wall["crosscheck_s"]
             + wall["device_s"])
    assert named <= total * 1.05, "components over-count the wall"
    assert named + wall["other_s"] == pytest.approx(total, abs=1e-3)
    assert 0.0 <= wall["attributed_frac"] <= 1.0

    stages = report["stages"]
    assert set(stages) == set(roofline.STAGES)
    settle = stages["settle"]
    assert settle["work"] == 120_000
    assert settle["attained"] == pytest.approx(240_000, rel=0.01)


def test_roofline_emitted_in_stats_json_and_gap_ranking(monkeypatch):
    """The stats JSON carries the roofline with every stage; the ceilings
    are the router's rates (set here, not measured: the ship stage has
    none, as on the card); top_gaps ranks stages with a gap first."""
    from mythril_tpu_torch.gpu import router as router_mod

    router_mod.reset_router()
    try:
        router = router_mod.get_router("cpu")
        # the CPU backend is process-wide: an analyze test run earlier on
        # this worker leaves its stage counters there
        router.backend.reset_stats()
        router._rates = {"kernel_cells_s": 4e7, "pack_bytes_s": 2e8,
                         "ragged_bytes_s": 1e8, "settle_clauses_s": 1e3}
        stats = SolverStatistics()
        stats.add_cdcl_settle(clauses=1000, seconds=2.0)
        out = stats.as_dict()
        stages = out["roofline"]["stages"]
        assert set(stages) == set(roofline.STAGES)
        assert "trace_spans" in out
        assert out["kernel_backend"] == "pallas"
        for stage, rate in (("kernel", 4e7), ("pack", 2e8),
                            ("ragged", 1e8), ("settle", 1e3)):
            assert stages[stage]["attainable"] == rate
        assert stages["ship"]["attainable"] is None
        # 1000 clauses at 1e3/s take 1 s of the 2 s settled
        assert stages["settle"]["sol_gap_s"] == pytest.approx(1.0)
        assert stages["settle"]["headroom"] == pytest.approx(0.5)
        assert roofline.top_gaps(out["roofline"], n=1)[0]["stage"] == \
            "settle"
    finally:
        router_mod.reset_router()
    fake = {"stages": {
        "pack": {"sol_gap_s": 0.5, "attained": 1, "attainable": 2,
                 "units": "bytes/s"},
        "ship": {"sol_gap_s": None, "attained": 1, "attainable": None,
                 "units": "bytes/s"},
        "kernel": {"sol_gap_s": 2.0, "attained": 1, "attainable": 9,
                   "units": "cells/s"},
        "settle": {"sol_gap_s": 0.1, "attained": 1, "attainable": 2,
                   "units": "clauses/s"},
    }}
    top = roofline.top_gaps(fake, n=3)
    assert [row["stage"] for row in top] == ["kernel", "pack", "settle"]


def test_backend_reset_stats_zeroes_its_counters():
    """A run's device figures can start from zero in a long process: the
    counters go, the pack cache stays."""
    from mythril_tpu_torch.gpu.backend import get_device_backend

    backend = get_device_backend("cpu")
    backend.pack_bytes += 5
    backend.solve_seconds += 1.5
    backend.kernel_launches += 2
    cache = backend._pack_cache
    backend.reset_stats()
    stats = backend.stats()
    assert stats["pack_bytes"] == 0 and stats["solve_seconds"] == 0
    assert stats["kernel_launches"] == 0
    assert stats["kernel_backend"] == "pallas"
    assert backend._pack_cache is cache


def test_stale_calibration_entry_still_gains_stage_ceilings(
        tmp_path, monkeypatch):
    """A persisted entry with K1's rate but no stage rates must not leave
    the stages without a ceiling for good: the cache-hit path measures
    the stage rates (no kernel round) and re-persists them."""
    from mythril_tpu_torch.gpu import router as router_mod
    from mythril_tpu_torch.service.calibration import (
        load_profile,
        save_profile,
    )

    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "1")
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    args.solve_cache = "disk"
    router_mod.reset_router()
    try:
        router = router_mod.get_router("cpu")
        platform = router._platform()
        key = (platform, router._profile_restarts(), router._profile_steps())
        save_profile(*key, {"kernel_cells_s": 7e6})
        measured = {"pack_bytes_s": 1e8, "ragged_bytes_s": 2e8,
                    "settle_clauses_s": 3e6}
        monkeypatch.setattr(
            router_mod.QueryRouter, "_measure_kernel_rate",
            lambda self, flat, stream: pytest.fail(
                "the kernel round must stay skipped"))
        monkeypatch.setattr(
            router_mod.QueryRouter, "_measure_stage_rates",
            lambda self: (dict(measured), None))
        router._calibrate()
        rates = router.attainable_rates()
        assert rates["kernel_cells_s"] == pytest.approx(7e6)
        assert rates["pack_bytes_s"] == 1e8
        # re-persisted: the next process loads the rates from disk
        stored = load_profile(*key)
        assert stored["settle_clauses_s"] == pytest.approx(3e6)
        assert stored["kernel_cells_s"] == pytest.approx(7e6)
    finally:
        router_mod.reset_router()


# -- telemetry survives a crashed run ---------------------------------------------


def test_stats_json_written_from_finally_on_module_exception(
        tmp_path, monkeypatch):
    """An exception escaping the per-contract capture still leaves the
    stats JSON (completed=false) and the trace."""
    from mythril_tpu_torch.core import MythrilAnalyzer

    stats_path = str(tmp_path / "stats.json")
    trace_path = str(tmp_path / "trace.json")
    monkeypatch.setenv("MYTHRIL_GPU_STATS_JSON", stats_path)
    monkeypatch.setenv("MYTHRIL_GPU_TRACE", trace_path)
    analyzer = _tiny_analyzer()
    monkeypatch.setattr(
        MythrilAnalyzer, "_analyze_one_contract",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError):
        analyzer.fire_lasers(transaction_count=1)
    payload = json.load(open(stats_path))
    assert payload["completed"] is False
    assert "roofline" in payload
    assert os.path.exists(trace_path)


def test_device_fault_still_writes_stats_json_and_dump(
        tmp_path, monkeypatch):
    """A DeviceFault mid-run (K6 failing on its first step, as in
    test_torch_frontier_analyze) still stops the analysis, but the stats
    JSON (completed=false), the final beat and a run_incomplete dump are
    written first; the CLI exits 2 on the same fault."""
    import torch

    from mythril_tpu_torch.gpu.device import DeviceFault
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.laser.frontier import kernel

    stats_path = tmp_path / "stats.json"
    hb_path = tmp_path / "hb.jsonl"
    monkeypatch.setenv("MYTHRIL_GPU_STATS_JSON", str(stats_path))
    monkeypatch.setenv("MYTHRIL_GPU_HEARTBEAT", str(hb_path))
    monkeypatch.setenv("MYTHRIL_GPU_HEARTBEAT_INTERVAL", "60")
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_BACKEND", "cuda")
    # no card needed: the device is only named, never used
    monkeypatch.setattr(kernel, "backend_device",
                        lambda backend: torch.device("cuda"))

    def broken_step(run, dense, device):
        raise RuntimeError("injected K6 failure")

    monkeypatch.setattr(kernel, "_step_cuda", broken_step)
    analyzer = _tiny_analyzer(wrap_creation(KILLBILLY), bin_runtime=False,
                              pruning_factor=1)
    with pytest.raises(DeviceFault):
        analyzer.fire_lasers(transaction_count=2)
    payload = json.load(open(stats_path))
    assert payload["completed"] is False
    assert set(payload["roofline"]["stages"]) == set(roofline.STAGES)
    assert payload["frontier_vmap_steps"] == 0
    final = json.loads(hb_path.read_text().splitlines()[-1])
    assert final["final"] is True
    dumps = glob.glob(os.path.join(os.environ[flightrec.DIR_ENV], "*.json"))
    assert len(dumps) == 1
    artifact = json.load(open(dumps[0]))
    assert artifact["trigger"]["event"] == flightrec.RUN_INCOMPLETE
    assert "analyze.contract" in {e["name"] for e in artifact["events"]}

    stats_path.unlink()
    args.reset()
    monkeypatch.setattr(sys, "argv", [
        "myth-gpu", "analyze", "-c", wrap_creation(KILLBILLY), "-t", "2",
        "--solver-backend", "cpu", "--pruning-factor", "1",
        "--execution-timeout", "60", "-o", "json"])
    monkeypatch.setattr(cli, "configure_logging", lambda verbosity: None)
    with pytest.raises(SystemExit) as exited:
        cli.main()
    assert exited.value.code == 2
    assert json.load(open(stats_path))["completed"] is False


def test_tiny_analyze_trace_covers_laser_layer(tmp_path, monkeypatch):
    """A real (tiny) analyze with tracing on: a valid trace covering the
    analyze and laser layers, and a completed=true stats dump whose span
    summary names the same spans."""
    stats_path = str(tmp_path / "stats.json")
    trace_path = str(tmp_path / "trace.json")
    monkeypatch.setenv("MYTHRIL_GPU_STATS_JSON", stats_path)
    monkeypatch.setenv("MYTHRIL_GPU_TRACE", trace_path)
    _tiny_analyzer().fire_lasers(transaction_count=1)
    trace = json.load(open(trace_path))
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"analyze.contract", "laser.exec"} <= names
    payload = json.load(open(stats_path))
    assert payload["completed"] is True
    assert set(payload["trace_spans"]) == names


def test_solver_layer_spans_at_the_batch_seam(tmp_path):
    """The solver layer's stages appear in a traced get_models_batch on
    the host path."""
    from mythril_tpu_torch.smt import symbol_factory
    from mythril_tpu_torch.support import model as model_mod
    from mythril_tpu_torch.support.model import get_models_batch

    model_mod.clear_caches()
    args.solver_backend = "cpu"
    tracer = get_tracer()
    tracer.enable(str(tmp_path / "t.json"))
    x = symbol_factory.BitVecSym("obs_x", 64)
    y = symbol_factory.BitVecSym("obs_y", 64)
    outcomes = get_models_batch([
        [x + y == symbol_factory.BitVecVal(99, 64),
         x > symbol_factory.BitVecVal(3, 64)],
        [y == symbol_factory.BitVecVal(0, 64),
         y == symbol_factory.BitVecVal(1, 64)],
    ])
    assert outcomes[0][0] == "sat"
    names = set(tracer.summary())
    assert {"solver.batch", "solver.prepare", "solver.settle"} <= names


# -- args / CLI plumbing ----------------------------------------------------------


def test_trace_arg_flows_into_global_args():
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler

    class _Ns:
        trace = "/tmp/some_trace.json"

    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode("0x6000", bin_runtime=True)
    MythrilAnalyzer(disassembler, cmd_args=_Ns())
    assert args.trace == "/tmp/some_trace.json"


# -- the disabled path ------------------------------------------------------------


def test_disabled_span_allocates_nothing_and_the_ring_is_bounded():
    """With full tracing off the only cost is the ring: span() records
    there and the full buffer stays empty; the ring holds exactly `cap`
    events after `cap + k` spans, the newest last. With the ring detached
    as well, span() is the shared no-op and allocates nothing."""
    tracer = get_tracer()
    saved = tracer._ring
    cap, extra = 16, 5
    tracer.attach_ring(deque(maxlen=cap))
    try:

        @traced("decorated.stage")
        def tiny():
            return 1

        for i in range(cap + extra):
            with span(f"hot.site.{i}", cat="x", attr=1):
                pass
        tiny()
        events = tracer.ring_events()
        assert len(events) == cap
        assert events[-1]["name"] == "decorated.stage"
        assert events[-2]["name"] == f"hot.site.{cap + extra - 1}"
        assert tracer.events() == []  # the full buffer stayed empty

        tracer.attach_ring(None)
        assert span("anything", cat="x") is NULL_SPAN
        assert span("anything") is span("other")  # no allocation
        with span("ringless", cat="x"):
            pass
        assert tracer.ring_events() == []
    finally:
        tracer.attach_ring(saved)


def test_fully_disabled_span_is_shared_noop(monkeypatch):
    """With the flight recorder off at tracer birth
    (MYTHRIL_GPU_FLIGHTREC=0), span() is the shared no-op object."""
    from mythril_tpu_torch.observe.tracer import Tracer

    saved = Tracer._instance
    Tracer._instance = None
    monkeypatch.setenv(flightrec.FLIGHTREC_ENV, "0")
    try:
        tracer = get_tracer()
        assert tracer._ring is None and not tracer._active
        assert span("anything", cat="x") is NULL_SPAN
        with span("ringless", cat="x"):
            pass
        assert tracer.ring_events() == [] and tracer.events() == []
    finally:
        Tracer._instance = saved


# -- prepare's stage clocks ------------------------------------------------------

STAGE_TIMERS = ("prepare_word_wall", "prepare_blast_wall", "aig_opt_wall",
                "cnf_prep_wall")
STAGE_SPANS = ("solver.word", "solver.blast", "solver.aig_opt",
               "solver.cnf_prep")
WINDOW = 12


def _prepare_window(count=WINDOW, seed=3):
    """Prepare each query of a sibling window, as the service does, from
    cleared solve state."""
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.smt.solver.frontend import Solver
    from mythril_tpu_torch.support.model import clear_caches
    from mythril_tpu_torch.support.workloads import sibling_window

    clear_caches()
    for constraints in sibling_window(smt, count, seed=seed):
        solver = Solver()
        solver.add(*constraints)
        solver._prepare([])


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("traced", [False, True],
                         ids=["untraced", "traced"])
def test_prepare_stages_partition_prepare_wall(traced):
    """The four stage timers add up to 95-100% of prepare_wall on a sibling
    window, each stage read. Traced, every stage span nests inside a
    solver.prepare span, and solver.prepare's self time is at most 5% of
    its total."""
    tracer = get_tracer()
    if traced:
        tracer.enable(None)
    _prepare_window()
    stats = SolverStatistics()
    staged = [getattr(stats, timer) for timer in STAGE_TIMERS]
    assert all(seconds > 0 for seconds in staged), staged
    assert 0.95 * stats.prepare_wall <= sum(staged) <= stats.prepare_wall
    if not traced:
        return
    events = tracer.events()
    prepares = [e for e in events if e["name"] == "solver.prepare"]
    stages = [e for e in events if e["name"] in STAGE_SPANS]
    assert len(prepares) == WINDOW
    assert {e["name"] for e in stages} == set(STAGE_SPANS)
    for stage in stages:
        assert any(_inside(stage, prepare) for prepare in prepares), stage
    total = sum(e["dur"] for e in prepares)
    assert total - sum(e["dur"] for e in stages) <= 0.05 * total


@pytest.mark.parametrize("constraints", ["constant", "propagated"])
def test_trivially_unsat_prepare_adds_to_the_word_stage(constraints):
    """A query that prepare settles UNSAT at the word level (a constant
    false assertion, or two definitions of one symbol) returns early and
    still adds what ran to prepare_word_wall, and nothing to the stages
    it never reached."""
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.smt.solver.frontend import UNSAT, Solver

    sf = smt.symbol_factory
    x = sf.BitVecSym("obs_unsat_x", 256)
    solver = Solver()
    if constraints == "constant":
        solver.add(sf.BitVecVal(1, 256) == sf.BitVecVal(2, 256))
    else:
        solver.add(x == sf.BitVecVal(1, 256), x == sf.BitVecVal(2, 256))
    assert solver._prepare([]).trivial == UNSAT
    stats = SolverStatistics()
    assert 0 < stats.prepare_word_wall <= stats.prepare_wall
    assert stats.prepare_blast_wall == stats.aig_opt_wall \
        == stats.cnf_prep_wall == 0


# -- the ledger of copies back from the card -------------------------------------


READS = {
    "to_host": lambda tensor: tensor.cpu(),
    "to_numpy": lambda tensor: tensor.cpu().numpy(),
    "to_list": lambda tensor: tensor.tolist(),
}


@pytest.mark.parametrize("helper", sorted(READS))
def test_copy_ledger_counts_card_reads_by_site(helper, monkeypatch):
    """A read through the ledger returns what the bare read returns. From
    a card (the device check faked on the CPU) it counts one copy and the
    tensor's bytes under its site, in the stats JSON, the heartbeat's
    histograms and a worker's absorbed snapshot; from a CPU tensor it
    counts nothing."""
    import numpy as np
    import torch

    from mythril_tpu_torch.observe import metrics, transfers

    tensor = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    read = getattr(transfers, helper)
    want = READS[helper](tensor)
    assert np.array_equal(np.asarray(read(tensor, "ragged.x")),
                          np.asarray(want))
    stats = SolverStatistics()
    assert (stats.d2h_copies, stats.d2h_bytes, stats.d2h_sites) \
        == (0, 0, {})

    monkeypatch.setattr(transfers, "on_card", lambda _tensor: True)
    assert np.array_equal(np.asarray(read(tensor, "ragged.x")),
                          np.asarray(want))
    read(tensor[:, :2], "ragged.found")   # a strided view: its own bytes
    read(tensor, "ragged.x")
    assert stats.d2h_copies == 3 and stats.d2h_bytes == 48 + 24 + 48
    assert stats.d2h_sites == {"ragged.x": [2, 96], "ragged.found": [1, 24]}
    snapshot = stats.as_dict()
    assert snapshot["d2h_sites"] == stats.d2h_sites
    assert (snapshot["d2h_copies"], snapshot["d2h_bytes"]) == (3, 120)
    beat = metrics.snapshot()
    assert beat["histograms"]["d2h_sites"] == stats.d2h_sites
    merged = metrics.merge_snapshots([beat, beat])
    assert merged["histograms"]["d2h_sites"] == {
        "ragged.x": [4, 192], "ragged.found": [2, 48]}
    stats.absorb(snapshot)
    assert stats.d2h_sites == {"ragged.x": [4, 192], "ragged.found": [2, 48]}
    assert stats.d2h_copies == 6 and stats.d2h_bytes == 240


def test_copy_ledger_counts_downloads_scalars_and_mesh_rows(monkeypatch):
    """K6's C++ download counts the size its caller gives; a one-element
    read counts its bytes; a sharded slot's row counts a copy per block
    it joins. The CPU reads count nothing."""
    import torch

    from mythril_tpu_torch.gpu.circuit import ShardGrid
    from mythril_tpu_torch.observe import transfers

    stats = SolverStatistics()
    grid = ShardGrid(None, [[torch.zeros(2, 3, 5, dtype=torch.int32),
                             torch.ones(2, 3, 5, dtype=torch.int32)]])
    assert transfers.to_int(torch.tensor([7]).max(), "circuit.stride") == 7
    assert grid.row(1).tolist() == [[0] * 5] * 3 + [[1] * 5] * 3
    assert stats.d2h_copies == 0

    monkeypatch.setattr(transfers, "on_card", lambda _tensor: True)
    transfers.downloaded("frontier.step", 1234)
    assert transfers.to_int(torch.tensor([7]).max(), "circuit.stride") == 7
    grid.row(0, site="bucketed.x")
    assert stats.d2h_sites == {"frontier.step": [1, 1234],
                               "circuit.stride": [1, 8],
                               "bucketed.x": [2, 120]}
    assert stats.d2h_copies == 4 and stats.d2h_bytes == 1234 + 8 + 120


# the reads in gpu/ and laser/frontier/ that take a host tensor: the
# blocks ShardGrid.row has copied, and the pinned host buffer of K6
CPU_ONLY = {
    ("gpu/backend.py", "lane = int(np.argmax(found_row.numpy()))"),
    ("gpu/backend.py", 'slot, site="bucketed.x")[lane].numpy()'),
    ("gpu/frontier_kernel.py", "self.host_np = self.host.numpy()"),
}
READ_RE = r"\.(cpu|item|tolist|numpy)\(\)"
LEDGER_CALLS = {"to_host": 1, "to_numpy": 1, "to_list": 1, "to_int": 1,
                "downloaded": 0}


def test_every_device_read_goes_through_the_ledger():
    """No .cpu(), .item(), .tolist() or .numpy() in gpu/ or
    laser/frontier/ outside observe/transfers.py but the CPU-only lines;
    every site the ledger's calls name is one of transfers.SITES, and
    every site in SITES is named."""
    import ast
    import re

    import mythril_tpu_torch
    from mythril_tpu_torch.observe import transfers

    root = os.path.dirname(mythril_tpu_torch.__file__)
    paths = sorted(glob.glob(os.path.join(root, "gpu", "*.py"))
                   + glob.glob(os.path.join(root, "laser", "frontier",
                                            "*.py")))
    bare, named = [], set()
    for path in paths:
        rel = os.path.relpath(path, root)
        source = open(path).read()
        for line in source.splitlines():
            if re.search(READ_RE, line) \
                    and (rel, line.strip()) not in CPU_ONLY:
                bare.append(f"{rel}: {line.strip()}")
        for node in ast.walk(ast.parse(source)):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            sites = [kw.value for kw in node.keywords if kw.arg == "site"]
            if isinstance(func, ast.Attribute) \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id == "transfers" \
                    and func.attr in LEDGER_CALLS:
                sites.append(node.args[LEDGER_CALLS[func.attr]])
            for site in sites:
                if isinstance(site, ast.Name) and site.id == "site":
                    continue   # a parameter: its callers name the site
                assert isinstance(site, ast.Constant), (rel, ast.dump(node))
                named.add(site.value)
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.FunctionDef):   # a `site` default
                arguments = node.args.args[len(node.args.args)
                                           - len(node.args.defaults):]
                named.update(default.value for arg, default
                             in zip(arguments, node.args.defaults)
                             if arg.arg == "site")
    assert bare == []
    assert set(transfers.SITES) == named, set(transfers.SITES) ^ named


def test_span_clock_is_the_profilers():
    """A program span opened around a torch.profiler record_function range
    contains it by kineto's own start_ns() and duration_ns(): span times
    and the profiler's events are on one clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = get_tracer()
    tracer.enable(None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("obs.clock", cat="x"):
            with record_function("obs.clock.range"):
                torch.ones(64).sum()
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "obs.clock.range"]
    (program,) = [e for e in tracer.events() if e["name"] == "obs.clock"]
    start_ns = program["ts"] * 1e3
    end_ns = (program["ts"] + program["dur"]) * 1e3
    assert start_ns <= event.start_ns()
    assert event.start_ns() + event.duration_ns() <= end_ns
