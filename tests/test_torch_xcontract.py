"""Cross-contract packing in the port: the interleaved corpus run
(service/interleave.py), origin-tagged coalescing windows
(service/scheduler.py), mixed-origin ragged streams (gpu/router.py) and
the cross-contract dedup counter (the counterparts of
tests/test_xcontract.py).

  stream     cones of two contracts' AIGs on one flat stream: disjoint
             pages, and K1's plain version's models decode per cone to
             assignments each contract's own AIG satisfies;
  seam       get_models_batch with origin tags packs a mixed stream and
             counts xcontract_windows / xcontract_cones_packed, each
             query's model its own;
  scheduler  fair admission, fork-pair atomicity, the fork_pairs hint
             rebuilt from pair tokens, a flush resolving every handle;
  runs       interleave 2 against interleave 1 on two corpus contracts
             (host backend): byte-identical reports, witnesses included,
             and byte-identical to the JAX package's interleave-2 run; a
             DeviceFault in a slot stops the run (the port's rule), with
             no slot thread left and the CLI exiting 2.
"""

import glob
import json
import os
import random
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mythril_tpu_torch.gpu import ragged_kernel
from mythril_tpu_torch.gpu.circuit import RaggedStream
from mythril_tpu_torch.service import interleave
from mythril_tpu_torch.service import scheduler as scheduler_mod
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args
from tests.torch_helpers import port_packed

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_DIR = os.path.join(REPO_ROOT, "bench_inputs", "corpus")


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_FLIGHTREC_DIR", str(tmp_path / "rec"))
    monkeypatch.delenv("MYTHRIL_GPU_CORPUS_INTERLEAVE", raising=False)
    from mythril_tpu_torch.resilience import faults

    stats = SolverStatistics()
    args.reset()
    model_mod.clear_caches()
    stats.reset()
    stats.enabled = True
    yield stats
    faults.configure(None)
    model_mod.clear_caches()
    stats.reset()
    args.reset()


# -- the stream: cones of two contracts ---------------------------------------


def test_mixed_origin_stream_pages_disjoint_and_demux_per_cone():
    """Cones of two source AIGs (two contracts' blasters) on one flat
    stream: the pages do not alias, and every model K1's plain version
    finds decodes, per cone, to an assignment its own contract's AIG
    satisfies."""
    from tests.test_ragged import _eval_root, _local_to_global, _packed_cones

    rng = random.Random(57)
    contract_a = _packed_cones(rng, 3)
    contract_b = _packed_cones(rng, 3)
    cones = [cone for pair in zip(contract_a, contract_b) for cone in pair]
    cache = {}
    stream = RaggedStream([(port_packed(pc, aig, roots, cache), ())
                           for aig, roots, pc in cones])
    assert stream.ok and stream.num_cones == 6
    spans = sorted(stream.pages)
    for (base_a, size_a), (base_b, _s) in zip(spans, spans[1:]):
        assert base_a + size_a <= base_b, "variable pages must not alias"
    caps = ragged_kernel.KernelCaps(var_cap=4096, cone_cap=16, root_cap=16,
                                    lane_tile=2, cone_tile=4, block=32)
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, caps), "cpu")
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2, size=(8, caps.var_cap), dtype=np.int32))
    x, found = ragged_kernel.run_round_ragged_kernel(
        flat, x, seed=5, steps=64, walk_depth=stream.num_levels + 4,
        caps=caps)
    x, found = x.numpy(), found.numpy()
    assert found.any(axis=0)[: len(cones)].all(), \
        "tiny random cones must all settle within one round"
    for ci, (aig, roots, pc) in enumerate(cones):
        lane = int(np.argmax(found[:, ci]))
        assignment = _local_to_global(
            pc, stream.cone_assignment(ci, x[lane]))
        for root in roots:
            assert _eval_root(aig, assignment, root), (ci, root)


# -- the seam: origin-tagged get_models_batch -------------------------------


def _production_queries(tag, count, base=0):
    from mythril_tpu_torch.smt import ULT, Extract, symbol_factory

    queries = []
    for qi in range(base, base + count):
        data = symbol_factory.BitVecSym(f"xc_{tag}_data_{qi}", 256)
        value = symbol_factory.BitVecSym(f"xc_{tag}_value_{qi}", 256)
        sender = symbol_factory.BitVecSym(f"xc_{tag}_sender_{qi}", 256)
        selector = (0xAB125858 ^ (qi * 0x01010101)) & 0xFFFFFFFF
        queries.append([
            Extract(255, 224, data)
            == symbol_factory.BitVecVal(selector, 32),
            ULT(value, symbol_factory.BitVecVal(1 << 40, 256)),
            sender != symbol_factory.BitVecVal(0, 256),
            value + data != sender,
        ])
    return queries


def test_mixed_origin_batch_counts_windows_and_demuxes_per_query(
        fresh_state):
    """Production-shape queries of two origins through get_models_batch on
    the device backend (K1's plain version): a stream carries cones of
    both contracts (xcontract_windows >= 1, xcontract_cones_packed >= 2),
    and each model satisfies its own query's constraints."""
    args.solver_backend = "gpu"
    args.torch_device = "cpu"
    queries = (_production_queries("contractA", 2)
               + _production_queries("contractB", 2, base=2))
    origins = ["0:A", "0:A", "1:B", "1:B"]
    outcomes = model_mod.get_models_batch(queries, origins=origins)
    assert [status for status, _m in outcomes] == ["sat"] * 4
    assert fresh_state.xcontract_windows >= 1
    assert fresh_state.xcontract_cones_packed >= 2
    assert fresh_state.xcontract_windows <= fresh_state.ragged_windows
    for constraints, (_status, model) in zip(queries, outcomes):
        assert model.satisfies([c.raw for c in constraints])


def test_single_origin_batch_counts_no_mixed_window(fresh_state):
    args.solver_backend = "gpu"
    args.torch_device = "cpu"
    queries = _production_queries("solo", 3)
    model_mod.get_models_batch(queries, origins=["0:A"] * 3)
    assert fresh_state.ragged_windows >= 1
    assert fresh_state.xcontract_windows == 0
    assert fresh_state.xcontract_cones_packed == 0


# -- the scheduler: fair admission, fork pairs, every handle resolved -------


def _handle(scheduler):
    return scheduler_mod.SolveHandle(scheduler)


@pytest.fixture
def no_age_trigger(monkeypatch):
    monkeypatch.setattr(scheduler_mod, "COALESCE_MS", 1e9)


def test_fair_admission_no_starvation_in_first_dispatch(monkeypatch,
                                                        no_age_trigger):
    """A contract flooding the window cannot push another's queries out of
    the first dispatch: every origin lands in sub-group one, no origin
    exceeds its budget a sub-group, and nothing is dropped."""
    monkeypatch.setenv("MYTHRIL_GPU_ORIGIN_BUDGET", "8")
    scheduler = scheduler_mod.CoalescingScheduler()
    calls = []

    def fake_batch(constraint_sets, crosscheck=None, origins=None,
                   fork_pairs=None):
        calls.append(list(origins))
        return [("unknown", None)] * len(constraint_sets)

    monkeypatch.setattr(model_mod, "get_models_batch", fake_batch)
    monkeypatch.setattr(interleave, "current_origin", lambda: "0:big")
    for qi in range(40):
        scheduler._buffer_one(_handle(scheduler), [f"big{qi}"], None)
    monkeypatch.setattr(interleave, "current_origin", lambda: "1:small")
    scheduler._buffer_one(_handle(scheduler), ["small0"], None)
    scheduler._buffer_one(_handle(scheduler), ["small1"], None)
    scheduler.flush()
    assert len(calls) == 5, "the flooding origin splits over sub-groups"
    assert calls[0].count("1:small") == 2, \
        "the small origin rides the first dispatch whole"
    assert all(group.count("0:big") <= 8 for group in calls)
    assert sum(group.count("0:big") for group in calls) == 40


def test_single_origin_window_is_one_group(no_age_trigger):
    scheduler = scheduler_mod.CoalescingScheduler()
    entries = [(None, [f"q{i}"], None, "A", None) for i in range(70)]
    assert scheduler._origin_groups(entries) == [entries]


@pytest.mark.parametrize("budget, groups_expected", [(2, 2), (3, 1)])
def test_origin_groups_keep_fork_pairs_atomic(monkeypatch, no_age_trigger,
                                              budget, groups_expected):
    """A fork pair's two sides land in the same sub-group, also when the
    budget boundary falls between them (budget 3)."""
    monkeypatch.setenv("MYTHRIL_GPU_ORIGIN_BUDGET", str(budget))
    scheduler = scheduler_mod.CoalescingScheduler()
    token = object()
    entries = [
        (None, ["a0"], None, "A", None),
        (None, ["a1"], None, "A", None),
        (None, ["a2-pair"], None, "A", token),
        (None, ["a3-pair"], None, "A", token),
        (None, ["b0"], None, "B", None),
    ]
    groups = scheduler._origin_groups(entries)
    assert len(groups) == groups_expected
    for group in groups:
        assert sum(1 for entry in group if entry[4] is token) in (0, 2)
    flattened = [entry[1][0] for group in groups for entry in group]
    assert sorted(flattened) == sorted(entry[1][0] for entry in entries)


def test_solve_group_rebuilds_fork_pair_hint(monkeypatch):
    """The flush's get_models_batch call gets fork_pairs rebuilt from the
    pair tokens at the positions the entries occupy."""
    scheduler = scheduler_mod.CoalescingScheduler()
    seen = {}

    def fake_batch(constraint_sets, crosscheck=None, origins=None,
                   fork_pairs=None):
        seen["pairs"] = fork_pairs
        seen["origins"] = origins
        return [("unknown", None)] * len(constraint_sets)

    monkeypatch.setattr(model_mod, "get_models_batch", fake_batch)
    token = object()
    entries = [
        (_handle(scheduler), ["plain"], None, "A", None),
        (_handle(scheduler), ["taken"], None, "A", token),
        (_handle(scheduler), ["fall"], None, "B", token),
    ]
    scheduler._solve_group(None, entries)
    assert seen["pairs"] == [(1, 2)]
    assert seen["origins"] == ["A", "A", "B"]


def test_flush_resolves_every_popped_handle_on_wholesale_failure(
        monkeypatch, no_age_trigger):
    """flush() pops the buffer before solving, so an error escaping the
    group loop must not strand the popped handles: a parked sibling would
    wait on them for ever. Each degrades to unknown."""
    scheduler = scheduler_mod.CoalescingScheduler()
    handles = [_handle(scheduler), _handle(scheduler)]
    for qi, handle in enumerate(handles):
        scheduler._buffer_one(handle, [f"q{qi}"], None)

    def explode(entries):
        raise MemoryError("wholesale flush failure")

    monkeypatch.setattr(scheduler, "_origin_groups", explode)
    with pytest.raises(MemoryError):
        scheduler.flush()
    assert all(handle.done for handle in handles)
    assert [handle.result() for handle in handles] == \
        [("unknown", None)] * 2


def test_fork_batch_parks_with_pair_tokens_under_the_coordinator(
        monkeypatch, no_age_trigger):
    """Under a live coordinator solve_fork_batch buffers the bundle with
    one token a pair and parks, instead of flushing first."""
    scheduler = scheduler_mod.CoalescingScheduler()
    scheduler._buffer_one(_handle(scheduler), ["earlier"], False)
    parked = []

    class Parking:
        def park_for_results(self, sched, handles):
            parked.append(len(handles))
            sched.flush()

    seen = {}

    def fake_batch(constraint_sets, crosscheck=None, origins=None,
                   fork_pairs=None):
        seen["pairs"] = fork_pairs
        return [("sat", None)] * len(constraint_sets)

    monkeypatch.setattr(model_mod, "get_models_batch", fake_batch)
    monkeypatch.setattr(interleave, "active", lambda: Parking())
    outcomes = scheduler.solve_fork_batch([["t0"], ["f0"], ["t1"], ["f1"]],
                                          [(0, 1), (2, 3)])
    assert parked == [4]
    assert outcomes == [("sat", None)] * 4
    # the earlier entry shifts the bundle by one in the flushed window
    assert seen["pairs"] == [(1, 2), (3, 4)]


# -- the coordinator ----------------------------------------------------------


def test_current_origin_none_outside_coordinator():
    assert interleave.active() is None
    assert interleave.current_origin() is None
    interleave.tick()  # a no-op, not a crash


def _run_slots(coordinator, analyze_one, slots):
    threads = [threading.Thread(target=coordinator.run_slot,
                                args=(slot, analyze_one),
                                name=f"mythril-interleave-{slot}")
               for slot in range(slots)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=30)
    return threads


def test_coordinator_runs_one_slot_at_a_time_round_robin():
    """Only the baton holder runs: two contracts' turns alternate every
    quantum of ticks, each under its own origin tag."""
    trace = []
    running = []

    def analyze_one(idx, contract):
        # the first holder waits (holding the baton) until the other slot
        # has attached, so the turns do not depend on thread start-up
        while len(coordinator._live) < 2:
            time.sleep(0.001)
        for _ in range(6):
            running.append(idx)
            assert len(running) == 1, "two slots ran at once"
            trace.append(interleave.current_origin())
            running.pop()
            interleave.tick()

    coordinator = interleave.Coordinator(
        [(0, SimpleNamespace(name="a")), (1, SimpleNamespace(name="b"))],
        quantum=2)
    interleave.install(coordinator)
    try:
        threads = _run_slots(coordinator, analyze_one, 2)
    finally:
        interleave.uninstall()
    assert not any(thread.is_alive() for thread in threads)
    assert coordinator.failure is None
    assert trace[:4] == ["0:a", "0:a", "1:b", "1:b"]
    assert sorted(trace) == ["0:a"] * 6 + ["1:b"] * 6


def test_device_fault_in_a_slot_cancels_the_parked_sibling():
    """The port's rule: a DeviceFault escaping one slot's analysis is the
    coordinator's failure, and a sibling parked on a window that never
    resolves unwinds with BatchCancelled instead of waiting for ever."""
    from mythril_tpu_torch.gpu.device import DeviceFault

    class NeverFlushes:
        def pending(self):
            return 0

        def flush(self):
            pass

    fault = DeviceFault("the card failed")
    parked = []

    def analyze_one(idx, contract):
        if idx == 0:
            interleave.tick()  # quantum 1: the baton moves to slot 1
            raise fault
        handle = scheduler_mod.SolveHandle(None)
        parked.append(idx)
        interleave.active().park_for_results(NeverFlushes(), [handle])
        raise AssertionError("a parked slot must not resume")

    coordinator = interleave.Coordinator(
        [(0, SimpleNamespace(name="a")), (1, SimpleNamespace(name="b"))],
        quantum=1)
    interleave.install(coordinator)
    try:
        threads = _run_slots(coordinator, analyze_one, 2)
    finally:
        interleave.uninstall()
    assert not any(thread.is_alive() for thread in threads)
    assert parked == [1]
    assert coordinator.failure is fault


# -- runs: interleaved against sequential, and against the JAX package -------


def _corpus_files(count):
    files = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.hex")))
    assert len(files) >= count, "committed corpus missing"
    return files[:count]


def _port_corpus(files, interleave_n, backend="cpu", inject_fault=None):
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.smt.solver import frontend

    args.reset()
    model_mod.clear_caches()
    frontend._global_blaster = None
    cmd_args = SimpleNamespace(
        execution_timeout=120, transaction_count=1, max_depth=128,
        pruning_factor=1.0, solver_backend=backend, torch_device="cpu",
        corpus_interleave=interleave_n, inject_fault=inject_fault)
    disassembler = MythrilDisassembler()
    for path in files:
        with open(path) as fd:
            disassembler.load_from_bytecode(fd.read().strip(),
                                            name=os.path.basename(path))
    try:
        report = MythrilAnalyzer(disassembler, cmd_args=cmd_args,
                                 strategy="bfs").fire_lasers(
            transaction_count=1)
    finally:
        args.reset()
    return report.as_json()


def _reference_corpus(files, interleave_n):
    from mythril_tpu import preanalysis
    from mythril_tpu.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu.support import model as reference_model
    from mythril_tpu.support.args import args as reference_args
    from mythril_tpu.tpu import router as reference_router

    class CmdArgs:
        execution_timeout = 120
        transaction_count = 1
        max_depth = 128
        pruning_factor = 1.0

    reference_model.clear_caches()
    preanalysis.reset_caches()
    reference_router.reset_router()
    saved = (reference_args.solver_backend, reference_args.corpus_interleave)
    reference_args.solver_backend = "cpu"
    reference_args.corpus_interleave = interleave_n
    try:
        disassembler = MythrilDisassembler()
        for path in files:
            with open(path) as fd:
                disassembler.load_from_bytecode(
                    fd.read().strip(), name=os.path.basename(path))
        report = MythrilAnalyzer(disassembler, cmd_args=CmdArgs(),
                                 strategy="bfs").fire_lasers(
            transaction_count=1)
    finally:
        (reference_args.solver_backend,
         reference_args.corpus_interleave) = saved
        reference_model.clear_caches()
        # the JAX package keeps a finished run's execution budget
        from mythril_tpu.support.time_handler import time_handler

        time_handler.start_execution(None)
    return report.as_json()


_RUNS = {}


def _cached(key, make):
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def test_interleaved_reports_byte_identical_to_sequential():
    """Interleave 2 against interleave 1 (the same slots and isolation,
    one contract at a time) on two corpus contracts, host backend: the
    reports are byte-identical, the solver's witnesses included."""
    files = _corpus_files(2)
    sequential = _cached("port-1", lambda: _port_corpus(files, 1))
    interleaved = _cached("port-2", lambda: _port_corpus(files, 2))
    assert json.loads(sequential)["issues"], "vacuous parity proves nothing"
    assert interleaved == sequential


def test_interleaved_report_byte_identical_to_the_jax_package():
    files = _corpus_files(2)
    port = _cached("port-2", lambda: _port_corpus(files, 2))
    reference = _reference_corpus(files, 2)
    assert json.loads(port)["issues"]
    assert port == reference


def test_device_fault_under_interleave_stops_the_cli_run(monkeypatch,
                                                         tmp_path):
    """device.dispatch:raise:n1 under interleave 2 on the device backend
    (K1's plain version): the run stops with a recorded DeviceFault in
    bounded time, the CLI exits 2, the stats JSON says completed false,
    the fault was never degraded to the host, and no slot thread is left
    alive."""
    from mythril_tpu_torch.interfaces import cli

    stats_path = tmp_path / "stats.json"
    monkeypatch.setenv("MYTHRIL_GPU_STATS_JSON", str(stats_path))
    argv = ["myth-gpu", "analyze"]
    for path in _corpus_files(2):
        argv += ["-f", path]
    argv += ["-t", "1", "--pruning-factor", "1", "--torch-device", "cpu",
             "--corpus-interleave", "2", "--execution-timeout", "120",
             "--inject-fault", "device.dispatch:raise:n1", "-o", "json"]
    monkeypatch.setattr(sys, "argv", argv)
    start = time.monotonic()
    with pytest.raises(SystemExit) as exited:
        cli.main()
    assert exited.value.code == 2
    assert time.monotonic() - start < 60
    stats = json.loads(stats_path.read_text())
    assert stats["completed"] is False
    assert stats["resilience"]["sites"]["device.dispatch"] == {"injected": 1}
    assert stats["resilience_degraded"] == 0
    assert not [thread.name for thread in threading.enumerate()
                if thread.name.startswith("mythril-interleave-")]
    assert interleave.active() is None


# -- the cross-contract dedup counter -----------------------------------------


def test_xcontract_dedup_hits_counted_across_origins(tmp_path, monkeypatch,
                                                     fresh_state):
    """A disk-tier entry stored under one contract's analysis and served
    to another's identical query counts xcontract_dedup_hits; the same
    origin probing again does not."""
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    args.solve_cache = "disk"
    args.solver_backend = "cpu"
    query = _production_queries("dedup", 1)[0]
    first = model_mod.get_models_batch([list(query)],
                                       origins=["0:contract_a"])
    assert first[0][0] == "sat"
    assert fresh_state.persistent_stores >= 1
    assert fresh_state.xcontract_dedup_hits == 0
    second = model_mod.get_models_batch([list(query)],
                                        origins=["1:contract_b"])
    assert second[0][0] == "sat"
    assert fresh_state.xcontract_dedup_hits == 1
    model_mod.get_models_batch([list(query)], origins=["0:contract_a"])
    assert fresh_state.xcontract_dedup_hits == 1


def test_a_failed_component_assembly_counts_no_dedup_hit(monkeypatch):
    """A hit counts only when an assembly actually serves: a replay that
    fails after every component entry hit counts nothing."""
    from mythril_tpu_torch.preanalysis import aig_partition

    class Component:
        trivial_assignment = None
        roots = ()

        def instance(self, aig):
            return 1, [], None

    class Entry:
        verdict, num_vars, bits = "sat", 1, [False, True]

    class Store:
        def lookup(self, fingerprint):
            return Entry()

    class Solver:
        def _reconstruct(self, prep, bits):
            raise ValueError("stale entry")

    prep = SimpleNamespace(num_vars=1, aig_roots=(None, None, {}))
    monkeypatch.setattr(model_mod, "_prep_partition",
                        lambda prep: SimpleNamespace(components=[Component()]))
    monkeypatch.setattr(aig_partition, "apply_trivial_assignment",
                        lambda *a: False)
    monkeypatch.setattr(aig_partition, "component_vars", lambda dense: [])
    monkeypatch.setattr(aig_partition, "merge_component_bits",
                        lambda *a: None)
    from mythril_tpu_torch.service import fingerprint

    monkeypatch.setattr(fingerprint, "component_fingerprint",
                        lambda *a: "fp")
    model_mod._record_fingerprint_origin("fp", "0:a")
    stats = SolverStatistics()
    assert model_mod._probe_component_assembly(
        Store(), Solver(), prep, stats, origin="1:b") is None
    assert stats.xcontract_dedup_hits == 0
    assert stats.persistent_verify_rejects == 1


# -- plumbing ----------------------------------------------------------------


def test_corpus_interleave_env_overrides_flag(monkeypatch):
    from mythril_tpu_torch.core import MythrilAnalyzer

    args.corpus_interleave = 0
    monkeypatch.setenv("MYTHRIL_GPU_CORPUS_INTERLEAVE", "3")
    assert MythrilAnalyzer._corpus_interleave_n() == 3
    # the JAX package's knob never steers the port
    monkeypatch.delenv("MYTHRIL_GPU_CORPUS_INTERLEAVE")
    monkeypatch.setenv("MYTHRIL_TPU_CORPUS_INTERLEAVE", "4")
    args.corpus_interleave = 2
    assert MythrilAnalyzer._corpus_interleave_n() == 2


def test_cli_takes_the_corpus_flags():
    from mythril_tpu_torch.interfaces import cli

    parsed = cli.build_parser().parse_args(
        ["analyze", "-f", "a.hex", "-f", "b.hex", "--jobs", "3",
         "--corpus-interleave", "2"])
    assert (parsed.jobs, parsed.corpus_interleave) == (3, 2)
    defaults = cli.build_parser().parse_args(["analyze", "-c", "00"])
    assert (defaults.jobs, defaults.corpus_interleave) == (1, 0)
