"""The engine options `analyze` reads, in the port against the JAX package:
summaries (--enable-summaries: the summary plugin and the issue
annotations of summaries mode), state merging (--enable-state-merging),
the tx prioritiser (--disable-incremental-txs), the benchmark and
coverage-metrics plugins, and the independence solver.

The counterparts of tests/test_summaries.py (:99, :104),
tests/test_strategies_plugins.py's state-merging (:110, :116),
benchmark/coverage-metrics (:137) and prioritiser (:165) cases, and
tests/test_solver.py:234, each run in both packages. Host-backend reports
must be byte-identical (the host CDCL is deterministic); the port's device
backend (device "cpu": K1's and K6's plain versions) must find the same
issues (SWC id, function, address, title), as a device model may pick
another witness. Every comparison is exact."""

import importlib
import json

import pytest

from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

from tests.test_summaries import KILLBILLY, STORE_THEN_KILL, wrap_creation
from tests.torch_helpers import issue_keys, run_analyze

EXECUTION_TIMEOUT = 60  # s, never reached by these contracts
PACKAGES = ("mythril_tpu", "mythril_tpu_torch")

# name -> (code hex, transaction count, runtime code, CLI fields, SWC ids
# the report must hold, SWC ids it must not)
RUNS = {
    # tests/test_summaries.py :99 and :104
    "summaries_single_tx": (wrap_creation(KILLBILLY), 1, False,
                            {"enable_summaries": True}, {"106"}, set()),
    "summaries_two_tx": (wrap_creation(STORE_THEN_KILL), 2, False,
                         {"enable_summaries": True}, {"106"}, set()),
    # tests/test_strategies_plugins.py :110
    "state_merging": (wrap_creation(KILLBILLY), 2, False,
                      {"enable_state_merging": True}, {"106"}, set()),
    # the prioritiser ranks the runtime code's selectors: tx 1 explores
    # kill() alone, then any selector
    "prioritised_kill": (KILLBILLY.hex(), 2, True,
                         {"disable_incremental_txs": True}, {"106"}, set()),
    # ... and here pins tx 1 to the setter, which it ranks first (a
    # state-mutating function): at -t 1 the guarded kill() is never
    # explored, where incremental ordering finds it (below)
    "prioritised_setter_first": (STORE_THEN_KILL.hex(), 1, True,
                                 {"disable_incremental_txs": True}, set(),
                                 {"106"}),
}

_HOST = {}


@pytest.fixture(autouse=True)
def counted(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    stats = SolverStatistics()
    stats.reset()
    yield stats
    stats.reset()


def _run(name, package, backend="cpu", device=None):
    code, tx_count, runtime, flags, _present, _absent = RUNS[name]
    return run_analyze(package, code, tx_count, backend, EXECUTION_TIMEOUT,
                       device=device, bin_runtime=runtime, flags=flags)


def _host(name, package="mythril_tpu_torch"):
    if (name, package) not in _HOST:
        _HOST[name, package] = _run(name, package)
    return _HOST[name, package]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_host_reports_equal_the_reference(name):
    _code, _tx, _runtime, _flags, present, absent = RUNS[name]
    reference = _host(name, "mythril_tpu")
    port = _host(name)
    assert port.as_json() == reference.as_json()
    assert port.as_text() == reference.as_text()
    swcs = {issue.swc_id for issue in port.issues.values()}
    assert present <= swcs
    assert not swcs & absent


@pytest.mark.parametrize("name", sorted(RUNS))
def test_device_findings_equal_host(name, counted):
    host = _host(name)
    counted.reset()
    device = _run(name, "mythril_tpu_torch", backend="gpu", device="cpu")
    assert issue_keys(device) == issue_keys(host)


@pytest.mark.parametrize("package", PACKAGES)
def test_incremental_ordering_finds_what_the_prioritiser_pins_away(package):
    """The prioritiser's effect: without --disable-incremental-txs the
    guarded kill() of STORE_THEN_KILL is found at -t 1."""
    report = run_analyze(package, STORE_THEN_KILL.hex(), 1, "cpu",
                         EXECUTION_TIMEOUT, bin_runtime=True)
    assert "106" in {issue.swc_id for issue in report.issues.values()}


@pytest.mark.parametrize("package", PACKAGES)
def test_summaries_mode_ends_with_the_run(package):
    """The summary plugin turns summaries mode on (issue annotations);
    run_analyze's args reset turns it off with the run."""
    args = importlib.import_module(f"{package}.support.args").args
    _run("summaries_single_tx", package)
    assert not args.use_issue_annotations
    assert not args.enable_summaries


def _pkg(package, name):
    return importlib.import_module(f"{package}.{name}")


@pytest.mark.parametrize("package", PACKAGES)
def test_state_merge_reduces_open_states(package):
    """Two branch outcomes with identical post-states merge to one whose
    constraint is the disjunction (tests/test_strategies_plugins.py:116)."""
    state_merge = _pkg(package, "laser.plugin.plugins.state_merge")
    world_state = _pkg(package, "laser.state.world_state")
    smt = _pkg(package, "smt")

    x = smt.symbol_factory.BitVecSym("x", 256)
    ws1 = world_state.WorldState()
    ws1.create_account(address=0x123, balance=0)
    ws1.constraints.append(x > 5)
    ws2 = ws1.clone()
    ws2.constraints.pop()
    ws2.constraints.append(x <= 5)
    assert state_merge.check_ws_merge_condition(ws1, ws2)
    state_merge.merge_states(ws1, ws2)
    assert ws1.constraints.is_possible
    assert len(ws1.constraints) == 1


def _plugin_outputs(package, tmp_path):
    """The benchmark and coverage-metrics plugins over one LASER run of
    KILLBILLY (tests/test_strategies_plugins.py:137): their JSON files."""
    benchmark = _pkg(package, "laser.plugin.plugins.benchmark")
    coverage = _pkg(package, "laser.plugin.plugins.coverage_metrics")
    svm = _pkg(package, "laser.svm")
    args = _pkg(package, "support.args").args
    time_handler = _pkg(package, "support.time_handler").time_handler
    _pkg(package, "support.model").clear_caches()
    folder = tmp_path / package
    folder.mkdir()
    args.reset()
    # the port's engine solves on the host here, as the JAX package's
    # default backend does
    args.solver_backend = "cpu"
    try:
        laser = svm.LaserEVM(transaction_count=1)
        bench = benchmark.BenchmarkPlugin(name=str(folder / "bench_out"))
        bench.initialize(laser)
        metrics = coverage.CoverageMetricsPlugin(
            output_path=str(folder / "data.json"))
        metrics.initialize(laser)
        laser.sym_exec(creation_code=wrap_creation(KILLBILLY),
                       contract_name="T")
    finally:
        time_handler.start_execution(None)
        args.reset()
    return (json.loads((folder / "bench_out.json").read_text()),
            json.loads((folder / "data.json").read_text()))


def test_benchmark_and_coverage_metrics_plugins(tmp_path):
    reference = _plugin_outputs("mythril_tpu", tmp_path)
    bench, metrics = _plugin_outputs("mythril_tpu_torch", tmp_path)
    assert bench["instructions_executed"] > 0
    assert bench["coverage_over_time"]
    series = metrics["time_series"]
    assert series and series[-1]["coverage"]
    entries = list(series[-1]["coverage"].values())
    assert max(e["instruction_coverage"] for e in entries) > 0.5
    assert sum(e["branches_covered"] for e in entries) >= 1
    # the same work in both packages; the times differ
    assert bench["instructions_executed"] == reference[0][
        "instructions_executed"]
    assert series[-1]["coverage"] == reference[1]["time_series"][-1][
        "coverage"]


class _Disassembly:
    function_entries = {"41c0e1b5": 10, "a9059cbb": 20}


class _Contract:
    disassembly = _Disassembly()
    solc_ast = {
        "nodeType": "SourceUnit",
        "nodes": [
            {
                "nodeType": "FunctionDefinition",
                "name": "kill",
                "body": {"statements": [{
                    "nodeType": "FunctionCall",
                    "expression": {"name": "selfdestruct"},
                }]},
            },
            {
                "nodeType": "FunctionDefinition",
                "name": "transfer",
                "body": {"statements": []},
            },
        ],
    }


@pytest.mark.parametrize("package", PACKAGES)
def test_tx_prioritiser_ranks_selfdestruct_first(package):
    """tests/test_strategies_plugins.py:165, and the port's sequences equal
    the JAX package's."""
    prioritiser = _pkg(package, "laser.tx_prioritiser")
    sequences = prioritiser.RfTxPrioritiser(_Contract()).predict_sequences(
        depth=3)
    assert len(sequences) == 3
    assert sequences[0] == [bytes.fromhex("41c0e1b5")]
    assert sequences[-1] == [-1]
    reference = _pkg("mythril_tpu", "laser.tx_prioritiser").RfTxPrioritiser(
        _Contract()).predict_sequences(depth=3)
    assert sequences == reference


def test_solidity_features_equal_the_reference():
    port = _pkg("mythril_tpu_torch", "solidity.features")
    reference = _pkg("mythril_tpu", "solidity.features")
    assert port.SolidityFeatureExtractor(
        _Contract.solc_ast).extract_features() == \
        reference.SolidityFeatureExtractor(
            _Contract.solc_ast).extract_features()


@pytest.mark.parametrize("package", PACKAGES)
def test_independence_solver_partitions_and_merges(package):
    """tests/test_solver.py:234: disjoint clusters solve apart, one UNSAT
    bucket sinks the set, models merge across buckets."""
    smt = _pkg(package, "smt")
    independence = _pkg(package, "smt.solver.independence_solver")

    def symbols():
        return [smt.symbol_factory.BitVecSym(f"ind_{name}", 64)
                for name in "abcd"]

    a, b, c, d = symbols()
    dep = independence.DependenceMap()
    for cond in (a == b + 1, c == 5, d == c + 2, b == 10):
        dep.add_condition(cond.raw)
    assert len(dep.buckets) == 2
    assert sorted(len(bucket.conditions) for bucket in dep.buckets) == [2, 2]

    solver = independence.IndependenceSolver(timeout=10.0)
    solver.add(a == b + 1, b == 10, c == 5, d == c + 2)
    assert solver.check() == "sat"
    model = solver.model()
    assert model.eval_int(a) == 11
    assert model.eval_int(d) == 7

    unsat = independence.IndependenceSolver(timeout=10.0)
    unsat.add(a == b + 1, b == 10, c == 5, c == 6)
    assert unsat.check() == "unsat"
