"""`analyze` end to end: the port's MythrilAnalyzer against the JAX
package's, on the hand-assembled contracts of tests/test_analysis.py.

On the host backend both packages must render byte-identical reports,
witnesses included (the host CDCL is deterministic). On the
port's device backend every batched window goes through the router to K1
(its plain PyTorch version on the CPU device here) and the host CDCL
settles the misses; K1's lanes draw from a torch.Generator, so a device
model may pick another witness, and findings are compared at issue
granularity. Every run has an execution timeout it must not reach
(tests/torch_helpers.py). Both packages run with their batched frontier
on, the JAX package's default, and its counters must be equal too."""

import pytest

from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

from tests.test_analysis import (
    ASSERT_FAIL,
    ETHER_LEAK,
    KILLBILLY,
    OVERFLOW_ADD,
    PROTECTED_KILL,
    TIMESTAMP_BRANCH,
    TX_ORIGIN,
    easm_to_code,
    wrap_creation,
)
from tests.torch_helpers import issue_keys, run_analyze

EXECUTION_TIMEOUT = 60  # s; fork pruning stays off below 300 s

BENIGN = easm_to_code("""
    CALLER
    PUSH1 0x00
    SSTORE
    STOP
""")

# name -> (contract, transaction count, SWC ids the report must hold,
# SWC ids it must not): the KILLBILLY family of test_analysis.py
FAMILY = {
    "selfdestruct_unprotected": (KILLBILLY, 1, {"106"}, set()),
    "selfdestruct_protected": (PROTECTED_KILL, 1, set(), {"106"}),
    "ether_thief": (ETHER_LEAK, 1, {"105"}, set()),
    "exception": (ASSERT_FAIL, 1, {"110"}, set()),
    "integer_overflow": (OVERFLOW_ADD, 2, {"101"}, set()),
    "tx_origin": (TX_ORIGIN, 1, {"115"}, set()),
    "predictable_vars": (TIMESTAMP_BRANCH, 1, {"116"}, set()),
    "benign": (BENIGN, 1, set(), None),
}


# the host-backend runs of each package, (report, frontier counters),
# shared by the tests below
_HOST = {}
_REFERENCE = {}

FRONTIER_COUNTERS = (
    "frontier_vmap_steps", "frontier_states_stepped",
    "frontier_fallback_exits", "frontier_fallback_dialect",
    "frontier_fallback_dynamic", "frontier_fallback_hook",
    "frontier_fallback_symbolic", "frontier_batch_bails",
    "frontier_batch_slots", "frontier_symlane_rows", "frontier_forks",
    "frontier_fork_rows", "frontier_fork_cohort_rows",
    "frontier_fork_infeasible_pruned")


def frontier_counters(package: str) -> dict:
    """The frontier counters of `package`'s statistics."""
    import importlib

    stats = importlib.import_module(
        f"{package}.smt.solver.statistics").SolverStatistics()
    return {name: getattr(stats, name) for name in FRONTIER_COUNTERS}


def counted_run(package, code, tx_count, *args, **kwargs):
    """run_analyze with `package`'s statistics reset before it: (report,
    frontier counters)."""
    import importlib

    importlib.import_module(
        f"{package}.smt.solver.statistics").SolverStatistics().reset()
    report = run_analyze(package, code, tx_count, *args, **kwargs)
    return report, frontier_counters(package)


@pytest.fixture(autouse=True)
def counted(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    stats = SolverStatistics()
    stats.reset()
    yield stats
    stats.reset()


def _host_run(name, package="mythril_tpu_torch"):
    runs = _HOST if package == "mythril_tpu_torch" else _REFERENCE
    if name not in runs:
        runtime, tx_count, _present, _absent = FAMILY[name]
        runs[name] = counted_run(package, wrap_creation(runtime), tx_count,
                                 "cpu", EXECUTION_TIMEOUT)
    return runs[name]


def _host_report(name):
    return _host_run(name)[0]


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_host_reports_byte_identical(name):
    _runtime, _tx_count, present, absent = FAMILY[name]
    reference = _host_run(name, "mythril_tpu")[0]
    port = _host_report(name)
    assert port.as_json() == reference.as_json()
    assert port.as_text() == reference.as_text()
    # not vacuous: the findings test_analysis.py asserts are there
    swcs = {issue.swc_id for issue in port.issues.values()}
    assert present <= swcs
    assert not (swcs & absent) if absent is not None else not swcs


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_frontier_counters_equal_the_reference(name):
    """The batched frontier stepped the same batches, rows, forks and
    fallbacks in both packages."""
    port = _host_run(name)[1]
    assert port == _host_run(name, "mythril_tpu")[1]
    assert port["frontier_vmap_steps"] > 0


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_device_findings_equal_host(name, counted):
    runtime, tx_count, _present, _absent = FAMILY[name]
    host = _host_report(name)
    counted.reset()
    device = run_analyze("mythril_tpu_torch", wrap_creation(runtime),
                         tx_count, "gpu", EXECUTION_TIMEOUT, device="cpu")
    assert issue_keys(device) == issue_keys(host)
    assert counted.device_batch_hits <= counted.device_batch_queries
