"""The port's stats-key lint (python -m mythril_tpu_torch.observe.stats_keys)
and the stats JSON held against the JAX package's: the same key set less
the surfaces not ported yet, each named with its ROADMAP item, and the
same per-opcode counts and suffix histogram on one contract."""

import pytest

from mythril_tpu.smt.solver.statistics import (
    SolverStatistics as ReferenceStatistics,
)
from mythril_tpu_torch.observe import stats_keys
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from tests.test_analysis import KILLBILLY, wrap_creation
from tests.torch_helpers import run_analyze

# keys of the JAX package's stats JSON whose surface the port has not
# ported yet, with the ROADMAP.md §1 item that brings each
NOT_PORTED = {
    # 10: autotune and the resolved knob stamp
    "autotune_candidates_tried": 10, "autotune_rejected_parity": 10,
    "autotune_rejected_regression": 10, "tuned_knobs_applied": 10,
    "tuned_profile_rejects": 10, "knobs": 10,
}
# the Pallas round's counters under the port's names (K1 is a CUDA kernel)
RENAMED = {"pallas_launches": "kernel_launches",
           "pallas_cells_stepped": "kernel_cells_stepped"}
# the port's own counters: what K1 itself solved, how the router found a
# model, cnf_prep's propagation rounds, the deadline runner's calls and
# their hand-off cost, and the dispatch loops' stops at the window budget
PORT_ONLY = {"aig_device_component_hits", "aig_host_components",
             "router_device_found", "router_host_settled",
             "router_trivial_settled", "cnf_prep_rounds",
             "deadline_runner_calls", "deadline_handoff_wall",
             "router_deadline_stops"}


@pytest.fixture(autouse=True)
def fresh_stats(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    for stats in (SolverStatistics(), ReferenceStatistics()):
        stats.reset()
    yield
    for stats in (SolverStatistics(), ReferenceStatistics()):
        stats.reset()


def test_port_lint_exits_zero(capsys):
    rc = stats_keys.main()
    captured = capsys.readouterr()
    assert rc == 0, f"unemitted statistics counters:\n{captured.err}"
    assert captured.out.startswith("ok: ")


def test_lint_detects_a_counter_missing_from_as_dict(monkeypatch, capsys):
    """The lint fails when as_dict() drops a counter (it does not match
    vacuously)."""
    as_dict = SolverStatistics.as_dict

    def without_a_counter(self):
        out = as_dict(self)
        del out["cdcl_settles"]
        return out

    monkeypatch.setattr(SolverStatistics, "as_dict", without_a_counter)
    assert stats_keys.main() == 1
    assert "cdcl_settles" in capsys.readouterr().err


def test_lint_detects_a_roofline_stage_mismatch(monkeypatch):
    from mythril_tpu_torch.observe import roofline

    monkeypatch.setattr(roofline, "STAGES", roofline.STAGES + ("ship2",))
    failures = stats_keys.violations()
    assert any("roofline stages" in failure for failure in failures)


def test_as_dict_keys_equal_the_reference_less_unported():
    reference = set(ReferenceStatistics().as_dict())
    port = set(SolverStatistics().as_dict())
    assert set(NOT_PORTED) <= reference
    assert set(NOT_PORTED) | set(RENAMED) <= reference - port
    expected = ((reference - set(NOT_PORTED) - set(RENAMED))
                | set(RENAMED.values()) | PORT_ONLY)
    assert port == expected, (
        f"port only: {sorted(port - expected)}; "
        f"missing: {sorted(expected - port)}")


def test_opcode_wall_and_suffix_hist_equal_the_reference():
    """KILLBILLY at -t 2 on the host backend, both packages' frontiers on:
    the per-state interpreter runs the same opcodes (counts, not seconds)
    and the prefix resumes the same suffix sizes."""
    code = wrap_creation(KILLBILLY)
    seen = {}
    for package, stats in (("mythril_tpu", ReferenceStatistics()),
                           ("mythril_tpu_torch", SolverStatistics())):
        stats.reset()
        run_analyze(package, code, 2, "cpu", 60, pruning_factor=1)
        seen[package] = (
            {op: count for op, (count, _s)
             in stats.interp_opcode_wall.items()},
            dict(stats.prepare_suffix_hist))
    assert seen["mythril_tpu"][0], "no opcode ran on the per-state path"
    assert seen["mythril_tpu_torch"] == seen["mythril_tpu"]
