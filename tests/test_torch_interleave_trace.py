"""The interleave coordinator's spans and counters (service/interleave.py):
on a two-contract interleaved run on the host backend (upstream's suicide
and origin at -t 1) the coordinator hands the baton on, switches the
engine contexts and flushes the shared window, each counted and traced;
tracing changes no byte of the report; and a plain single-contract run
counts none of it."""

import json
import os
from types import SimpleNamespace

import pytest

from mythril_tpu_torch.observe import get_tracer
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACTS = os.path.join(REPO_ROOT, "port_bench", "data", "contracts")
COUNTERS = ("interleave_handoffs", "interleave_switch_wall",
            "interleave_flushes", "interleave_flush_origins")
SPANS = {"interleave.turn", "interleave.switch", "interleave.park",
         "interleave.flush"}


def _run(names, traced):
    """(report JSON, the four counters, the span names traced) of one
    fire_lasers over `names` at -t 1 with --corpus-interleave 2."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler

    args.reset()
    model_mod.clear_caches()
    stats = SolverStatistics()
    stats.reset()
    tracer = get_tracer()
    tracer.reset()
    if traced:
        tracer.enable(None)
    cmd_args = SimpleNamespace(
        execution_timeout=120, transaction_count=1, max_depth=128,
        pruning_factor=1.0, solver_backend="cpu", corpus_interleave=2)
    disassembler = MythrilDisassembler()
    for name in names:
        with open(os.path.join(CONTRACTS, name + ".hex")) as handle:
            disassembler.load_from_bytecode(handle.read().strip(),
                                            name=name)
    try:
        report = MythrilAnalyzer(disassembler, cmd_args=cmd_args,
                                 strategy="bfs").fire_lasers(
            transaction_count=1)
        spans = {event["name"] for event in tracer.events()}
    finally:
        tracer.reset()
        args.reset()
    return (report.as_json(), {key: getattr(stats, key) for key in COUNTERS},
            spans)


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    mp.delenv("MYTHRIL_GPU_CORPUS_INTERLEAVE", raising=False)
    try:
        yield {"traced": _run(("suicide", "origin"), True),
               "untraced": _run(("suicide", "origin"), False),
               "single": _run(("suicide",), True)}
    finally:
        model_mod.clear_caches()
        SolverStatistics().reset()
        mp.undo()


def test_the_coordinator_counts_its_handoffs_switches_and_flushes(runs):
    _report, counters, _spans = runs["traced"]
    assert counters["interleave_handoffs"] > 0
    assert counters["interleave_switch_wall"] > 0
    assert counters["interleave_flushes"] > 0
    # a flushed window holds one or both contracts' queries
    assert counters["interleave_flushes"] \
        <= counters["interleave_flush_origins"] \
        <= 2 * counters["interleave_flushes"]


def test_the_four_spans_are_traced(runs):
    _report, _counters, spans = runs["traced"]
    assert SPANS <= spans


def test_tracing_changes_no_byte_of_the_report(runs):
    traced, _counters, _spans = runs["traced"]
    untraced, counters, _spans = runs["untraced"]
    assert json.loads(traced)["issues"], "vacuous parity proves nothing"
    assert traced == untraced
    assert counters["interleave_handoffs"] > 0


def test_a_plain_run_counts_and_traces_none_of_it(runs):
    report, counters, spans = runs["single"]
    assert json.loads(report)["issues"]
    assert counters == {key: 0 for key in COUNTERS}
    assert not SPANS & spans
