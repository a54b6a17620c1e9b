"""The interleaved corpus cell end to end on the CPU at a tiny size: a batch
of two contracts (suicide and origin) with --corpus-interleave 2, the
port's kernels in their plain versions. `correct` holds on the real
program and falls for the control and for two faults of the batch: a
finding reported under its neighbour's name, and half of the batch's
contracts left out."""

import pytest

from port_bench import run, spec

COORDINATOR_METRICS = {"origins_per_flush", "switch_s_per_contract"}
DEVICE_METRICS = {"device_idle_share.interleave", "k1_roofline.interleave"}


def _small():
    cell = spec.load_cell("upstream-interleave4")
    config = dict(cell.config)
    config["contracts"] = [entry for entry in config["contracts"]
                           if entry["name"] in ("suicide", "origin")]
    config["envelope"] = dict(config["envelope"], corpus_interleave=2)
    return cell._replace(config=config, mix=dict(cell.mix, batch=2))


def _measure(traced=True, control=None):
    cell = _small()
    record = run.measure(cell, 2 ** 31 + 7, 1.0, traced, device="cpu",
                         control=control, clock=lambda: 1.0)
    return record, run.result_line(cell, record, traced, {"platform": "cpu"})


def test_corpus_cell_on_the_cpu(cpu_settings):
    record, line = _measure()
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == record.items_run >= 2
    assert line["checks"]["wrong_reports"]["value"] == 0
    reported = set(line["metrics"])
    # mixed_cone_share has a divisor only where the router dispatched a
    # cone: on the CPU the host may settle these contracts' few queries
    dispatched = record.stats["device_dispatched_queries"]
    assert reported == COORDINATOR_METRICS | (
        {"mixed_cone_share"} if dispatched else set())
    assert not reported & DEVICE_METRICS     # no device trace on the CPU
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert record.stats["interleave_handoffs"] > 0
    assert line["metrics"]["origins_per_flush"]["value"] >= 1
    _record, plain = _measure(traced=False)
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"contracts_per_hour", "setup_s"}
    assert run.forbidden_modules() == []


def test_corpus_control_fails(cpu_settings):
    _record, line = _measure(traced=False, control="drop")
    assert line["correct"] is False
    assert line["checks"]["wrong_reports"]["value"] == line["attempted"]


def _patch_fire_lasers(monkeypatch, before=None, after=None):
    from mythril_tpu_torch.core import MythrilAnalyzer

    original = MythrilAnalyzer.fire_lasers

    def fire_lasers(self, *args, **kwargs):
        if before is not None:
            before(self)
        report = original(self, *args, **kwargs)
        if after is not None:
            after(self, report)
        return report

    monkeypatch.setattr(MythrilAnalyzer, "fire_lasers", fire_lasers)


def _to_the_neighbour(analyzer, report):
    """The first contract's findings reported under the second's name."""
    first, second = (contract.name for contract in analyzer.contracts[:2])
    for issue in report.issues.values():
        if issue.contract == first:
            issue.contract = second


def _half_left_out(analyzer):
    analyzer.contracts = analyzer.contracts[:len(analyzer.contracts) // 2]


@pytest.mark.parametrize("fault", [{"after": _to_the_neighbour},
                                   {"before": _half_left_out}],
                         ids=["finding-under-the-neighbour",
                              "half-left-out"])
def test_corpus_faults_fail(cpu_settings, monkeypatch, fault):
    _patch_fire_lasers(monkeypatch, **fault)
    _record, line = _measure(traced=False)
    assert line["correct"] is False
    assert line["checks"]["wrong_reports"]["value"] >= 1
