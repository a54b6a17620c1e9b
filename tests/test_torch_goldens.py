"""The report snapshots of tests/test_goldens.py (text and jsonv2, in
tests/testdata/expected_reports/) through the port's CLI.

The contracts' bytecode is not in the repo: each snapshot's first
transaction creates the contract, and its input is the code
(torch_helpers.snapshot_input). The jsonv2 meta names the tool: the
port's is its own package, the snapshots' the JAX package.

The snapshots hold the JAX package's engine with its frontier off: with
it on, the JAX package reports exceptions_0.8.0.sol.o's two assertion
issues in the other order, each with the other's description and gas
estimate (so does the port). So each contract is analyzed once with
`analyze -t 1 --solver-backend cpu --solver-timeout 60000
--no-vmap-frontier` and both formats are rendered from that run against
the snapshots; and once with the default engine (the frontier on) in
both packages, whose reports must be byte-identical.
"""

import json
import os
import re

import pytest

from tests.torch_helpers import SNAPSHOTS, snapshot_input

SNAPSHOT_CASES = [
    ("suicide.sol.o", 1),
    ("origin.sol.o", 1),
    ("exceptions_0.8.0.sol.o", 1),
]

_REPORTS = {}


def _report(file_name: str, tx_count: int, *flags):
    """The port's Report for one snapshot contract through the CLI's
    parser and analyzer, analyzed once per flag set."""
    key = (file_name, flags)
    if key not in _REPORTS:
        from mythril_tpu_torch.core import (
            MythrilAnalyzer,
            MythrilDisassembler,
        )
        from mythril_tpu_torch.interfaces import cli
        from mythril_tpu_torch.smt.solver import frontend
        from mythril_tpu_torch.support.args import args
        from mythril_tpu_torch.support.model import clear_caches

        args.reset()
        clear_caches()
        frontend._global_blaster = None
        parsed = cli.build_parser().parse_args(
            ["analyze", "-c", snapshot_input(file_name), "-t",
             str(tx_count), "--solver-backend", "cpu", "--solver-timeout",
             "60000", *flags])
        disassembler = MythrilDisassembler()
        disassembler.load_from_bytecode(parsed.code)
        try:
            analyzer = MythrilAnalyzer(disassembler, cmd_args=parsed,
                                       strategy=parsed.strategy)
            report = analyzer.fire_lasers(
                transaction_count=parsed.transaction_count)
        finally:
            args.reset()
        assert not report.exceptions, report.exceptions
        _REPORTS[key] = report
    return _REPORTS[key]


def _normalize_text_report(text: str) -> str:
    # estimated gas numbers move with gas-model tuning; pin structure, not gas
    return re.sub(r"Estimated Gas Usage: \d+ - \d+", "Estimated Gas Usage: X",
                  text).strip()


def _normalize_jsonv2(text: str, tool_name: str) -> str:
    data = json.loads(text.strip().splitlines()[-1])
    for result in data:
        for issue in result.get("issues", []):
            issue.pop("extra", None)  # carries per-run solver models
        assert result["meta"]["toolName"] == tool_name
        result["meta"]["toolName"] = "mythril_tpu"
    return json.dumps(data, indent=1, sort_keys=True)


def _snapshot(file_name: str, suffix: str) -> str:
    with open(os.path.join(SNAPSHOTS, file_name + suffix)) as handle:
        return handle.read().strip()


@pytest.mark.parametrize("file_name, tx_count", SNAPSHOT_CASES,
                         ids=[c[0] for c in SNAPSHOT_CASES])
def test_text_report_snapshot(file_name, tx_count):
    report = _report(file_name, tx_count, "--no-vmap-frontier")
    assert (_normalize_text_report(report.as_text())
            == _snapshot(file_name, ".text"))


@pytest.mark.parametrize("file_name, tx_count", SNAPSHOT_CASES,
                         ids=[c[0] for c in SNAPSHOT_CASES])
def test_jsonv2_report_snapshot(file_name, tx_count):
    report = _report(file_name, tx_count, "--no-vmap-frontier")
    got = _normalize_jsonv2(report.as_swc_standard_format(),
                            "mythril_tpu_torch")
    assert got == _snapshot(file_name, ".jsonv2")


@pytest.mark.parametrize("file_name, tx_count", SNAPSHOT_CASES,
                         ids=[c[0] for c in SNAPSHOT_CASES])
def test_default_engine_report_equals_the_reference(file_name, tx_count):
    from tests.torch_helpers import run_analyze

    port = _report(file_name, tx_count)
    reference = run_analyze("mythril_tpu", snapshot_input(file_name),
                            tx_count, "cpu", 86400)
    assert port.as_text() == reference.as_text()
    assert port.as_json() == reference.as_json()
    assert (_normalize_jsonv2(port.as_swc_standard_format(),
                              "mythril_tpu_torch")
            == _normalize_jsonv2(reference.as_swc_standard_format(),
                                 "mythril_tpu"))
