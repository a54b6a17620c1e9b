"""The port's `analyze` CLI (`python -m mythril_tpu_torch`): exit codes,
the other subcommands and the device backend's default without a card;
and test_module_firing.py's cases run through the port."""

import json
import subprocess
import sys

import pytest

from tests.test_analysis import KILLBILLY, easm_to_code, wrap_creation
from tests.torch_helpers import run_analyze

EXECUTION_TIMEOUT = 60  # s, never reached by these contracts


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", *argv],
        capture_output=True, text=True, timeout=300)


def test_cli_exits_one_iff_issues_found():
    found = _cli("analyze", "-c", wrap_creation(KILLBILLY), "-t", "1",
                 "--solver-backend", "cpu", "-o", "json",
                 "--execution-timeout", str(EXECUTION_TIMEOUT))
    assert found.returncode == 1, found.stderr
    payload = json.loads(found.stdout)
    assert payload["success"] is True
    assert any(issue["swc-id"] == "106" for issue in payload["issues"])
    clean = _cli("a", "-c", wrap_creation(easm_to_code("STOP")), "-t", "1",
                 "--solver-backend", "cpu", "-o", "json",
                 "--execution-timeout", str(EXECUTION_TIMEOUT))
    assert clean.returncode == 0, clean.stderr
    assert json.loads(clean.stdout)["issues"] == []


def test_cli_version_and_detectors():
    version = _cli("version")
    assert version.returncode == 0
    assert version.stdout.startswith("mythril_tpu_torch ")
    detectors = _cli("list-detectors")
    assert detectors.returncode == 0
    assert len(detectors.stdout.strip().splitlines()) == 17


def test_device_backend_without_a_card_raises():
    """gpu is the default backend: with no card and no device named,
    analyze stops before it explores anything, and never finishes on the
    host."""
    import torch

    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.gpu.device import NoDeviceError
    from mythril_tpu_torch.support.args import args

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    args.reset()
    assert args.solver_backend == "gpu" and args.torch_device is None
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode(wrap_creation(KILLBILLY))
    analyzer = MythrilAnalyzer(disassembler)
    with pytest.raises(NoDeviceError):
        analyzer.fire_lasers(transaction_count=1)
    args.reset()
    proc = _cli("analyze", "-c", wrap_creation(KILLBILLY), "-t", "1",
                "-o", "json")
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_cli_exits_two_on_a_partial_report(monkeypatch, capsys):
    """An exception that cuts a contract's analysis short leaves a partial
    report: it is printed, and the exit code is 2, never 0 for "no
    issues"."""
    from mythril_tpu_torch import core
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.args import args

    def broken_engine(*_args, **_kwargs):
        raise RuntimeError("injected engine failure")

    monkeypatch.setattr(core, "SymExecWrapper", broken_engine)
    parsed = cli.build_parser().parse_args(
        ["analyze", "-c", wrap_creation(easm_to_code("STOP")), "-t", "1",
         "--solver-backend", "cpu", "-o", "json"])
    try:
        assert cli.execute_command(parsed) == 2
    finally:
        args.reset()
    assert json.loads(capsys.readouterr().out)["issues"] == []


# -- test_module_firing.py's cases on the port ---------------------------------

_CALL_ONE = """
    PUSH1 0x00
    PUSH1 0x00
    PUSH1 0x00
    PUSH1 0x00
    PUSH1 0x00
    PUSH1 0x01
    PUSH2 0xffff
    CALL
    POP
"""

# name -> (runtime EASM, transaction count, module, SWC id, fires)
FIRING = {
    "arbitrary_jump": ("""
        PUSH1 0x00
        CALLDATALOAD
        JUMP
    :dest
        JUMPDEST
        STOP
    """, 1, "arbitrary_jump", "127", True),
    "arbitrary_delegatecall": ("""
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        CALLDATALOAD
        PUSH2 0xffff
        DELEGATECALL
        STOP
    """, 1, "arbitrary_delegatecall", "112", True),
    "external_calls": ("""
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        CALLDATALOAD
        PUSH2 0xffff
        CALL
        STOP
    """, 1, "external_calls", "107", True),
    "multiple_sends": (_CALL_ONE + _CALL_ONE + "\nSTOP", 1,
                       "multiple_sends", "113", True),
    "requirements_violation": ("""
        PUSH1 0x00
        CALLDATALOAD
        PUSH1 @docall
        JUMPI
        PUSH1 0x00
        PUSH1 0x00
        REVERT
    :docall
        JUMPDEST
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        ADDRESS
        PUSH2 0xffff
        CALL
        STOP
    """, 1, "requirements_violation", "123", True),
    "state_change_external_calls": ("""
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        CALLDATALOAD
        PUSH2 0xffff
        CALL
        POP
        PUSH1 0x01
        PUSH1 0x01
        SSTORE
        STOP
    """, 1, "state_change_external_calls", "107", True),
    "tx_order_dependence": ("""
        PUSH1 0x00
        CALLDATALOAD
        ISZERO
        PUSH1 @payout
        JUMPI
        PUSH1 0x00
        CALLDATALOAD
        PUSH1 0x00
        SSTORE
        STOP
    :payout
        JUMPDEST
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        SLOAD
        CALLER
        PUSH2 0xffff
        CALL
        STOP
    """, 2, "tx_order_dependence", "114", True),
    "tx_order_dependence_multi_taint": ("""
        PUSH1 0x00
        CALLDATALOAD
        ISZERO
        PUSH1 @payout
        JUMPI
        PUSH1 0x00
        CALLDATALOAD
        PUSH1 0x00
        SSTORE
        PUSH1 0x04
        CALLDATALOAD
        PUSH1 0x01
        SSTORE
        STOP
    :payout
        JUMPDEST
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        SLOAD
        PUSH1 0x01
        SLOAD
        ADD
        CALLER
        PUSH2 0xffff
        CALL
        STOP
    """, 2, "tx_order_dependence", "114", False),
    "unexpected_ether": ("""
        SELFBALANCE
        PUSH2 0x07d0
        EQ
        PUSH1 @eqbranch
        JUMPI
        STOP
    :eqbranch
        JUMPDEST
        STOP
    """, 1, "unexpected_ether", "132", True),
    "user_assertions": ("""
        PUSH32 0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0
        PUSH1 0x00
        PUSH1 0x00
        LOG1
        STOP
    """, 1, "user_assertions", "110", True),
}


@pytest.mark.parametrize("name", sorted(FIRING))
def test_module_fires(name):
    easm, tx_count, module, swc, fires = FIRING[name]
    report = run_analyze("mythril_tpu_torch",
                         wrap_creation(easm_to_code(easm)), tx_count, "cpu",
                         EXECUTION_TIMEOUT, modules=[module])
    swcs = {issue.swc_id for issue in report.issues.values()}
    assert (swc in swcs) == fires, swcs
    if name == "state_change_external_calls":
        issue = next(i for i in report.issues.values() if i.swc_id == swc)
        assert issue.severity == "Medium"  # user-defined callee address
