"""`analyze -a` and `safe-functions` of the port against the JAX package's
on the same inputs, through each package's CLI in this process: the
contract is served with its storage by a pinned chain on 127.0.0.1
(mythril_tpu_torch/ethereum/interface/local.py). Host-backend reports are
byte for byte the JAX package's; the port's device runs (--torch-device
cpu: the kernels' plain versions) agree at issue granularity. Without a
card and with no device named, each device entry point exits 2."""

import importlib
import json
import os
import subprocess
import sys

import pytest

from mythril_tpu_torch.disasm.asm import easm_to_code
from mythril_tpu_torch.ethereum.interface.local import LocalChain
from mythril_tpu_torch.gpu.device import NoDeviceError
from tests.test_analysis import KILLBILLY, wrap_creation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADDRESS = "0x" + "4b" * 20
# KILLBILLY whose kill() first reads an unlock flag from storage slot 0,
# and a harmless ping()
GUARDED = easm_to_code("""
    PUSH1 0x00
    CALLDATALOAD
    PUSH1 0xe0
    SHR
    DUP1
    PUSH4 0x41c0e1b5
    EQ
    PUSH1 @kill
    JUMPI
    DUP1
    PUSH4 0x5c36b186
    EQ
    PUSH1 @ping
    JUMPI
    STOP
:ping
    JUMPDEST
    STOP
:kill
    JUMPDEST
    PUSH1 0x00
    SLOAD
    PUSH1 @open
    JUMPI
    STOP
:open
    JUMPDEST
    CALLER
    SELFDESTRUCT
""")


@pytest.fixture(autouse=True)
def no_proxy(monkeypatch):
    for key in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY",
                "all_proxy", "ALL_PROXY"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    # a dispatch budget a loaded host cannot overrun on the plain round
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_DEADLINE", "600")
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_MAX_WASTE", "600")


def run_cli(package, argv, capsys):
    """`package`'s CLI in this process from fresh solve state: (exit code,
    stdout). Both packages' args and the execution budget are reset
    after."""
    cli = importlib.import_module(f"{package}.interfaces.cli")
    args = importlib.import_module(f"{package}.support.args").args
    model = importlib.import_module(f"{package}.support.model")
    frontend = importlib.import_module(f"{package}.smt.solver.frontend")
    time_handler = importlib.import_module(
        f"{package}.support.time_handler").time_handler
    args.reset()
    model.clear_caches()
    frontend._global_blaster = None
    try:
        code = cli.execute_command(cli.build_parser().parse_args(argv))
    finally:
        time_handler.start_execution(None)
        args.reset()
    return code, capsys.readouterr().out


def _keys(json_text):
    return sorted((issue["swc-id"], issue["function"], issue["address"],
                   issue["title"])
                  for issue in json.loads(json_text)["issues"])


@pytest.fixture
def chain():
    with LocalChain({ADDRESS: {"code": "0x" + GUARDED.hex(),
                               "storage": {0: 1}, "balance": 10 ** 18}}) \
            as local:
        yield local


def _analyze_a(chain, outform, *extra):
    return ["analyze", "-a", ADDRESS, "--rpc", f"127.0.0.1:{chain.port}",
            "-t", "2", "-o", outform, *extra]


@pytest.mark.parametrize("outform", ["text", "json"])
def test_analyze_address_host_report_is_the_references(chain, outform,
                                                        capsys):
    ref = run_cli("mythril_tpu", _analyze_a(chain, outform), capsys)
    requests = dict(chain.requests)
    chain.requests.clear()
    port = run_cli("mythril_tpu_torch",
                   _analyze_a(chain, outform, "--solver-backend", "cpu"),
                   capsys)
    assert port == ref
    assert port[0] == 1 and "Unprotected Selfdestruct" in port[1]
    # code and the unlock flag came from the chain, in both packages
    assert dict(chain.requests) == requests == {"eth_getCode": 1,
                                                "eth_getStorageAt": 1}


def test_analyze_address_device_run_matches_at_issue_granularity(chain,
                                                                  capsys):
    host = run_cli("mythril_tpu", _analyze_a(chain, "json"), capsys)
    device = run_cli("mythril_tpu_torch",
                     _analyze_a(chain, "json", "--torch-device", "cpu"),
                     capsys)
    assert device[0] == host[0] == 1
    assert _keys(device[1]) == _keys(host[1])
    assert _keys(device[1])


def test_storage_read_from_the_chain_steers_the_analysis(capsys):
    """With the unlock flag 0 on the chain, kill() cannot selfdestruct: the
    lazily loaded slot is concrete, in both packages."""
    with LocalChain({ADDRESS: {"code": "0x" + GUARDED.hex()}}) as locked:
        argv = _analyze_a(locked, "json")
        ref = run_cli("mythril_tpu", argv, capsys)
        port = run_cli("mythril_tpu_torch",
                       argv + ["--solver-backend", "cpu"], capsys)
    assert port == ref
    assert port[0] == 0 and _keys(port[1]) == []


@pytest.mark.parametrize("runtime", [KILLBILLY, GUARDED],
                         ids=["killbilly", "guarded"])
def test_safe_functions_lists_equal_the_references(runtime, capsys):
    argv = ["safe-functions", "-c", runtime.hex(), "--bin-runtime", "-t",
            "2"]
    ref = run_cli("mythril_tpu", argv, capsys)
    host = run_cli("mythril_tpu_torch", argv + ["--solver-backend", "cpu"],
                   capsys)
    device = run_cli("mythril_tpu_torch", argv + ["--torch-device", "cpu"],
                     capsys)
    assert host == device == ref
    expected = 0 if runtime is KILLBILLY else 1
    assert ref[1].splitlines()[0] == \
        f"{expected} functions are deemed safe in this contract:"


def test_safe_functions_creation_code_matches(capsys):
    argv = ["safe-functions", "-c", wrap_creation(KILLBILLY), "-t", "1"]
    ref = run_cli("mythril_tpu", argv, capsys)
    assert run_cli("mythril_tpu_torch", argv + ["--solver-backend", "cpu"],
                   capsys) == ref


@pytest.fixture
def no_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_device_raises_for_each_device_entry_point(chain, no_card,
                                                      tmp_path, capsys):
    from mythril_tpu_torch.interfaces import cli

    concrete = tmp_path / "input.json"
    concrete.write_text(json.dumps({
        "initialState": {"accounts": {ADDRESS: {
            "code": "0x" + GUARDED.hex(), "nonce": 0, "balance": "0x0",
            "storage": {}}}},
        "steps": [{"address": ADDRESS, "origin": "0x" + "ab" * 20,
                   "input": "0x41c0e1b5", "value": "0x0"}]}))
    for argv in (_analyze_a(chain, "text"),
                 ["safe-functions", "-c", GUARDED.hex(), "--bin-runtime"],
                 ["concolic", str(concrete), "--branches", "9"]):
        with pytest.raises(cli.CliError, match="no CUDA device"):
            run_cli("mythril_tpu_torch", argv, capsys)
    from mythril_tpu_torch.concolic import concolic_execution
    from mythril_tpu_torch.support.args import args

    try:
        with pytest.raises(NoDeviceError):
            concolic_execution(json.loads(concrete.read_text()), [9])
    finally:
        args.reset()


@pytest.mark.parametrize("subcommand", ["safe-functions", "analyze-a"])
def test_no_device_exits_2_in_a_new_process(subcommand, chain):
    argv = (["safe-functions", "-c", GUARDED.hex(), "--bin-runtime"]
            if subcommand == "safe-functions" else _analyze_a(chain, "text"))
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", *argv],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
