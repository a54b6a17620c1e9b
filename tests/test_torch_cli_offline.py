"""The port's offline CLI surface against the JAX package's: disassemble
(and its alias d), function-to-hash, hash-to-address and list-detectors
print byte for byte what mythril_tpu's CLI prints; --epic re-runs the
port through the rainbow filter and exits with the run's code; and the
two parsers have the same subcommands, aliases and option strings, the
port's device options apart."""

import argparse
import io
import os
import re
import sqlite3
import subprocess
import sys

import pytest

from mythril_tpu.interfaces import cli as ref_cli
from mythril_tpu.interfaces import epic as ref_epic
from mythril_tpu.support.signatures import SignatureDB as RefSignatureDB
from mythril_tpu_torch.interfaces import cli as port_cli
from mythril_tpu_torch.interfaces import epic as port_epic
from mythril_tpu_torch.support.signatures import SignatureDB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PUSH1 0x0a PUSH1 0x0c PUSH1 0x00 CODECOPY PUSH1 0x0a RETURN STOP, then the
# runtime code PUSH1 1 PUSH1 2 ADD PUSH1 0 SSTORE STOP
CREATION = "600a600c600039600af3006001600201600055" + "00"
RUNTIME = "6001600201600055" + "00"
# the port's device options, on the subparsers that take them
DEVICE_OPTIONS = {
    "analyze": {"--torch-device"},
    "safe-functions": {"--torch-device"},
    "foundry": {"--torch-device"},
    "serve": {"--torch-device"},
    "autotune": {"--solver-backend", "--torch-device"},
    "concolic": {"--solver-backend", "--torch-device"},
}


def _run(cli, argv, capsys):
    code = cli.execute_command(cli.build_parser().parse_args(argv))
    return code, capsys.readouterr().out


@pytest.fixture
def signature_dbs(tmp_path, monkeypatch):
    """One signatures.db under tmp_path with the reference schema, read by
    both packages (MYTHRIL_DIR for the JAX package, MYTHRIL_GPU_CACHE_DIR
    for the port); both singletons fresh, and dropped after."""
    with sqlite3.connect(str(tmp_path / "signatures.db")) as conn:
        conn.execute(
            "CREATE TABLE IF NOT EXISTS signatures"
            "(byte_sig VARCHAR(10), text_sig VARCHAR(255),"
            "PRIMARY KEY (byte_sig, text_sig))")
        for byte_sig, text_sig in (
                ("0xdeadbeef", "refOnlyFunction(uint256)"),
                ("0xdeadbeef", "aCollision(bytes32)"),
                ("0x41c0e1b5", "kill()")):
            conn.execute("INSERT OR IGNORE INTO signatures VALUES (?,?)",
                         (byte_sig, text_sig))
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path))
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    saved = RefSignatureDB._instance
    RefSignatureDB._instance = None
    SignatureDB.reset()
    yield
    RefSignatureDB._instance = saved
    SignatureDB.reset()


@pytest.mark.parametrize("argv", [
    ["disassemble", "-c", CREATION],
    ["disassemble", "-c", RUNTIME, "--bin-runtime"],
    ["disassemble", "-c", "0x" + CREATION],
    ["function-to-hash", "transfer(address,uint256)"],
    ["function-to-hash", "kill()"],
    ["hash-to-address", "0xdeadbeef"],
    ["hash-to-address", "41c0e1b5"],
    ["hash-to-address", "0xa9059cbb"],
    ["hash-to-address", "0x00000000"],
    ["list-detectors"],
], ids=lambda argv: "-".join(argv[:2])[:40])
def test_offline_output_is_the_reference_bytes(argv, signature_dbs, capsys):
    ref_code, ref_out = _run(ref_cli, argv, capsys)
    code, out = _run(port_cli, argv, capsys)
    assert (code, out) == (ref_code, ref_out)
    assert out.strip()


def test_the_signature_db_is_only_read(signature_dbs, tmp_path, capsys):
    path = tmp_path / "signatures.db"
    before = path.read_bytes()
    _run(port_cli, ["hash-to-address", "0xdeadbeef"], capsys)
    assert path.read_bytes() == before


def test_disassemble_file_and_alias_match_in_new_processes(tmp_path):
    code_file = tmp_path / "c.hex"
    code_file.write_text(CREATION + "\n")
    outputs = []
    for package in ("mythril_tpu", "mythril_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", package, "d", "-f", str(code_file)],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stderr
        outputs.append(proc.stdout)
    assert outputs[0] == outputs[1]
    assert "Disassembly:" in outputs[1]


def test_epic_filter_is_the_references():
    text = "line one\nline two, longer\n\n"
    outputs = []
    for module in (ref_epic, port_epic):
        out = io.StringIO()
        module.colorize(io.StringIO(text), out)
        outputs.append(out.getvalue())
    assert outputs[0] == outputs[1]
    assert "\x1b[38;5;" in outputs[1]


@pytest.mark.parametrize("argv, code", [
    (["version"], 0),
    # no device and none named: the child exits 2, and so does --epic
    (["analyze", "-c", RUNTIME, "--bin-runtime", "-t", "1"], 2),
])
def test_epic_exits_with_the_childs_code(argv, code):
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "--epic", *argv],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == code, proc.stderr
    if code == 0:
        from mythril_tpu_torch.version import __version__

        assert "\x1b[38;5;" in proc.stdout
        plain = re.sub(r"\x1b\[[0-9;]*m", "", proc.stdout)
        assert plain.strip() == f"mythril_tpu_torch {__version__}"


def _surface(parser):
    subparsers = next(action for action in parser._actions
                      if isinstance(action, argparse._SubParsersAction))
    surface = {"": sorted(option for action in parser._actions
                          for option in action.option_strings)}
    for name, sub in subparsers.choices.items():
        surface[name] = sorted(
            [option for action in sub._actions
             for option in action.option_strings]
            + [action.dest for action in sub._actions
               if not action.option_strings])
    return surface


def test_the_parsers_have_the_same_surface():
    reference = _surface(ref_cli.build_parser())
    port = _surface(port_cli.build_parser())
    assert sorted(port) == sorted(reference)
    for name, options in reference.items():
        extra = set(port[name]) - set(options)
        assert extra == DEVICE_OPTIONS.get(name, set()), name
        assert set(options) <= set(port[name]), name
    assert port_cli.COMMAND_ALIASES == ref_cli.COMMAND_ALIASES
