"""The analyze flags the port's CLI gained with the engine options:
--enable-state-merging, --enable-summaries, --disable-incremental-txs,
-g/--graph, -j/--statespace-json, --solver-log, --parallel-solving and
--unconstrained-storage, each held to the JAX package's CLI
(mythril_tpu/interfaces/cli.py:221-222, :235, :319-333, :548-557).

-j's statespace dump must equal the reference's byte for byte. -g's
vis.js page must hold the same node and edge sets; its title names the
package, the one line that differs."""

import importlib
import json
import re

import pytest

from mythril_tpu_torch.gpu.device import NoDeviceError

from tests.test_summaries import KILLBILLY, STORE_THEN_KILL, wrap_creation

EXECUTION_TIMEOUT = 60  # s, never reached by these contracts
PACKAGES = ("mythril_tpu", "mythril_tpu_torch")
NEW_FLAGS = ["--enable-state-merging", "--enable-summaries",
             "--disable-incremental-txs", "--solver-log", "smt2",
             "--parallel-solving", "--unconstrained-storage"]
# the dests the new flags set, and the args field each lands in
DESTS = ("enable_state_merging", "enable_summaries",
         "disable_incremental_txs", "solver_log", "parallel_solving",
         "unconstrained_storage")
ARGS_FIELDS = ("enable_state_merging", "enable_summaries", "incremental_txs",
               "solver_log", "parallel_solving", "unconstrained_storage")


def _pkg(package, name):
    return importlib.import_module(f"{package}.{name}")


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' args and solve caches reset around the test, and the
    JAX package's execution budget ended after it."""
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    for package in PACKAGES:
        _pkg(package, "support.args").args.reset()
        _pkg(package, "support.model").clear_caches()
    yield
    for package in PACKAGES:
        _pkg(package, "support.args").args.reset()
        _pkg(package, "support.model").clear_caches()
        _pkg(package, "support.time_handler").time_handler.start_execution(
            None)


def _parse(package, *argv):
    return _pkg(package, "interfaces.cli").build_parser().parse_args(
        ["analyze", *argv])


def _run_cli(package, *argv):
    """execute_command of `analyze argv` in `package`: its exit code."""
    cli = _pkg(package, "interfaces.cli")
    return cli.execute_command(cli.build_parser().parse_args(
        ["analyze", *argv]))


def test_new_flags_parse_as_the_reference(fresh):
    parsed = {package: _parse(package, "-c", "00", *NEW_FLAGS, "-g", "g.html",
                              "-j", "s.json") for package in PACKAGES}
    for dest in DESTS + ("graph", "statespace_json"):
        assert getattr(parsed["mythril_tpu_torch"], dest) == getattr(
            parsed["mythril_tpu"], dest), dest
    defaults = {package: _parse(package, "-c", "00") for package in PACKAGES}
    for dest in DESTS + ("graph", "statespace_json"):
        assert getattr(defaults["mythril_tpu_torch"], dest) == getattr(
            defaults["mythril_tpu"], dest), dest


@pytest.mark.parametrize("flagged", [False, True])
def test_new_flags_reach_the_args_as_the_reference(fresh, flagged):
    extra = NEW_FLAGS if flagged else []
    for package in PACKAGES:
        core = _pkg(package, "core")
        core.MythrilAnalyzer(core.MythrilDisassembler(),
                             cmd_args=_parse(package, "-c", "00", *extra))
    port = _pkg("mythril_tpu_torch", "support.args").args
    reference = _pkg("mythril_tpu", "support.args").args
    for field in ARGS_FIELDS:
        assert getattr(port, field) == getattr(reference, field), field
    assert port.incremental_txs is not flagged
    assert port.enable_summaries is flagged


@pytest.mark.parametrize("extra", [
    ["--solver-log", "smt2", "--parallel-solving",
     "--unconstrained-storage"],
    ["--enable-state-merging"],
    ["--enable-summaries"],
])
def test_flagged_reports_equal_the_reference(fresh, capsys, extra):
    """The accepted-only flags change nothing, state merging and summaries
    find what the reference finds: the same json report, the same exit
    code."""
    outputs = {}
    for package in PACKAGES:
        code = _run_cli(package, "-c", wrap_creation(STORE_THEN_KILL), "-t",
                        "2", "--solver-backend", "cpu", "-o", "json",
                        "--execution-timeout", str(EXECUTION_TIMEOUT), *extra)
        outputs[package] = (code, capsys.readouterr().out)
        _pkg(package, "support.args").args.reset()
        _pkg(package, "support.model").clear_caches()
    assert outputs["mythril_tpu_torch"] == outputs["mythril_tpu"]
    assert outputs["mythril_tpu"][0] == 1
    assert any(issue["swc-id"] == "106" for issue in json.loads(
        outputs["mythril_tpu"][1])["issues"])


def test_disable_incremental_txs_has_the_reference_effect(fresh, capsys):
    """STORE_THEN_KILL's runtime at -t 1: incremental ordering finds the
    guarded kill(); the prioritiser pins tx 1 to the setter, and both
    packages then report nothing."""
    outputs = {}
    for package in PACKAGES:
        for extra in ([], ["--disable-incremental-txs"]):
            code = _run_cli(package, "-c", STORE_THEN_KILL.hex(),
                            "--bin-runtime", "-t", "1", "--solver-backend",
                            "cpu", "-o", "json", "--execution-timeout",
                            str(EXECUTION_TIMEOUT), *extra)
            issues = json.loads(capsys.readouterr().out)["issues"]
            outputs[package, bool(extra)] = (code, [issue["swc-id"]
                                                    for issue in issues])
            _pkg(package, "support.args").args.reset()
            _pkg(package, "support.model").clear_caches()
    for flagged in (False, True):
        assert outputs["mythril_tpu_torch", flagged] == outputs[
            "mythril_tpu", flagged]
    assert outputs["mythril_tpu", False] == (1, ["106"])
    assert outputs["mythril_tpu", True] == (0, [])


def _dump(package, flag, path, *extra):
    """The -g or -j file of KILLBILLY -t 1 from `package`'s CLI, its
    transaction ids, CFG node uids, balance arrays and hash symbols
    counted from the start, as in a fresh process (the dump carries
    them)."""
    _pkg(package, "laser.transaction.models").tx_id_manager.restart_counter()
    _pkg(package, "laser.cfg")._next_uid[0] = 0
    _pkg(package, "laser.state.world_state").WorldState.next_balance_id = 1
    _pkg(package, "laser.function_managers").keccak_function_manager.reset()
    code = _run_cli(package, "-c", wrap_creation(KILLBILLY), "-t", "1",
                    flag, str(path), "--execution-timeout",
                    str(EXECUTION_TIMEOUT), *extra)
    _pkg(package, "support.args").args.reset()
    _pkg(package, "support.model").clear_caches()
    assert code == 0
    return path.read_text()


@pytest.mark.parametrize("backend", [
    ["--solver-backend", "cpu"],
    ["--torch-device", "cpu"],
])
def test_statespace_json_equals_the_reference(fresh, tmp_path, backend):
    reference = _dump("mythril_tpu", "-j", tmp_path / "reference.json",
                      "--solver-backend", "cpu")
    port = _dump("mythril_tpu_torch", "-j", tmp_path / "port.json", *backend)
    assert port == reference
    dump = json.loads(port)
    assert dump["nodes"] and dump["edges"]


def _graph_sets(html):
    """The page's node and edge sets, and the page with its title cut."""
    nodes = json.loads(re.search(r"new vis\.DataSet\((\[.*?\])\);\n",
                                 html).group(1))
    edges = json.loads(re.findall(r"new vis\.DataSet\((\[.*?\])\);\n",
                                  html)[1])
    page = re.sub(r"<title>.*</title>", "<title></title>", html)
    return ({json.dumps(node, sort_keys=True) for node in nodes},
            {json.dumps(edge, sort_keys=True) for edge in edges}, page)


@pytest.mark.parametrize("backend", [
    ["--solver-backend", "cpu"],
    ["--torch-device", "cpu"],
])
def test_graph_has_the_reference_nodes_and_edges(fresh, tmp_path, backend):
    reference = _graph_sets(_dump("mythril_tpu", "-g",
                                  tmp_path / "reference.html",
                                  "--solver-backend", "cpu"))
    port = _graph_sets(_dump("mythril_tpu_torch", "-g", tmp_path /
                             "port.html", *backend))
    assert port[0] == reference[0] and port[1] == reference[1]
    assert len(port[0]) >= 4 and len(port[1]) >= 2
    assert port[2] == reference[2]


@pytest.mark.parametrize("flag", ["-g", "-j"])
def test_dumps_on_the_device_backend_need_a_card(fresh, tmp_path,
                                                 monkeypatch, flag):
    """Without a card and with no device named, a dump on the device
    backend raises NoDeviceError before exploring (the CLI exits 2)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli = _pkg("mythril_tpu_torch", "interfaces.cli")
    parsed = cli.build_parser().parse_args(
        ["analyze", "-c", wrap_creation(KILLBILLY), "-t", "1", flag,
         str(tmp_path / "out")])
    core = _pkg("mythril_tpu_torch", "core")
    disassembler = core.MythrilDisassembler()
    disassembler.load_from_bytecode(parsed.code)
    analyzer = core.MythrilAnalyzer(disassembler, cmd_args=parsed)
    with pytest.raises(NoDeviceError):
        (analyzer.graph_html if flag == "-g" else analyzer.dump_statespace)()
    with pytest.raises(cli.CliError):
        cli.execute_command(parsed)
    assert not (tmp_path / "out").exists()
