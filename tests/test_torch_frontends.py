"""The port's input layer against the JAX package's (the counterparts of
tests/test_frontends.py): the JSON-RPC client on a `_call` mock and on a
pinned chain on 127.0.0.1, the DynLoader, the config tier, foundry
build-info loading, read-storage's slot math, --solv resolution, srcmap
decoding and library placeholders, and solc compilation (gated on solc)."""

import json
import shutil

import pytest

from mythril_tpu.core import MythrilDisassembler as RefDisassembler
from mythril_tpu.ethereum.interface.client import EthJsonRpc as RefRpc
from mythril_tpu.interfaces import cli as ref_cli
from mythril_tpu.solidity import soliditycontract as ref_solidity
from mythril_tpu.support.config import MythrilConfig as RefConfig
from mythril_tpu_torch.core import MythrilDisassembler
from mythril_tpu_torch.ethereum.interface.client import EthJsonRpc, RpcError
from mythril_tpu_torch.ethereum.interface.local import LocalChain
from mythril_tpu_torch.interfaces import cli as port_cli
from mythril_tpu_torch.solidity import soliditycontract
from mythril_tpu_torch.support.config import MythrilConfig
from mythril_tpu_torch.support.loader import DynLoader
from mythril_tpu_torch.utils.keccak import keccak256

ADDRESS = "0x" + "4b" * 20


def _mock(base):
    class _MockRpc(base):
        def __init__(self, responses):
            super().__init__("mock", 1)
            self.responses = responses
            self.calls = []

        def _call(self, method, params):
            self.calls.append((method, params))
            response = self.responses[method]
            return response(params) if callable(response) else response

    return _MockRpc


PortMock, RefMock = _mock(EthJsonRpc), _mock(RefRpc)


@pytest.fixture
def no_proxy(monkeypatch):
    """The chain is on this host: no proxy named in the environment may
    carry a request to it (the JAX package's client honours them)."""
    for key in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY",
                "all_proxy", "ALL_PROXY"):
        monkeypatch.delenv(key, raising=False)


def test_rpc_client_methods_and_urls_match_the_reference():
    responses = {"eth_getCode": "0x6001",
                 "eth_getStorageAt": "0x" + "00" * 31 + "2a",
                 "eth_getBalance": "0x10"}
    port, ref = PortMock(responses), RefMock(responses)
    for rpc in (port, ref):
        assert rpc.eth_getCode("0xabc") == "0x6001"
        assert int(rpc.eth_getStorageAt("0xabc", 1), 16) == 42
        assert rpc.eth_getStorageAt("0xabc", "0x2") == responses[
            "eth_getStorageAt"]
        assert rpc.eth_getBalance("0xabc") == 16
    assert port.calls == ref.calls
    assert port.calls[1][1][1] == "0x1"  # an int position hex-encoded

    for rpc, tls in (("myhost:7777", False), (None, False), ("", True),
                     ("ganache", False), ("127.0.0.1", True)):
        assert EthJsonRpc.from_cli(rpc, tls).url == RefRpc.from_cli(
            rpc, tls).url
    assert EthJsonRpc("h", 1, tls=True).url == "https://h:1"
    infura = EthJsonRpc.from_cli("infura-mainnet", infura_id="k")
    assert infura.url == RefRpc.from_cli("infura-mainnet",
                                         infura_id="k").url
    assert infura.url == "https://mainnet.infura.io/v3/k"
    with pytest.raises(RpcError):
        EthJsonRpc.from_cli("infura-nonet")


def test_rpc_client_against_a_local_chain(no_proxy):
    storage = {0: 1, 5: 0xABC}
    chain = LocalChain({ADDRESS: {"code": "0x60016002", "storage": storage,
                               "balance": 77}})
    with chain:
        port = chain.port
        for client in (EthJsonRpc, RefRpc):
            rpc = client.from_cli(f"127.0.0.1:{chain.port}")
            assert rpc.eth_getCode(ADDRESS) == "0x60016002"
            assert int(rpc.eth_getStorageAt(ADDRESS, 5), 16) == 0xABC
            assert int(rpc.eth_getStorageAt(ADDRESS, 6), 16) == 0
            assert rpc.eth_getBalance(ADDRESS) == 77
            assert rpc.eth_getCode("0x" + "00" * 20) == "0x"
        assert dict(chain.requests) == {"eth_getCode": 4,
                                        "eth_getStorageAt": 4,
                                        "eth_getBalance": 2}
        with pytest.raises(RpcError):
            EthJsonRpc.from_cli(f"127.0.0.1:{chain.port}")._call(
                "eth_unknown", [])
    with pytest.raises(RpcError):  # the server is gone
        EthJsonRpc.from_cli(f"127.0.0.1:{port}").eth_getCode(ADDRESS)


def test_dynloader_caches_and_disassembles():
    rpc = PortMock({"eth_getCode": "0x60016002",
                    "eth_getStorageAt": "0x5",
                    "eth_getBalance": "0x10"})
    loader = DynLoader(rpc)
    code1 = loader.dynld("0x" + "11" * 20)
    code2 = loader.dynld("0x" + "11" * 20)
    assert code1 is code2  # cached: one RPC round trip
    assert len([c for c in rpc.calls if c[0] == "eth_getCode"]) == 1
    assert [i.opcode for i in code1.instruction_list][:2] == ["PUSH1",
                                                              "PUSH1"]
    assert loader.read_storage("0xabc", 0) == "0x5"
    assert loader.read_storage("0xabc", 0) == "0x5"
    assert len([c for c in rpc.calls if c[0] == "eth_getStorageAt"]) == 1
    assert loader.read_balance("0xabc") == 16

    assert DynLoader(rpc, active=False).dynld("0x" + "22" * 20) is None
    empty = PortMock({"eth_getCode": "0x"})
    assert DynLoader(empty).dynld("0x" + "33" * 20) is None
    with pytest.raises(ValueError):
        DynLoader(None).read_storage("0xabc", 1)


def test_config_tier_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("INFURA_ID", raising=False)
    monkeypatch.setenv("MYTHRIL_GPU_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "ref"))
    port, ref = MythrilConfig(), RefConfig()
    assert port.mythril_dir == str(tmp_path / "port")
    with open(port.config_path) as a, open(ref.config_path) as b:
        assert a.read() == b.read()
    assert (port.dynamic_loading, port.infura_id) == (
        ref.dynamic_loading, ref.infura_id) == ("infura", "")
    assert port.set_api_rpc("127.0.0.1:8545").url == "http://127.0.0.1:8545"
    assert port.set_api_rpc("off") is None and port.eth is None
    assert port.set_api_rpc().url == ref.set_api_rpc().url
    # the JAX package's variable never steers the port's directory
    monkeypatch.delenv("MYTHRIL_GPU_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert MythrilConfig.init_mythril_dir() == str(
        tmp_path / "home" / ".mythril_tpu_torch")


def _canned_build_info():
    return {
        "input": {
            "language": "Solidity",
            "sources": {"src/C.sol": {"content": "contract C {\n  }\n"}},
        },
        "output": {
            "contracts": {
                "src/C.sol": {
                    "C": {
                        "abi": [],
                        "evm": {
                            "bytecode": {"object": "600a600c600039600af300",
                                         "sourceMap": "0:14:0:-:0"},
                            "deployedBytecode": {
                                "object": "6001600201600055",
                                "sourceMap": "0:14:0:-:0;;16:1:0",
                            },
                        },
                    },
                    "IEmpty": {
                        "abi": [],
                        "evm": {
                            "bytecode": {"object": ""},
                            "deployedBytecode": {"object": ""},
                        },
                    },
                }
            },
            "sources": {"src/C.sol": {"id": 0}},
        },
    }


def test_load_from_foundry_matches_the_reference(tmp_path):
    build_dir = tmp_path / "out" / "build-info"
    build_dir.mkdir(parents=True)
    (build_dir / "abc123.json").write_text(json.dumps(_canned_build_info()))
    port = MythrilDisassembler().load_from_foundry(str(tmp_path),
                                                   run_forge=False)
    ref = RefDisassembler().load_from_foundry(str(tmp_path),
                                              run_forge=False)
    assert [c.name for c in port] == [c.name for c in ref] == ["C"]
    assert port[0].code == ref[0].code == "0x6001600201600055"
    assert port[0].creation_code == ref[0].creation_code
    assert port[0].source_text == ref[0].source_text
    for address in (0, 2, 4, 5, 99):
        mine, theirs = (c.get_source_info(address) for c in (port[0],
                                                              ref[0]))
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert (mine.filename, mine.code, mine.lineno,
                    mine.solc_mapping) == (theirs.filename, theirs.code,
                                           theirs.lineno, theirs.solc_mapping)
    with pytest.raises(ValueError):
        MythrilDisassembler().load_from_foundry(str(tmp_path / "nowhere"),
                                                run_forge=False)


def test_foundry_subcommand_analyzes_build_info(tmp_path, capsys):
    """`foundry --skip-forge-build` on the host backend: the same report as
    the JAX package's."""
    from mythril_tpu.support.args import args as ref_args
    from mythril_tpu.support.time_handler import time_handler as ref_time
    from mythril_tpu_torch.support.args import args as port_args

    build_dir = tmp_path / "out" / "build-info"
    build_dir.mkdir(parents=True)
    (build_dir / "b.json").write_text(json.dumps(_canned_build_info()))
    argv = ["foundry", "--project-root", str(tmp_path),
            "--skip-forge-build", "-t", "1", "-o", "json",
            "--solver-backend", "cpu"]
    outputs = []
    try:
        for cli in (ref_cli, port_cli):
            code = cli.execute_command(cli.build_parser().parse_args(argv))
            outputs.append((code, capsys.readouterr().out))
    finally:
        ref_args.reset()
        port_args.reset()
        ref_time.start_execution(None)
    assert outputs[0] == outputs[1]
    assert json.loads(outputs[1][1])["success"]
    with pytest.raises(port_cli.CliError):
        port_cli.execute_command(port_cli.build_parser().parse_args(
            ["foundry", "--project-root", str(tmp_path / "nowhere"),
             "--skip-forge-build"]))


STORAGE_FORMS = [["3"], ["1", "3"], ["2", "2", "array"], ["4", "1", "array"],
                 ["mapping", "0", "alice", "bob"], ["mapping", "7", "k"],
                 []]


@pytest.mark.parametrize("params", STORAGE_FORMS,
                         ids=lambda p: ",".join(p) or "none")
def test_read_storage_slot_math_matches_the_reference(params):
    def value(params):
        position = params[1]
        position = int(position, 16) if isinstance(position, str) \
            else position
        return "0x%064x" % (position % 997)

    port = MythrilDisassembler(eth=PortMock({"eth_getStorageAt": value}))
    ref = RefDisassembler(eth=RefMock({"eth_getStorageAt": value}))
    out = port.get_state_variable_from_storage("0xabc", params)
    assert out == ref.get_state_variable_from_storage("0xabc", params)
    assert port.eth.calls == ref.eth.calls


def test_read_storage_slot_math_by_hand():
    rpc = PortMock({"eth_getStorageAt": "0x2a"})
    disassembler = MythrilDisassembler(eth=rpc)
    assert disassembler.get_state_variable_from_storage(
        "0xabc", ["3"]) == "3: 0x2a"
    out = disassembler.get_state_variable_from_storage(
        "0xabc", ["2", "2", "array"])
    base = int.from_bytes(keccak256((2).to_bytes(32, "big")), "big")
    assert [line.split(":")[0] for line in out.splitlines()] == [
        hex(base), hex(base + 1)]
    for bad in (["mapping", "1"], ["not-a-number"], ["1", "2", "3", "4"]):
        with pytest.raises(ValueError):
            disassembler.get_state_variable_from_storage("0xabc", bad)
    with pytest.raises(ValueError):
        MythrilDisassembler().get_state_variable_from_storage("0xabc", ["1"])


@pytest.mark.parametrize("form", ["1", "1,2", "2,2,array",
                                  "mapping,3,alice,bob", "mapping,3,alice"])
def test_read_storage_cli_bytes_equal_the_reference(form, no_proxy, capsys):
    array = int.from_bytes(keccak256((2).to_bytes(32, "big")), "big")
    alice = int.from_bytes(keccak256(b"alice".ljust(32, b"\x00")
                                     + (3).to_bytes(32, "big")), "big")
    storage = {1: 0x2A, 2: 0x2B, array: 0x100, array + 1: 0x101,
               alice: 0xA11CE}
    with LocalChain({ADDRESS: {"storage": storage}}) as chain:
        argv = ["read-storage", form, ADDRESS, "--rpc",
                f"127.0.0.1:{chain.port}"]
        outputs = []
        for cli in (ref_cli, port_cli):
            code = cli.execute_command(cli.build_parser().parse_args(argv))
            outputs.append((code, capsys.readouterr().out))
    assert outputs[0] == outputs[1]
    assert outputs[1][0] == 0 and outputs[1][1].strip()


def test_load_from_address_reads_the_chain(no_proxy):
    with LocalChain({ADDRESS: {"code": "0x6001600201"}}) as chain:
        rpc = EthJsonRpc.from_cli(f"127.0.0.1:{chain.port}")
        contract = MythrilDisassembler(eth=rpc).load_from_address(ADDRESS)
        ref = RefDisassembler(eth=RefRpc.from_cli(
            f"127.0.0.1:{chain.port}")).load_from_address(ADDRESS)
    assert contract.name == ref.name == ADDRESS
    assert contract.get_easm() == ref.get_easm()
    with pytest.raises(ValueError):
        MythrilDisassembler().load_from_address(ADDRESS)


def test_solv_version_resolution(tmp_path, monkeypatch):
    fake = tmp_path / "solc-v0.8.26"
    fake.write_text("#!/bin/sh\n")
    monkeypatch.setenv("SOLC_DIR", str(tmp_path))
    for module in (soliditycontract, ref_solidity):
        assert module.find_solc_version("0.8.26") == str(fake)
        assert module.find_solc_version("v0.8.26") == str(fake)
        with pytest.raises(ImportError):
            module.find_solc_version("0.4.11")
    # the port's data directory's solc/ is searched too
    monkeypatch.delenv("SOLC_DIR")
    data = tmp_path / "data"
    (data / "solc").mkdir(parents=True)
    (data / "solc" / "solc-v0.7.6").write_text("#!/bin/sh\n")
    monkeypatch.setenv("MYTHRIL_GPU_DIR", str(data))
    assert soliditycontract.find_solc_version("0.7.6") == str(
        data / "solc" / "solc-v0.7.6")


@pytest.mark.parametrize("srcmap", ["0:100:0:-;;10:5;:8:1", "", "1:2:3:i:0",
                                    ";;;", "5:6:-1:-;7::;:9"])
def test_srcmap_decoding_matches_the_reference(srcmap):
    assert soliditycontract.decode_srcmap(srcmap) == \
        ref_solidity.decode_srcmap(srcmap)


@pytest.mark.parametrize("code", ["6060__$abc123$__6001",
                                  "__lib.sol:Lib_____________________6001",
                                  "6001", "60__unterminated"])
def test_library_placeholders_match_the_reference(code):
    stripped = soliditycontract._strip_placeholders(code)
    assert stripped == ref_solidity._strip_placeholders(code)
    assert "__" not in stripped


@pytest.mark.skipif(shutil.which("solc") is None, reason="solc not installed")
def test_solidity_contract_compiles(tmp_path):
    source = tmp_path / "simple.sol"
    source.write_text(
        "pragma solidity ^0.8.0;\n"
        "contract Simple { function f() public pure returns (uint) "
        "{ return 1; } }\n"
    )
    contracts = MythrilDisassembler().load_from_solidity([str(source)])
    ref = RefDisassembler().load_from_solidity([str(source)])
    assert [c.name for c in contracts] == [c.name for c in ref] == ["Simple"]
    assert contracts[0].code == ref[0].code


def test_rpc_failures_exit_2_with_a_message(no_proxy, capsys):
    """A chain that is gone, and a slot form the layout math refuses, end
    the port's CLI with a CliError (exit 2), not a traceback."""
    chain = LocalChain({ADDRESS: {"code": "0x6001"}})
    with chain:
        port = chain.port
    for argv in (["read-storage", "1", ADDRESS, "--rpc", f"127.0.0.1:{port}"],
                 ["disassemble", "-a", ADDRESS, "--rpc",
                  f"127.0.0.1:{port}"]):
        with pytest.raises(port_cli.CliError, match="rpc transport error"):
            port_cli.execute_command(port_cli.build_parser().parse_args(argv))
    with LocalChain({}) as chain:
        with pytest.raises(port_cli.CliError, match="invalid storage index"):
            port_cli.execute_command(port_cli.build_parser().parse_args(
                ["read-storage", "mapping,1", ADDRESS, "--rpc",
                 f"127.0.0.1:{chain.port}"]))
    assert capsys.readouterr().out == ""
