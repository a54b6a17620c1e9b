"""The port's engine foundations against the JAX package's: disassembly and
`easm_to_code`, keccak, the static pre-analysis of real bytecode, and
LaserEVM on the programs of tests/test_engine.py (the same states, CFG and
final stacks and storage)."""

import importlib
import os

import pytest

from mythril_tpu_torch.support.args import args as port_args
from tests.test_analysis import KILLBILLY, wrap_creation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("mythril_tpu", "mythril_tpu_torch")


def _mod(package, name):
    return importlib.import_module(f"{package}.{name}")


def _bench_hex(name):
    path = os.path.join(ROOT, "bench_inputs", name)
    with open(path) as handle:
        return handle.read().strip()


BENCH = ("stress_dispatch.hex", "corpus/xc_dispatch_a.hex",
         "corpus/xc_dispatch_b.hex", "corpus/xc_sender_a.hex",
         "corpus/xc_sender_b.hex")


@pytest.fixture(autouse=True)
def host_backend(monkeypatch):
    """Concretization queries of the engine runs settle on the host CDCL."""
    monkeypatch.setattr(port_args, "solver_backend", "cpu")


# -- disassembly ----------------------------------------------------------------

EASM = {
    "dispatcher": """
        PUSH1 0x00
        CALLDATALOAD
        PUSH1 0xe0
        SHR
        DUP1
        PUSH4 0x41c0e1b5
        EQ
        PUSH2 0x0020
        JUMPI
        STOP
    """,
    "jumpdest": """
        PUSH1 0x04
        JUMP
        STOP
        JUMPDEST
        STOP
    """,
    "labels": """
        PUSH1 0x00
        CALLDATALOAD
        PUSH1 @target
        JUMPI
        UNKNOWN_0xfc
    :target
        JUMPDEST
        PUSH32 0x8000000000000000000000000000000000000000000000000000000000000000
        PUSH0
        SSTORE
        STOP
    """,
}


def _code_cases():
    cases = {"roundtrip": "6001600201", "truncated_push": "61ff",
             "hex_string": "0x6001600101",
             "killbilly_creation": wrap_creation(KILLBILLY)}
    cases.update({f"easm_{name}": None for name in EASM})
    cases.update({name: _bench_hex(name) for name in BENCH})
    return cases


CODES = _code_cases()


def _disassembly_view(package, name):
    disasm = _mod(package, "disasm")
    asm = _mod(package, "disasm.asm")
    code = CODES[name]
    if code is None:
        code = asm.easm_to_code(EASM[name[len("easm_"):]])
    dis = disasm.Disassembly(code)
    instrs = [(i.address, i.opcode, i.argument)
              for i in dis.instruction_list]
    return {
        "code": bytes(dis.bytecode),
        "instrs": instrs,
        "jumpdests": sorted(dis.valid_jump_destinations),
        "entries": dict(dis.function_entries),
        "easm": dis.get_easm(),
        "reassembled": asm.easm_to_code(asm.instrs_to_easm(
            disasm.disassemble(bytes(dis.bytecode)))),
        "stripped": asm.strip_metadata(bytes(dis.bytecode)),
    }


@pytest.mark.parametrize("name", sorted(CODES))
def test_disassembly_equal(name):
    reference = _disassembly_view("mythril_tpu", name)
    port = _disassembly_view("mythril_tpu_torch", name)
    assert len(port["instrs"]) == len(reference["instrs"]) > 0
    for index, (got, want) in enumerate(zip(port["instrs"],
                                            reference["instrs"])):
        assert got == want, index
    assert port == reference


def test_strip_metadata_equal():
    runtime = bytes.fromhex("6001600101")
    cbor = bytes.fromhex("a264697066735822") + b"\x00" * 40
    trailer = cbor + len(cbor).to_bytes(2, "big")
    for code in (runtime + trailer, runtime):
        stripped = [_mod(p, "disasm.asm").strip_metadata(code)
                    for p in PACKAGES]
        assert stripped[0] == stripped[1] == runtime


# -- keccak -------------------------------------------------------------------

KECCAK_INPUTS = [b"", b"abc", b"q" * 200, b"q" * 201] + [
    b"z" * n for n in (134, 135, 136, 137)]


@pytest.mark.parametrize("data", KECCAK_INPUTS,
                         ids=lambda d: f"{len(d)}B")
def test_keccak_vectors(data):
    digests = [_mod(p, "utils.keccak").keccak256(data) for p in PACKAGES]
    assert digests[0] == digests[1]
    if data == b"":
        assert digests[1].hex() == ("c5d2460186f7233c927e7db2dcc703c0e500b6"
                                    "53ca82273b7bfad8045d85a470")
    if data == b"abc":
        assert digests[1].hex() == ("4e03657aea45a94fc7d47ba826c8d667c0d1e6"
                                    "e33a64a036ec44f58fa12d6c45")


def test_selectors_and_int_hashing():
    for package in PACKAGES:
        keccak = _mod(package, "utils.keccak")
        assert keccak.function_selector(
            "transfer(address,uint256)").hex() == "a9059cbb"
        assert keccak.function_selector("kill()").hex() == "41c0e1b5"
        assert keccak.keccak256_int(0) == int.from_bytes(
            keccak.keccak256(b"\x00" * 32), "big")


# -- static pre-analysis ------------------------------------------------------


def _summary_view(package, code_hex):
    preanalysis = _mod(package, "preanalysis")
    evmcontract = _mod(package, "ethereum.evmcontract")
    contract = evmcontract.EVMContract(code=code_hex, name="MAIN")
    summary = preanalysis.get_code_summary(contract.disassembly)
    cfg = summary.cfg
    blocks = {start: (block.end, list(block.successors), block.unresolved,
                      block.halts)
              for start, block in cfg.blocks.items()}
    return {
        "linear": sorted(summary.linear_opcodes),
        "resolved": summary.resolved,
        "reachable": sorted(summary.reachable_opcodes),
        "reachable_starts": sorted(cfg.reachable_starts),
        "blocks": blocks,
        "cones": {start: sorted(summary.cone_opcodes(start) or ["<none>"])
                  for start in cfg.blocks},
        "functions": {
            selector: (fx.entry_pc, sorted(fx.effects),
                       sorted(fx.env_reads), fx.bounded)
            for selector, fx in summary.function_effects.items()},
        "gating": (None if preanalysis.gating_opcodes(contract) is None
                   else sorted(preanalysis.gating_opcodes(contract))),
    }


@pytest.mark.parametrize("name", BENCH)
def test_code_summary_equal(name):
    code = _bench_hex(name)
    reference = _summary_view("mythril_tpu", code)
    port = _summary_view("mythril_tpu_torch", code)
    assert port["functions"], "the dispatcher's functions were found"
    assert port == reference


def test_detector_interesting_opcodes_equal():
    sets = [_mod(p, "preanalysis")._detector_interesting_opcodes()
            for p in PACKAGES]
    assert sets[0] == sets[1]
    assert {"SSTORE", "CALL", "SELFDESTRUCT"} <= sets[1]


# -- LaserEVM on the test_engine.py programs ---------------------------------

CONTRACT_ADDR = 0x1234
CALLER_ADDR = 0xCAFE
CALLEE_ADDR = 0xB0B0

_CALL_B = """
    PUSH1 0x00
    PUSH1 0x00
    PUSH1 0x00
    PUSH1 0x00
    PUSH1 0x00
    PUSH2 0xb0b0
    PUSH2 0xffff
    CALL
    PUSH1 0x02
    SSTORE
    STOP
"""

# name -> (runtime EASM, run options); calldata None = a symbolic call
PROGRAMS = {
    "arithmetic": ("""
        PUSH1 0x03
        PUSH1 0x07
        ADD
        PUSH1 0x06
        MUL
        PUSH1 0x04
        SWAP1
        SUB
        PUSH1 0x02
        SWAP1
        DIV
        PUSH1 0x00
        SSTORE
        STOP
    """, {}),
    "signed": ("""
        PUSH1 0x02
        PUSH32 0xfffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff8
        SDIV
        PUSH1 0x00
        SSTORE
        STOP
    """, {}),
    "mulmod": ("""
        PUSH1 0x07
        PUSH1 0x04
        PUSH32 0x8000000000000000000000000000000000000000000000000000000000000000
        MULMOD
        PUSH1 0x00
        SSTORE
        STOP
    """, {}),
    "memory": ("""
        PUSH32 0xdeadbeefcafebabe112233445566778899aabbccddeeff001122334455667788
        PUSH1 0x40
        MSTORE
        PUSH1 0x40
        MLOAD
        PUSH1 0x01
        SSTORE
        STOP
    """, {}),
    "calldataload": ("""
        PUSH1 0x04
        CALLDATALOAD
        PUSH1 0x00
        SSTORE
        CALLDATASIZE
        PUSH1 0x01
        SSTORE
        STOP
    """, {"calldata": bytes.fromhex("a9059cbb") + (42).to_bytes(32, "big")}),
    "sha3": ("""
        PUSH1 0x2a
        PUSH1 0x00
        MSTORE
        PUSH1 0x20
        PUSH1 0x00
        SHA3
        PUSH1 0x00
        SSTORE
        STOP
    """, {}),
    "caller_and_value": ("""
        CALLER
        PUSH1 0x00
        SSTORE
        CALLVALUE
        PUSH1 0x01
        SSTORE
        STOP
    """, {"value": 7}),
    "storage_prestate_and_jump": ("""
        PUSH1 0x05
        SLOAD
        PUSH1 0x08
        JUMP
        STOP
        UNKNOWN_0xfc
        JUMPDEST
        PUSH1 0x01
        ADD
        PUSH1 0x05
        SSTORE
        STOP
    """, {"storage": {5: 99}}),
    "revert": ("""
        PUSH1 0x00
        PUSH1 0x00
        REVERT
    """, {}),
    "shift": ("""
        PUSH1 0xff
        PUSH1 0x04
        SHL
        PUSH1 0x00
        SSTORE
        PUSH1 0xf0
        PUSH1 0x04
        SHR
        PUSH1 0x01
        SSTORE
        STOP
    """, {}),
    "transient": ("""
        PUSH1 0x2a
        PUSH1 0x07
        TSTORE
        PUSH1 0x07
        TLOAD
        PUSH1 0x00
        SSTORE
        STOP
    """, {}),
    "nested_call_revert": ("""
        PUSH1 0x11
        PUSH1 0x01
        SSTORE
        PUSH1 0x00
    """ + _CALL_B, {"callee": """
        PUSH1 0x63
        PUSH1 0x00
        SSTORE
        PUSH1 0x00
        PUSH1 0x00
        REVERT
    """}),
    "nested_call_success": (_CALL_B, {"callee": """
        PUSH1 0x63
        PUSH1 0x00
        SSTORE
        STOP
    """}),
    "symbolic_fork": ("""
        PUSH1 0x00
        CALLDATALOAD
        PUSH1 0x08
        JUMPI
        STOP
        UNKNOWN_0xfc
        JUMPDEST
        PUSH1 0x01
        PUSH1 0x00
        SSTORE
        STOP
    """, {"calldata": None}),
    "selfdestruct": ("""
        CALLER
        SELFDESTRUCT
    """, {"balances": {CONTRACT_ADDR: 1000, CALLER_ADDR: 0}}),
    "precompiles": ("""
        PUSH1 0xaa
        PUSH1 0x00
        MSTORE8
        PUSH1 0xbb
        PUSH1 0x01
        MSTORE8
        PUSH1 0x02
        PUSH1 0x20
        PUSH1 0x02
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x04
        PUSH2 0xffff
        CALL
        POP
        PUSH1 0x20
        MLOAD
        PUSH1 0x00
        SSTORE
        PUSH1 0x20
        PUSH1 0x40
        PUSH1 0x02
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x02
        PUSH2 0xffff
        CALL
        POP
        PUSH1 0x40
        MLOAD
        PUSH1 0x01
        SSTORE
        STOP
    """, {}),
}


def _word(value):
    return value.concrete_value if not value.symbolic else str(value)


def _explore(package, name):
    """One message call of PROGRAMS[name] on `package`'s LaserEVM, from a
    fresh world state: concrete calldata as the concolic setup of
    test_engine.py seeds it (no actor constraint), or a symbolic call."""
    Disassembly = _mod(package, "disasm").Disassembly
    easm_to_code = _mod(package, "disasm.asm").easm_to_code
    smt = _mod(package, "smt")
    WorldState = _mod(package, "laser.state.world_state").WorldState
    LaserEVM = _mod(package, "laser.svm").LaserEVM
    models = _mod(package, "laser.transaction.models")
    symbolic = _mod(package, "laser.transaction.symbolic")
    calldata_mod = _mod(package, "laser.state.calldata")
    _mod(package, "support.model").clear_caches()
    # both packages number this run's transactions from the same start
    models.tx_id_manager.restart_counter()
    val = smt.symbol_factory.BitVecVal

    easm, options = PROGRAMS[name]
    world = WorldState()
    account = world.create_account(address=CONTRACT_ADDR,
                                   concrete_storage=True,
                                   code=Disassembly(easm_to_code(easm)))
    for slot, value in options.get("storage", {}).items():
        account.storage[val(slot, 256)] = value
    if "callee" in options:
        world.create_account(address=CALLEE_ADDR, concrete_storage=True,
                             code=Disassembly(easm_to_code(
                                 options["callee"])))
    for address, balance in options.get("balances", {}).items():
        world.balances[val(address, 256)] = val(balance, 256)
    laser = LaserEVM(transaction_count=1, execution_timeout=60,
                     requires_statespace=False)
    address = val(CONTRACT_ADDR, 256)
    calldata = options.get("calldata", b"")
    if calldata is None:
        transaction = symbolic.build_message_call_transaction(world, address)
        symbolic._setup_global_state_for_execution(laser, transaction)
    else:
        caller = val(CALLER_ADDR, 256)
        transaction = models.MessageCallTransaction(
            world_state=world, callee_account=account, caller=caller,
            call_data=calldata_mod.BasicConcreteCalldata(
                "concrete", list(calldata)),
            gas_price=val(10, 256), gas_limit=8_000_000, origin=caller,
            code=account.code, call_value=val(options.get("value", 0), 256))
        state = transaction.initial_global_state()
        state.transaction_stack.append((transaction, None))
        state.world_state.transaction_sequence.append(transaction)
        state.node = laser.new_node(transaction,
                                    state.world_state.constraints)
        laser.work_list.append(state)
    final_states = laser.exec(track_gas=True)
    order = {uid: index for index, uid in enumerate(sorted(laser.nodes))}
    return {
        "total_states": laser.total_states,
        "nodes": [(order[uid], node.start_addr, node.function_name)
                  for uid, node in sorted(laser.nodes.items())],
        "edges": [(order[e.node_from], order[e.node_to],
                   str(e.type).rsplit(".", 1)[-1]) for e in laser.edges],
        "final_stacks": [[_word(v) for v in state.mstate.stack]
                         for state in final_states],
        "open_states": [
            {address: ({slot if isinstance(slot, int) else str(slot):
                        _word(value)
                        for slot, value in
                        acct.storage.printable_storage.items()},
                       bool(acct.deleted))
             for address, acct in sorted(world_state.accounts.items())}
            for world_state in laser.open_states],
    }


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_laser_runs_equal(name):
    reference = _explore("mythril_tpu", name)
    port = _explore("mythril_tpu_torch", name)
    assert port == reference
    if name == "arithmetic":
        assert port["open_states"][0][CONTRACT_ADDR][0] == {0: 28}
    if name == "symbolic_fork":
        assert len(port["open_states"]) == 2
    if name == "revert":
        assert port["open_states"] == []
