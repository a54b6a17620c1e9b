"""The port's dense frontier encode/decode round trips
(mythril_tpu_torch/laser/frontier/dense.py) plus the 256-bit limb-packing
edge cases in frontier/words.py: the cases of the JAX package's
tests/test_frontier_dense.py."""

import random

import numpy as np
import pytest

from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.disasm.asm import easm_to_code
from mythril_tpu_torch.laser.frontier import dense, fastset, kernel, words
from mythril_tpu_torch.laser.state.machine_state import STACK_LIMIT
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.laser.transaction.models import MessageCallTransaction
from mythril_tpu_torch import preanalysis
from mythril_tpu_torch.smt import symbol_factory

from tests.torch_helpers import with_dead_rows


def bv(value, size=256):
    return symbol_factory.BitVecVal(value, size)


def make_state(code_bytes=None, stack_ints=(), mem_bytes=None):
    code = Disassembly(code_bytes or easm_to_code("PUSH1 0x01\nPOP\nSTOP"))
    world_state = WorldState()
    account = world_state.create_account(
        address=0x1234, concrete_storage=True, code=code)
    tx = MessageCallTransaction(world_state=world_state,
                                callee_account=account)
    global_state = tx.initial_global_state()
    global_state.transaction_stack = [(tx, None)]
    for value in stack_ints:
        global_state.mstate.stack.append(bv(value))
    if mem_bytes:
        for index, byte in enumerate(mem_bytes):
            global_state.mstate.memory.write_byte(index, byte)
        global_state.mstate.memory.extend_to(0, len(mem_bytes))
    return global_state


def identity_run(touch: int, window_ops: bool = False) -> fastset.Run:
    """A synthetic Run shape for pure encode/decode testing: touch == out
    (decode writes back what encode read)."""
    return fastset.Run(
        ops=[], start_pc=0, end_pc=0, touch=touch, out_len=touch,
        max_height=0, has_mem=window_ops, has_mload=window_ops,
        first_instr=None, key=0)


# -- limb packing ------------------------------------------------------------


def test_limb_packing_roundtrip_edges():
    for value in (0, 1, 255, 256, (1 << 256) - 1, 1 << 255,
                  0xDEADBEEF << 128):
        limbs = words.word_from_int(value)
        assert len(limbs) == 32
        assert all(0 <= limb <= 255 for limb in limbs)
        assert words.int_from_limbs(limbs) == value
    # big-endian: MSB in limb 0
    assert words.word_from_int(1 << 255)[0] == 0x80
    assert words.word_from_int(1)[31] == 1


def test_limb_packing_random_roundtrip():
    rng = random.Random(7)
    for _ in range(200):
        value = rng.getrandbits(256)
        assert words.int_from_limbs(words.word_from_int(value)) == value


# -- stack window round-trip -------------------------------------------------


def test_encode_decode_stack_roundtrip_random():
    rng = random.Random(11)
    for _ in range(50):
        depth = rng.randrange(0, 24)
        touch = rng.randrange(0, depth + 1)
        values = [rng.getrandbits(256) for _ in range(depth)]
        state = make_state(stack_ints=values)
        run = identity_run(touch)
        assert dense.state_encodable(state, run)
        frame = dense.encode_frontier([state], run)
        # identity decode: same window written back
        dense.decode_state(state, run, frame.stack, frame.mem,
                           frame.mem_written, frame.msize, frame.min_gas,
                           frame.max_gas, 0)
        decoded = [entry.concrete_value for entry in state.mstate.stack]
        assert decoded == values
        assert int(frame.depth[0]) == depth


def test_encode_decode_empty_stack():
    state = make_state(stack_ints=[])
    run = identity_run(0)
    assert dense.state_encodable(state, run)
    frame = dense.encode_frontier([state], run)
    assert frame.stack.shape == (1, 0, 32)
    dense.decode_state(state, run, frame.stack, frame.mem,
                       frame.mem_written, frame.msize, frame.min_gas,
                       frame.max_gas, 0)
    assert list(state.mstate.stack) == []


def test_encode_near_stack_limit_depth():
    values = [i for i in range(STACK_LIMIT - 1)]
    state = make_state(stack_ints=values)
    run = identity_run(16)
    assert dense.state_encodable(state, run)
    frame = dense.encode_frontier([state], run)
    window = [words.int_from_limbs(frame.stack[0, j]) for j in range(16)]
    assert window == values[-16:]
    dense.decode_state(state, run, frame.stack, frame.mem,
                       frame.mem_written, frame.msize, frame.min_gas,
                       frame.max_gas, 0)
    assert [e.concrete_value for e in state.mstate.stack] == values


def test_encode_rejects_symbolic_and_tainted_windows():
    state = make_state(stack_ints=[1, 2, 3])
    state.mstate.stack.append(
        symbol_factory.BitVecSym("free_input", 256))
    assert not dense.state_encodable(state, identity_run(1))
    # below the touched window a symbol is fine
    assert dense.state_encodable(state, identity_run(0))
    tainted = bv(42)
    tainted.annotate("taint-marker")
    state2 = make_state(stack_ints=[5])
    state2.mstate.stack.append(tainted)
    assert not dense.state_encodable(state2, identity_run(1))


def test_encode_rejects_underflow_and_overflow():
    state = make_state(stack_ints=[1])
    assert not dense.state_encodable(state, identity_run(2))
    deep = make_state(stack_ints=list(range(STACK_LIMIT - 1)))
    run = fastset.Run(ops=[], start_pc=0, end_pc=0, touch=0, out_len=0,
                      max_height=4, has_mem=False, has_mload=False,
                      first_instr=None, key=0)
    assert not dense.state_encodable(deep, run)


# -- memory window round-trip ------------------------------------------------


def test_encode_decode_partial_memory_window():
    rng = random.Random(13)
    payload = bytes(rng.randrange(256) for _ in range(100))
    state = make_state(mem_bytes=payload)
    run = identity_run(0, window_ops=True)
    assert dense.state_encodable(state, run)
    frame = dense.encode_frontier([state], run)
    window = frame.mem[0]
    assert bytes(int(b) for b in window[:100]) == payload
    assert not window[100:].any(), "window beyond msize must be zero"
    assert int(frame.msize[0]) == state.mstate.memory.size
    # write-back of a few bytes through the mask
    frame.mem[0, 3] = 0xAB
    frame.mem_written[0, 3] = True
    before = state.mstate.memory.size
    dense.decode_state(state, run, frame.stack, frame.mem,
                       frame.mem_written, frame.msize, frame.min_gas,
                       frame.max_gas, 0)
    assert state.mstate.memory.get_byte(3).concrete_value == 0xAB
    assert state.mstate.memory.get_byte(4).concrete_value == payload[4]
    assert state.mstate.memory.size == before


def test_memory_dense_window_soundness_gates():
    state = make_state()
    memory = state.mstate.memory
    memory.write_byte(0, 0x11)
    assert memory.dense_window(64)[0] == 0x11
    # symbolic VALUE inside the window poisons reads
    memory.write_byte(1, symbol_factory.BitVecSym("mystery_byte", 8))
    assert memory.dense_window(64) is None
    # ... unless it sits beyond the window
    memory2 = make_state().mstate.memory
    memory2.write_byte(100, symbol_factory.BitVecSym("far_byte", 8))
    assert memory2.dense_window(64) is not None
    # a concrete overwrite heals the byte
    memory.write_byte(1, 0x22)
    assert memory.dense_window(64)[1] == 0x22
    # symbolic INDEX poisons the whole memory permanently
    memory.write_byte(symbol_factory.BitVecSym("sym_index", 256), 0x33)
    assert memory.dense_window(64) is None


def test_memory_shadow_survives_clone():
    state = make_state(mem_bytes=b"\x01\x02\x03")
    clone = state.clone()
    assert clone.mstate.memory.dense_window(32)[:3] == bytearray(
        b"\x01\x02\x03")
    clone.mstate.memory.write_byte(0, 0xFF)
    # copy-on-clone: the original's shadow is untouched
    assert state.mstate.memory.dense_window(32)[0] == 0x01


# -- batch padding -----------------------------------------------------------


def test_encode_padding_rides_live_mask():
    """Encode makes one live row a state and never pads; dead rows put
    behind them ride the live mask through the step and never report
    ok."""
    states = [make_state(stack_ints=[i + 1]) for i in range(3)]
    run = identity_run(1)
    encoded = dense.encode_frontier(states, run)
    assert encoded.batch == 3
    assert list(encoded.live) == [True] * 3
    frame = with_dead_rows(encoded, 8)
    assert frame.batch == 8
    assert list(frame.live) == [True] * 3 + [False] * 5
    assert words.int_from_limbs(frame.stack[2, 0]) == 3
    assert not frame.stack[3:].any()
    ok = kernel.step_batch(run, frame, backend="numpy")[6]
    assert list(ok) == [True] * 3 + [False] * 5


def test_run_extraction_shapes_match_encode():
    """extract_run's static stack shape must agree with what encode and
    the kernel assume (touch/out_len/capacity arithmetic)."""
    code = easm_to_code("""
        PUSH1 0x05
        ADD
        DUP2
        MUL
        SWAP1
        POP
        STOP
    """)
    state = make_state(code_bytes=code, stack_ints=[9, 7])
    summary = preanalysis.get_code_summary(state.environment.code)
    run = fastset.extract_run(summary, 0, lambda name: False,
                              lambda name: False)
    assert run is not None
    # ADD reaches 1 below start top; DUP2 reaches 2 below the running
    # height; net effect: [a, b] -> [b, (b + 5) * a] pops one
    assert run.touch == 2
    assert run.out_len == 1
    assert dense.state_encodable(state, run)
