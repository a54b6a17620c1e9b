"""The port's batched frontier (mythril_tpu_torch/laser/frontier/), held to
the port's own per-state interpreter: the cases of the JAX package's
tests/test_frontier.py.

The core evidence is the differential property test: random straight-line
programs over the fast set, stepped (a) by the per-state interpreter in
laser/instructions.py — the ground-truth oracle — and (b) through the full
encode -> step -> decode path, must agree on the stack, memory bytes,
msize, pc, and both gas bounds, bit for bit. 300 runs go through the numpy
step; the torch step (K6's plain version) takes multi-row batches with
dead rows behind the live ones
until every opcode of the generator has appeared in at least 10 runs (311
programs at this seed). On top: engine integration (sibling batching,
bail-and-replay, hook gating, loop vetting), the flag/env gating matrix,
and findings parity through a full analyze, frontier on against off.
"""

import json
import random

import pytest
import torch

from mythril_tpu_torch import preanalysis
from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.laser import instructions
from mythril_tpu_torch.laser.frontier import dense, fastset, kernel
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.laser.transaction.models import MessageCallTransaction
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.workloads import frontier_program, push_bytes

from tests.torch_helpers import (
    issue_keys,
    run_analyze,
    snapshot_input,
    with_dead_rows,
)

random_program = frontier_program
_push = push_bytes


@pytest.fixture(autouse=True)
def _legacy_frontier_dialect(monkeypatch):
    """Pin the dialect without the symbolic lane (concrete lanes only, no
    RETURN/STOP promotion, no cross-fork re-batching) and the host step:
    the lane has its own suite (tests/test_torch_frontier_symlane.py), and
    with no card the default step backend would raise."""
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_MULTIPC", "0")
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_BACKEND", "numpy")


def bv(value, size=256):
    return symbol_factory.BitVecVal(value, size)


def make_state(code_bytes, stack_ints=(), mem_bytes=b""):
    code = Disassembly(code_bytes)
    world_state = WorldState()
    account = world_state.create_account(
        address=0x1234, concrete_storage=True, code=code)
    tx = MessageCallTransaction(world_state=world_state,
                                callee_account=account)
    global_state = tx.initial_global_state()
    global_state.transaction_stack = [(tx, None)]
    for value in stack_ints:
        global_state.mstate.stack.append(bv(value))
    for index, byte in enumerate(mem_bytes):
        global_state.mstate.memory.write_byte(index, byte)
    if mem_bytes:
        global_state.mstate.memory.extend_to(0, len(mem_bytes))
    return global_state


def reference_step(global_state, end_pc):
    """Per-state oracle: run instructions.execute to end_pc."""
    state = global_state
    while state.mstate.pc < end_pc:
        successors = instructions.execute(state, state.instruction)
        assert len(successors) == 1
        state = successors[0]
    return state


def assert_states_match(oracle, candidate, window=fastset.MEM_WINDOW):
    assert candidate.mstate.pc == oracle.mstate.pc
    oracle_stack = [e.concrete_value for e in oracle.mstate.stack]
    cand_stack = [e.concrete_value for e in candidate.mstate.stack]
    assert cand_stack == oracle_stack
    assert candidate.mstate.memory.size == oracle.mstate.memory.size
    assert candidate.mstate.min_gas_used == oracle.mstate.min_gas_used
    assert candidate.mstate.max_gas_used == oracle.mstate.max_gas_used
    assert (candidate.mstate.memory.dense_window(window)
            == oracle.mstate.memory.dense_window(window))


def _run_for(code, allow_empty=False):
    summary = preanalysis.get_code_summary(code)
    run = fastset.extract_run(summary, 0, lambda name: False,
                              lambda name: False)
    if run is None and not allow_empty:
        pytest.skip("generator produced a sub-minimal run")
    return run


def op_family(name: str) -> str:
    """PUSH1..PUSH32 -> PUSH, DUPn -> DUP, SWAPn -> SWAP, else the name."""
    for family in ("PUSH", "DUP", "SWAP"):
        if name.startswith(family):
            return family
    return name


# every opcode the generator emits, by family
GENERATED_FAMILIES = frozenset(
    ["PUSH", "DUP", "SWAP", "POP", "ISZERO", "NOT", "PC", "MSIZE",
     "JUMPDEST", "MSTORE", "MSTORE8", "MLOAD", "ADD", "MUL", "SUB",
     "SIGNEXTEND", "DIV", "SDIV", "MOD", "SMOD", "LT", "GT", "SLT", "SGT",
     "EQ", "AND", "OR", "XOR", "BYTE", "SHL", "SHR", "SAR"])


# -- the differential property tests -------------------------------------------


def test_differential_random_runs_numpy():
    """300 random straight-line runs: batched numpy step == per-state
    interpreter on stacks, memory, pc and gas."""
    rng = random.Random(0xF50)
    checked = 0
    while checked < 300:
        code, init_stack = random_program(rng)
        mem_seed = bytes(rng.randrange(256)
                         for _ in range(rng.choice((0, 0, 17, 64))))
        state = make_state(code, init_stack, mem_seed)
        run = _run_for(state.environment.code, allow_empty=True)
        if run is None:
            continue
        if not dense.state_encodable(state, run):
            continue
        oracle = reference_step(state.clone(), run.end_pc)
        frame = dense.encode_frontier([state], run)
        stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log, _fork \
            = kernel.step_batch(run, frame, backend="numpy")
        assert ok[0], f"unexpected bail: {run.op_names}"
        dense.decode_state(state, run, stack_out, mem, written, msize,
                           min_gas, max_gas, 0, mem_log=mem_log)
        assert_states_match(oracle, state)
        checked += 1


def test_differential_random_runs_torch_batches():
    """The torch step (K6's plain version) over multi-state padded batches
    agrees with the oracle for every live row, until every opcode family
    of the generator has been in at least 10 runs (311 programs at this
    seed); padding rows never report ok."""
    rng = random.Random(0xBF11)
    seen = {family: 0 for family in GENERATED_FAMILIES}
    checked = 0
    while min(seen.values()) < 10:
        assert checked < 400, f"coverage not reached: {seen}"
        code, init_stack = random_program(rng)
        state = make_state(code, init_stack)
        run = _run_for(state.environment.code, allow_empty=True)
        if run is None or not dense.state_encodable(state, run):
            continue
        siblings = [state]
        for _ in range(rng.randrange(1, 5)):
            sibling = make_state(
                code, [rng.getrandbits(256) for _ in init_stack])
            if dense.state_encodable(sibling, run):
                siblings.append(sibling)
        oracles = [reference_step(s.clone(), run.end_pc) for s in siblings]
        frame = with_dead_rows(dense.encode_frontier(siblings, run),
                               len(siblings) + 2)
        stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log, _fork \
            = kernel.step_batch(run, frame, backend="torch",
                                device=torch.device("cpu"))
        for i, (sibling, oracle) in enumerate(zip(siblings, oracles)):
            assert ok[i]
            dense.decode_state(sibling, run, stack_out, mem, written,
                               msize, min_gas, max_gas, i, mem_log=mem_log)
            assert_states_match(oracle, sibling)
        assert not ok[len(siblings):].any()
        for family in {op_family(name) for name in run.op_names}:
            seen[family] += 1
        checked += 1
    assert checked == 311


def test_huge_memory_offsets_exit_the_batch():
    """A state whose MSTORE/MLOAD offset leaves the dense window must
    bail (ok=False) rather than produce wrong memory."""
    rng = random.Random(0xD15C)
    bails = 0
    trials = 0
    while bails < 10 and trials < 400:
        trials += 1
        code, init_stack = random_program(rng, allow_huge_offsets=True)
        state = make_state(code, init_stack)
        run = _run_for(state.environment.code, allow_empty=True)
        if run is None or not run.has_mem:
            continue
        if not dense.state_encodable(state, run):
            continue
        frame = dense.encode_frontier([state], run)
        stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log, _fork \
            = kernel.step_batch(run, frame, backend="numpy")
        if ok[0]:
            # completed in-window: must still match the oracle
            oracle = reference_step(state.clone(), run.end_pc)
            dense.decode_state(state, run, stack_out, mem, written,
                               msize, min_gas, max_gas, 0, mem_log=mem_log)
            assert_states_match(oracle, state)
        else:
            bails += 1
            # the bailed state was never touched
            assert state.mstate.pc == 0
    assert bails >= 10, "generator never produced an out-of-window access"


def test_symbolic_passthrough_slots_keep_object_identity():
    """A run that only SHUFFLES a symbolic/tainted value batches anyway;
    decode leaves the ORIGINAL BitVec object where the interpreter's
    shuffles would have left it."""
    # over [sym]: PUSH1 7, PUSH1 5, ADD -> [sym, 12]; SWAP1 -> [12, sym].
    # The ADD consumes only pushed constants; sym is merely shuffled.
    code = b"\x60\x07\x60\x05\x01\x90\x00"
    sym = symbol_factory.BitVecSym("opaque_rider", 256)
    sym.annotate("taint")
    state = make_state(code, [])
    state.mstate.stack.append(sym)
    run = _run_for(state.environment.code)
    assert run.touch == 1
    assert run.consumed_windows == frozenset()
    assert run.out_sources == (-1, 0)
    assert dense.state_encodable(state, run)
    frame = dense.encode_frontier([state], run)
    stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log, _fork \
        = kernel.step_batch(run, frame, backend="numpy")
    assert ok[0]
    dense.decode_state(state, run, stack_out, mem, written, msize,
                       min_gas, max_gas, 0, mem_log=mem_log)
    assert state.mstate.stack[-2].concrete_value == 12
    assert state.mstate.stack[-1] is sym  # object identity preserved


def test_consumed_symbolic_slot_still_blocks_encoding():
    # [sym] PUSH1 5, ADD consumes the symbolic entry -> not encodable
    code = b"\x60\x05\x01\x60\x00\x50\x00"  # PUSH ADD PUSH POP STOP
    state = make_state(code, [])
    state.mstate.stack.append(symbol_factory.BitVecSym("consumed", 256))
    run = _run_for(state.environment.code)
    assert 0 in run.consumed_windows
    assert not dense.state_encodable(state, run)


# -- engine integration ------------------------------------------------------


def _engine_with_frontier(code_bytes, n_siblings, stack_ints):
    from mythril_tpu_torch.laser.svm import LaserEVM

    svm = LaserEVM(requires_statespace=False, vmap_frontier=True)
    states = [make_state(code_bytes, stack_ints) for _ in range(n_siblings)]
    svm.work_list.extend(states)
    return svm, states


def test_stepper_batches_siblings_and_counts():
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    code, init_stack = (
        b"\x60\x05\x60\x07\x01\x60\x00\x52\x60\x00\x51\x02\x00",
        [3],
    )  # PUSH 5, PUSH 7, ADD, PUSH 0, MSTORE, PUSH 0, MLOAD, MUL, STOP
    svm, states = _engine_with_frontier(code, 5, init_stack)
    from mythril_tpu_torch.laser.frontier import FrontierStepper

    stepper = FrontierStepper(svm)
    lead = svm.work_list.pop(0)
    results = stepper.try_step(lead)
    assert results is not None and len(results) == 5
    assert svm.work_list == []  # all siblings were pulled into the batch
    run = stepper._run_for(lead.environment.code, 0)
    for state in results:
        assert state.mstate.pc == run.end_pc
        # [3] -> PUSH 5, PUSH 7, ADD=12, MSTORE@0, MLOAD@0, MUL with the
        # initial 3 -> [36]
        assert [e.concrete_value for e in state.mstate.stack] == [36]
    assert stats.frontier_vmap_steps == 1
    assert stats.frontier_states_stepped == 5
    # with the symbolic lane pinned OFF, completed rows of a run that
    # cuts at the STOP leave the batch dialect: counted as dialect
    # exits, not as mid-run bails
    assert stats.frontier_fallback_exits == 5
    assert stats.frontier_fallback_dialect == 5
    assert stats.frontier_batch_bails == 0
    assert stats.frontier_batch_slots == 5
    assert stats.frontier_batch_occupancy == 1.0


def test_stepper_bail_flag_forces_per_state_replay():
    """A state that exits the batch replays per-state at the same pc
    (skip flag) instead of re-entering a batch loop."""
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    # MSTORE at a pushed offset far beyond the dense window
    code = _push(1 << 200) + b"\x52" + b"\x60\x01\x60\x02\x01\x00"
    state = make_state(code, [0xAA])
    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    from mythril_tpu_torch.laser.frontier import FrontierStepper

    stepper = FrontierStepper(svm)
    results = stepper.try_step(state)
    assert results == [state]
    run = stepper._run_for(state.environment.code, 0)
    assert state._frontier_skip_span == (0, run.end_pc)
    assert state.mstate.pc == 0  # untouched
    assert stats.frontier_fallback_exits == 1
    # the stepper stands aside across the WHOLE bailed run span, not
    # just the start pc — the per-state interpreter replays it
    assert stepper.try_step(state) is None
    state.mstate.pc = run.op_pcs[1]
    assert stepper.try_step(state) is None


def test_stepper_respects_interior_hooks():
    """An interior opcode with a (non-transparent) hook cuts the run —
    detection modules must see every state."""
    code = b"\x60\x05\x60\x07\x01\x60\x03\x02\x00"  # PUSH ADD PUSH MUL STOP
    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    svm.register_hooks("pre", {"MUL": [lambda s: None]})
    from mythril_tpu_torch.laser.frontier import FrontierStepper

    stepper = FrontierStepper(svm)
    run = stepper._run_for(Disassembly(code), 0)
    assert run is not None
    assert "MUL" not in run.op_names  # cut before the hooked opcode
    assert run.op_names == ("PUSH1", "PUSH1", "ADD", "PUSH1")


def test_stepper_disabled_by_unmarked_execute_state_hook():
    code = b"\x60\x05\x60\x07\x01\x60\x03\x02\x00"
    svm, states = _engine_with_frontier(code, 1, [])
    svm.register_laser_hooks("execute_state", lambda s: None)
    from mythril_tpu_torch.laser.frontier import FrontierStepper

    stepper = FrontierStepper(svm)
    assert stepper.try_step(states[0]) is None


def test_first_op_pre_hooks_fire_per_state():
    seen = []
    code = b"\x5b\x60\x05\x60\x07\x01\x00"  # JUMPDEST PUSH PUSH ADD STOP
    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    svm.register_hooks("pre", {"JUMPDEST": [lambda s: seen.append(s)]})
    state = make_state(code, [])
    from mythril_tpu_torch.laser.frontier import FrontierStepper

    stepper = FrontierStepper(svm)
    results = stepper.try_step(state)
    assert results is not None and results[0].mstate.pc == 6
    assert seen == [state]


def test_sibling_collection_applies_loop_vetting():
    """Siblings pulled into a batch bypass strategy.__next__ — the
    bounded-loops accounting must still see them."""
    from mythril_tpu_torch.laser.strategy.extensions.bounded_loops import (
        BoundedLoopsStrategy,
        JumpdestCountAnnotation,
    )

    code = b"\x5b\x60\x05\x60\x07\x01\x00"
    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    svm.extend_strategy(BoundedLoopsStrategy, loop_bound=3)
    lead = make_state(code, [])
    looped = make_state(code, [])
    annotation = JumpdestCountAnnotation()
    annotation.trace = [0] * 12  # way past the bound
    looped.annotate(annotation)
    fresh = make_state(code, [])
    svm.work_list.extend([looped, fresh])
    from mythril_tpu_torch.laser.frontier import FrontierStepper

    stepper = FrontierStepper(svm)
    results = stepper.try_step(lead)
    # the looped sibling was vetted out entirely; lead + fresh stepped
    assert results is not None
    assert looped not in results
    assert fresh in results and lead in results
    assert svm.work_list == []


def test_batched_step_skips_fork_pruning(monkeypatch):
    """Multiple states out of a batched step are run SIBLINGS, not fork
    sides — the stochastic fork-pruning solve must not fire on them."""
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "pruning_factor", 1.0)
    import mythril_tpu_torch.service.scheduler as scheduler_mod

    def explode():
        raise AssertionError("fork pruning ran on a batched step")

    monkeypatch.setattr(scheduler_mod, "get_scheduler", explode)
    code = b"\x60\x05\x60\x07\x01\x60\x03\x02\x00"
    svm, _states = _engine_with_frontier(code, 3, [])
    svm.exec()  # would raise through the scheduler without the gate


def test_bailed_jumpdest_batch_retracts_loop_trace():
    """One real JUMPDEST visit must count once in the loop trace even
    when the state enters a batch, bails, and replays per-state."""
    from mythril_tpu_torch.laser.strategy.extensions.bounded_loops import (
        BoundedLoopsStrategy,
        JumpdestCountAnnotation,
    )

    # JUMPDEST, then an MSTORE far beyond the dense window -> bail
    code = b"\x5b" + _push(1 << 200) + b"\x52\x60\x01\x60\x02\x01\x00"
    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    svm.extend_strategy(BoundedLoopsStrategy, loop_bound=3)
    lead = make_state(code, [0xAA])
    assert svm.strategy.vet_state(lead)  # the strategy-yield append
    annotation = next(a for a in lead.annotations
                      if isinstance(a, JumpdestCountAnnotation))
    assert annotation.trace == [0]
    from mythril_tpu_torch.laser.frontier import FrontierStepper

    stepper = FrontierStepper(svm)
    results = stepper.try_step(lead)
    assert results == [lead]
    assert lead._frontier_skip_span is not None
    # retracted: the per-state replay's re-yield re-appends exactly once
    assert annotation.trace == []


# -- gating ------------------------------------------------------------------


def test_enabled_gating_matrix(monkeypatch):
    from mythril_tpu_torch.laser import frontier
    from mythril_tpu_torch.support.args import args

    monkeypatch.delenv("MYTHRIL_GPU_VMAP_FRONTIER", raising=False)
    monkeypatch.delenv("MYTHRIL_GPU_PREANALYSIS", raising=False)
    monkeypatch.setattr(args, "no_vmap_frontier", False)
    monkeypatch.setattr(args, "no_preanalysis", False)
    assert frontier.enabled()
    monkeypatch.setattr(args, "no_vmap_frontier", True)
    assert not frontier.enabled()
    monkeypatch.setenv("MYTHRIL_GPU_VMAP_FRONTIER", "1")
    assert frontier.enabled()  # env force-enables over the flag
    # ... but never over the preanalysis master switch
    monkeypatch.setattr(args, "no_preanalysis", True)
    assert not frontier.enabled()
    monkeypatch.setattr(args, "no_preanalysis", False)
    monkeypatch.setenv("MYTHRIL_GPU_VMAP_FRONTIER", "0")
    monkeypatch.setattr(args, "no_vmap_frontier", False)
    assert not frontier.enabled()


# -- findings parity through a full analyze ----------------------------------


def _analyze_issue_keys(code_hex, tx_count, **kwargs):
    report = run_analyze("mythril_tpu_torch", code_hex, tx_count, "cpu", 60,
                         pruning_factor=1.0, **kwargs)
    return issue_keys(report), report


def test_findings_parity_frontier_on_vs_off(monkeypatch):
    from tests.test_analysis import KILLBILLY, wrap_creation

    monkeypatch.delenv("MYTHRIL_GPU_FRONTIER_BACKEND")  # auto: the host
    stats = SolverStatistics()
    stats.reset()
    on_keys, _report = _analyze_issue_keys(wrap_creation(KILLBILLY), 1)
    assert stats.frontier_vmap_steps > 0, \
        "the frontier should fire during a creation analyze"
    stats.reset()
    off_keys, _report = _analyze_issue_keys(wrap_creation(KILLBILLY), 1,
                                            frontier=False)
    assert stats.frontier_vmap_steps == 0  # the off run stepped no batch
    assert on_keys == off_keys
    assert on_keys, "the parity check must compare real findings"


@pytest.mark.parametrize("file_name", ["suicide.sol.o", "origin.sol.o"])
def test_snapshot_contract_parity_frontier_on_vs_off(monkeypatch,
                                                     file_name):
    """Soundness on the report snapshots' contracts: the whole issue JSON
    with the frontier on and off is byte-identical (host CDCL, -t 1)."""
    monkeypatch.delenv("MYTHRIL_GPU_FRONTIER_BACKEND")
    code = snapshot_input(file_name)
    stats = SolverStatistics()
    outputs = []
    for on in (True, False):
        stats.reset()
        report = run_analyze("mythril_tpu_torch", code, 1, "cpu", 600,
                             frontier=on)
        outputs.append(json.loads(report.as_json())["issues"])
        if on:
            assert stats.frontier_vmap_steps > 0
    assert outputs[0] == outputs[1]
    assert outputs[0], "the parity check must compare real findings"


# -- stats plumbing ----------------------------------------------------------


def test_frontier_stats_in_dict_and_reset():
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    stats.add_frontier_step(states=6, slots=8, fallback_exits=2)
    stats.add_interp_seconds(1.5)
    out = stats.as_dict()
    assert out["frontier_vmap_steps"] == 1
    assert out["frontier_states_stepped"] == 6
    assert out["frontier_fallback_exits"] == 2
    assert out["frontier_fallback_dynamic"] == 2
    assert out["frontier_batch_slots"] == 8
    assert out["frontier_batch_occupancy"] == 1.0
    assert out["interp_wall"] == 1.5
    stats.reset()
    assert stats.frontier_vmap_steps == 0
    assert stats.as_dict()["frontier_batch_occupancy"] == 0.0
