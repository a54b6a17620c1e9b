"""The port's symbolic-value lane (mythril_tpu_torch/laser/frontier/
symlane.py), held to the port's own per-state interpreter: the cases of the
JAX package's tests/test_frontier_symlane.py.

The core evidence is the differential property test: random runs whose
stack windows MIX concrete and symbolic (and annotated) slots, stepped
(a) by the per-state interpreter — the ground-truth oracle for the
constructed terms — and (b) by the batched path with the lane's
structural replay, must agree on every stack term (string-identical
structure), object identity for passthrough slots, annotations, memory
terms, msize, pc and gas. On top: CALLDATALOAD promotion (the canonical
calldata term), RETURN/STOP terminal micro-ops (return-data bytes
identical, transaction-end machinery driven), the admission tag-sim
matrix, the fallback-reason breakdown, cross-fork re-batching, the
deferred-sweep pair-packing hit rate, gating, and findings parity lane
on/off.
"""

import random

import pytest

from mythril_tpu_torch.laser import instructions
from mythril_tpu_torch.laser.frontier import (
    FrontierStepper,
    dense,
    fastset,
    kernel,
    symlane,
)
from mythril_tpu_torch.laser.transaction.models import TransactionEndSignal
from mythril_tpu_torch import preanalysis
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from tests.test_torch_frontier import (
    _engine_with_frontier,
    _push,
    bv,
    make_state,
    random_program,
)


@pytest.fixture(autouse=True)
def symlane_env(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_BACKEND", "numpy")
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "1")
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_MULTIPC", "2")
    monkeypatch.delenv("MYTHRIL_GPU_FRONTIER_FORK", raising=False)
    # feasibility bundles settle on the host CDCL (the port's default
    # backend is the card)
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "solver_backend", "cpu")
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield
    stats.reset()


def _sym(name, annotate=None):
    value = symbol_factory.BitVecSym(name, 256)
    if annotate:
        value.annotate(annotate)
    return value


def _stepper_for(code):
    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    return svm, FrontierStepper(svm)


def _interpreter_to(state, end_pc):
    while state.mstate.pc < end_pc:
        successors = instructions.execute(state, state.instruction)
        assert len(successors) == 1
        state = successors[0]
    return state


def _interpreter_halt(state):
    """Oracle for halting programs: step until the transaction ends and
    return (final signal state, return-data string snapshot)."""
    while True:
        try:
            successors = instructions.execute(state, state.instruction)
        except TransactionEndSignal as signal:
            transaction = signal.global_state.transaction_stack[-1][0]
            return signal.global_state, _return_data_key(transaction)
        assert len(successors) == 1
        state = successors[0]


def _return_data_key(transaction):
    return_data = transaction.return_data
    if return_data is None:
        return None
    return (return_data.size if isinstance(return_data.size, int)
            else str(return_data.size),
            tuple(str(byte) for byte in return_data.return_data))


def _stack_key(state):
    return tuple(str(entry) for entry in state.mstate.stack)


def _memory_key(state, limit=1100):
    mstate = state.mstate
    return (mstate.memory.size,
            tuple(str(mstate.memory.get_byte(i)) for i in range(limit)))


# -- run compilation ----------------------------------------------------------


def test_calldataload_compiles_into_runs():
    #  PUSH1 4; CALLDATALOAD; PUSH1 1; ADD; STOP
    code = b"\x60\x04\x35\x60\x01\x01\x00"
    _svm, stepper = _stepper_for(code)
    run = stepper._run_for(make_state(code).environment.code, 0)
    assert run is not None and run is not None
    assert "CALLDATALOAD" in run.op_names
    assert run.has_calldataload
    assert run.halt is not None and run.halt.kind == "stop"


def test_calldataload_cuts_runs_with_lane_off(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "0")
    #  PUSH1 0; PUSH1 0; ADD; PUSH1 4; CALLDATALOAD; ...
    code = b"\x60\x00\x60\x00\x01\x60\x04\x35\x60\x01\x01\x00"
    _svm, stepper = _stepper_for(code)
    run = stepper._run_for(make_state(code).environment.code, 0)
    assert run is not None
    assert "CALLDATALOAD" not in run.op_names
    assert run.cut_at_calldataload


def test_leading_calldataload_two_op_run_compiles():
    """A jump target landing directly ON a CALLDATALOAD followed by one
    fast op then a blocked op still compiles a 2-op promoted run — the
    peek must not reject the shape extraction accepts (regression: the
    lane silently failed to engage at exactly the opcode it promotes,
    and no counter named the residual)."""
    code = b"\x35\x80\x54\x00"  # CALLDATALOAD; DUP1; SLOAD; STOP
    svm, stepper = _stepper_for(code)
    state = make_state(code)
    state.mstate.stack.append(bv(4))  # the load offset, from a prior block
    run = stepper._run_for(state.environment.code, 0)
    assert run is not None and run not in (None,)
    assert run.op_names == ("CALLDATALOAD", "DUP1")
    results = stepper.try_step(state)
    assert results == [state]
    assert state.mstate.pc == run.end_pc
    stats = SolverStatistics()
    assert stats.frontier_symlane_rows == 1


def test_return_compiles_as_terminal_halt():
    #  PUSH1 32; PUSH1 0; RETURN  (pops offset=0 top, length=32)
    code = b"\x60\x20\x60\x00\xf3"
    _svm, stepper = _stepper_for(code)
    run = stepper._run_for(make_state(code).environment.code, 0)
    assert run is not None
    assert run.halt is not None and run.halt.kind == "return"
    assert run.op_names == ("PUSH1", "PUSH1", "RETURN")
    # both operands kernel-computed (the two PUSHes)
    assert run.halt.offset_source == -1
    assert run.halt.length_source == -1


def test_halt_cut_with_lane_off(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "0")
    code = b"\x60\x05\x60\x07\x01\x60\x00\x52\x00"  # ... MSTORE; STOP
    _svm, stepper = _stepper_for(code)
    run = stepper._run_for(make_state(code).environment.code, 0)
    assert run is not None and run.halt is None
    assert run.cut_at_halt


# -- the differential property tests ------------------------------------------


def test_differential_symbolic_lane_random():
    """>= 200 random runs whose windows mix concrete/symbolic/annotated
    slots: the batched step (kernel rows exact, sym rows via the
    structural replay) must agree with the per-state interpreter on
    every stack TERM, passthrough identity, memory, msize, pc, gas."""
    rng = random.Random(0x51A11)
    checked = sym_checked = 0
    while checked < 200:
        code, init_stack = random_program(rng)
        state = make_state(code, init_stack)
        # replace a random subset of window entries with symbolic (and
        # sometimes annotated) values
        originals = []
        for j in range(len(state.mstate.stack)):
            roll = rng.random()
            if roll < 0.45:
                value = _sym(f"s{checked}_{j}",
                             annotate="taint" if roll < 0.12 else None)
                state.mstate.stack[j] = value
                originals.append(value)
        run = None
        summary = preanalysis.get_code_summary(state.environment.code)
        if summary is not None:
            run = fastset.extract_run(
                summary, 0, lambda name: False, lambda name: False,
                allow_halt=True, allow_symbolic=True)
        if run is None or run.halt is not None:
            continue
        if dense.state_prechecks(state, run) is not None:
            continue
        verdict, _reason = symlane.admit(state, run)
        if verdict is None:
            continue
        oracle = _interpreter_to(state.clone(), run.end_pc)
        frame = dense.encode_frontier([state], run)
        stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log, \
            _term = kernel.step_batch(run, frame, backend="numpy")
        if not ok[0]:
            continue  # dynamic bail (e.g. huge offset): per-state path
        if verdict == "sym":
            rep = symlane.replay(state, run)
            symlane.decode_sym_state(state, run, rep, mem_log, msize,
                                     min_gas, max_gas, 0)
            sym_checked += 1
        else:
            dense.decode_state(state, run, stack_out, mem, written,
                               msize, min_gas, max_gas, 0,
                               mem_log=mem_log)
        assert state.mstate.pc == oracle.mstate.pc
        assert _stack_key(state) == _stack_key(oracle), code.hex()
        assert state.mstate.min_gas_used == oracle.mstate.min_gas_used
        assert state.mstate.max_gas_used == oracle.mstate.max_gas_used
        assert _memory_key(state) == _memory_key(oracle), code.hex()
        # identity + annotation preservation: wherever the oracle kept
        # one of the ORIGINAL symbolic objects, the lane must hold the
        # very same object (not an equal reconstruction)
        for position, entry in enumerate(oracle.mstate.stack):
            if any(entry is original for original in originals):
                assert state.mstate.stack[position] is entry
        checked += 1
    assert sym_checked >= 35, \
        f"generator must exercise the replay path (got {sym_checked})"


def test_differential_calldataload_term():
    """CALLDATALOAD promotes to the canonical calldata term: the batch
    must push the exact get_word_at term the interpreter's handler
    appends (same calldata object, same offset object), and downstream
    ops must embed it identically."""
    #  PUSH1 4; CALLDATALOAD; PUSH1 1; ADD; PUSH1 0; MSTORE;
    #  PUSH1 2; PUSH1 3; ADD; STOP  (symbolic word stored to memory,
    #  then pure-concrete tail)
    code = (b"\x60\x04\x35\x60\x01\x01\x60\x00\x52"
            b"\x60\x02\x60\x03\x01\x00")
    svm, stepper = _stepper_for(code)
    state = make_state(code)
    oracle_state = state.clone()
    run = stepper._run_for(state.environment.code, 0)
    assert run is not None and run.has_calldataload
    assert run.halt is not None
    oracle, oracle_rd = _interpreter_halt(oracle_state)
    results = stepper.try_step(state)
    assert results is not None
    assert getattr(results, "op_code", None) == "STOP"
    # the lane's transaction end mirrors the oracle's: same return data
    assert _return_data_key(
        state.transaction_stack[-1][0]) == oracle_rd
    # the stored calldata-derived word is term-identical in memory
    assert _memory_key(state, limit=64) == _memory_key(oracle, limit=64)
    stats = SolverStatistics()
    assert stats.frontier_symlane_rows == 1
    assert stats.frontier_states_stepped == 1
    assert stats.frontier_fallback_exits == 0


def test_differential_return_data_bytes():
    """RETURN as a terminal micro-op: return-data must be byte-identical
    to the interpreter — including SYMBOLIC bytes the run itself stored
    into the window (read back as terms via Memory.get_byte)."""
    #  PUSH1 4; CALLDATALOAD; PUSH1 0; MSTORE; PUSH1 32; PUSH1 0; RETURN
    code = b"\x60\x04\x35\x60\x00\x52\x60\x20\x60\x00\xf3"
    svm, stepper = _stepper_for(code)
    state = make_state(code)
    oracle_state = state.clone()
    run = stepper._run_for(state.environment.code, 0)
    assert run is not None
    assert run.halt is not None and run.halt.kind == "return"
    _oracle, oracle_rd = _interpreter_halt(oracle_state)
    results = stepper.try_step(state)
    assert results is not None
    assert getattr(results, "op_code", None) == "RETURN"
    candidate_rd = _return_data_key(state.transaction_stack[-1][0])
    assert candidate_rd == oracle_rd
    assert oracle_rd is not None and len(oracle_rd[1]) == 32
    # a calldata byte term must actually appear in the data (the
    # symbolic path, not a concretized shadow)
    assert any("calldata" in byte for byte in oracle_rd[1])


def test_return_memory_expansion_gas_matches():
    """RETURN charges the memory-expansion fee through the same
    mem_extend the handler calls — gas bounds must match the oracle."""
    #  PUSH1 7; PUSH1 0; MSTORE8; PUSH1 64; PUSH1 64; RETURN
    #  (the RETURN window [64, 128) extends memory past the stores)
    code = b"\x60\x07\x60\x00\x53\x60\x40\x60\x40\xf3"
    svm, stepper = _stepper_for(code)
    state = make_state(code)
    oracle_state = state.clone()
    oracle, oracle_rd = _interpreter_halt(oracle_state)
    results = stepper.try_step(state)
    assert results is not None
    assert state.mstate.min_gas_used == oracle.mstate.min_gas_used
    assert state.mstate.max_gas_used == oracle.mstate.max_gas_used
    assert state.mstate.memory.size == oracle.mstate.memory.size
    assert _return_data_key(state.transaction_stack[-1][0]) == oracle_rd


def test_stop_completes_transaction_and_harvests_world_state():
    code = b"\x60\x05\x60\x07\x01\x60\x00\x52\x00"
    svm, stepper = _stepper_for(code)
    states = [make_state(code) for _ in range(3)]
    svm.work_list.extend(states[1:])
    results = stepper.try_step(states[0])
    assert results == []
    assert getattr(results, "op_code", None) == "STOP"
    assert len(svm.open_states) == 3  # every row's world state harvested
    stats = SolverStatistics()
    assert stats.frontier_states_stepped == 3
    assert stats.frontier_fallback_exits == 0


# -- admission tag-sim matrix -------------------------------------------------


def _run_at(code, allow_halt=True):
    state = make_state(code)
    summary = preanalysis.get_code_summary(state.environment.code)
    run = fastset.extract_run(summary, 0, lambda name: False,
                              lambda name: False, allow_halt=allow_halt,
                              allow_symbolic=True)
    assert run is not None
    return state, run


def test_admit_symbolic_mem_offset_rejects():
    #  [sym] PUSH1 1 ADD (sym arithmetic) -> MSTORE offset; STOP tail
    code = b"\x60\x01\x01\x60\xaa\x90\x52\x60\x01\x60\x01\x01\x00"
    state, run = _run_at(code)
    state.mstate.stack.append(_sym("off"))
    verdict, reason = symlane.admit(state, run)
    assert verdict is None and reason == "symbolic"


def test_admit_mload_after_symbolic_store_rejects():
    #  [sym] PUSH1 0 MSTORE (symbolic value) ; PUSH1 0 MLOAD ; POP; STOP
    code = b"\x60\x00\x52\x60\x00\x51\x50\x00"
    state, run = _run_at(code)
    state.mstate.stack.append(_sym("word"))
    verdict, reason = symlane.admit(state, run)
    assert verdict is None and reason == "symbolic"


def test_admit_symbolic_store_without_load_is_sym():
    #  [sym] PUSH1 0 MSTORE ; PUSH1 1 PUSH1 2 ADD ; STOP
    code = b"\x60\x00\x52\x60\x01\x60\x02\x01\x00"
    state, run = _run_at(code)
    state.mstate.stack.append(_sym("word"))
    verdict, reason = symlane.admit(state, run)
    assert verdict == "sym"


def test_admit_pure_shuffle_stays_kernel():
    #  [sym] PUSH1 7, PUSH1 5, ADD, SWAP1: sym only shuffled
    code = b"\x60\x07\x60\x05\x01\x90\x00"
    state, run = _run_at(code, allow_halt=False)
    state.mstate.stack.append(_sym("rider"))
    verdict, _reason = symlane.admit(state, run)
    assert verdict == "kernel"


def test_admit_consumed_symbolic_is_sym_and_decodes():
    """The headline case: a compute op CONSUMES a symbolic slot — the
    pre-lane path rejected this state outright; the lane admits it and
    the replay builds the mixed term."""
    #  [sym] PUSH1 5 ADD ; PUSH1 0 POP ; STOP
    code = b"\x60\x05\x01\x60\x00\x50\x00"
    state, run = _run_at(code, allow_halt=False)
    value = _sym("consumed")
    state.mstate.stack.append(value)
    assert not dense.state_encodable(state, run)  # pre-lane behavior
    verdict, _reason = symlane.admit(state, run)
    assert verdict == "sym"
    oracle = _interpreter_to(state.clone(), run.end_pc)
    frame = dense.encode_frontier([state], run, lane=True)
    assert frame.sym_tags[0].any()  # the tag lane marks the slot
    tagged = [frame.handles[0][j] for j in range(run.touch)
              if frame.sym_tags[0][j]]
    assert tagged and tagged[0] is value  # handle table holds the object
    out = kernel.step_batch(run, frame, backend="numpy")
    rep = symlane.replay(state, run, window=frame.handles[0])
    symlane.decode_sym_state(state, run, rep, out[7], out[3], out[4],
                             out[5], 0)
    assert _stack_key(state) == _stack_key(oracle)


def test_guarded_store_with_symbolic_value_bails_for_hook():
    from tests.test_torch_frontier_fork import _guarded_engine, _marker_code

    code = _marker_code(0x1234)
    svm = _guarded_engine(code)
    stepper = FrontierStepper(svm)
    state = make_state(code, [])
    run = stepper._run_for(state.environment.code, 0)
    assert run is not None and run.mem_guards
    # make the GUARDED store's value symbolic: replace the PUSH32 value
    # source by entering mid-run is not possible, so craft a state at a
    # custom code whose guarded store consumes a window slot instead
    code2 = b"\x60\x00\x52" + b"\x60\x01\x60\x02\x01\x00"  # MSTORE; tail
    svm2 = _guarded_engine(code2)
    stepper2 = FrontierStepper(svm2)
    state2 = make_state(code2, [])
    state2.mstate.stack.append(_sym("word"))
    run2 = stepper2._run_for(state2.environment.code, 0)
    assert run2 is not None and run2.mem_guards
    verdict, reason = symlane.admit(state2, run2)
    assert verdict is None and reason == "hook"


# -- fallback-reason accounting ----------------------------------------------


def test_calldataload_cut_counts_symbolic_exits(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "0")
    #  PUSH PUSH ADD DUP1 POP ; PUSH1 0; CALLDATALOAD; ... (prefix >= 3)
    code = b"\x60\x01\x60\x02\x01\x80\x50\x60\x00\x35\x00"
    svm, stepper = _stepper_for(code)
    state = make_state(code)
    results = stepper.try_step(state)
    assert results == [state]
    stats = SolverStatistics()
    assert stats.frontier_fallback_exits == 1
    assert stats.frontier_fallback_symbolic == 1
    assert stats.frontier_batch_bails == 0  # a completed row, not a bail


def test_lane_site_handoffs_count_by_reason(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "0")
    stats = SolverStatistics()
    # [PUSH1, CALLDATALOAD] minimal site: symbolic-operand handoff
    code = b"\x60\x00\x35\x00"
    svm, stepper = _stepper_for(code)
    assert stepper.try_step(make_state(code)) is None
    assert stats.frontier_fallback_symbolic == 1
    # [DUP1, RETURN] minimal site: dialect handoff
    code2 = b"\x80\xf3\x00"
    svm2, stepper2 = _stepper_for(code2)
    state2 = make_state(code2, [0, 0])
    assert stepper2.try_step(state2) is None
    assert stats.frontier_fallback_dialect == 1
    assert stats.frontier_fallback_exits == 2


def test_halt_pre_hooks_fire_host_side():
    """Non-transparent RETURN/STOP pre hooks (integer, unchecked_retval,
    multiple_sends register exactly these) fire per row on the
    reconstructed pre-halt state: pc at the halt, operands on stack."""
    seen = []

    def hook(state):
        seen.append((state.mstate.pc,
                     state.mstate.stack[-1].concrete_value,
                     state.mstate.stack[-2].concrete_value))

    code = b"\x60\x20\x60\x00\xf3"  # PUSH 32; PUSH 0; RETURN
    svm, stepper = _stepper_for(code)
    svm.register_hooks("pre", {"RETURN": [hook]})
    state = make_state(code)
    results = stepper.try_step(state)
    assert results is not None
    assert seen == [(4, 0, 32)]  # pc at RETURN; offset top, length below


def test_halt_pre_hook_skip_drops_row():
    from mythril_tpu_torch.laser.plugin.signals import PluginSkipState

    def veto(state):
        raise PluginSkipState

    code = b"\x60\x05\x60\x07\x01\x00"
    svm, stepper = _stepper_for(code)
    svm.register_hooks("pre", {"STOP": [veto]})
    state = make_state(code)
    results = stepper.try_step(state)
    assert results == []  # row completed with no successors
    assert not svm.open_states  # the skip really vetoed the harvest


# -- cross-fork re-batching ---------------------------------------------------


def test_fork_cohorts_rebatch_through_next_run(monkeypatch):
    """Both fork cohorts chain through their next dense run inside ONE
    try_step: the taken side's [JUMPDEST ...ops... STOP] run completes
    the transaction, the fall-through side's run advances — no cohort
    re-enters the worklist for a serialized iteration."""
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "pruning_factor", 0.0)
    #  DUP1; PUSH1 8; JUMPI; PUSH1 1; POP; STOP;            (fall: 4..)
    #  JUMPDEST; PUSH1 5; PUSH1 7; ADD; POP; STOP           (taken: 8..)
    code = (b"\x80\x60\x08\x57"          # 0: DUP1; PUSH1 8; JUMPI
            b"\x60\x01\x50\x00"          # 4: PUSH1 1; POP; STOP
            b"\x5b\x60\x05\x60\x07\x01\x50\x00")  # 8: JUMPDEST ... STOP
    svm, stepper = _stepper_for(code)
    state = make_state(code)
    state.mstate.stack.append(_sym("cond"))
    results = stepper.try_step(state)
    assert results is not None
    # with MULTIPC=2 both cohorts chained through halting runs: the
    # whole path tree settled inside one strategy yield
    assert results == []
    assert getattr(results, "op_code", None) is None  # nodes managed
    assert len(svm.open_states) == 2  # both sides' transactions ended
    assert svm.work_list == []
    stats = SolverStatistics()
    assert stats.frontier_forks == 1
    assert stats.frontier_vmap_steps == 3  # fork step + 2 chained runs
    assert stats.frontier_fork_cohort_rows == 1


def test_bare_halt_run_batches_states_landing_on_stop():
    """A state sitting directly ON a STOP (the dispatch fall-through
    shape) batches as a prefix-less halt run: the transaction ends
    through the halt epilogue, no per-state STOP row, no double hook
    or snapshot (the prologue's firing is the one firing)."""
    code = b"\x60\x01\x60\x02\x01\x00"  # ...; STOP at pc 5
    seen = []
    svm, stepper = _stepper_for(code)
    svm.register_hooks("pre", {"STOP": [lambda s: seen.append(s.mstate.pc)]})
    state = make_state(code)
    state.mstate.pc = 5  # landed directly on the STOP
    results = stepper.try_step(state)
    assert results == []
    assert getattr(results, "op_code", None) == "STOP"
    assert len(svm.open_states) == 1
    assert seen == [5]  # the pre hook fired exactly once, at the halt
    stats = SolverStatistics()
    assert stats.frontier_states_stepped == 1


def test_bare_return_run_pops_window_operands():
    code = b"\x00\x60\x20\x60\x00\xf3"  # STOP; then RETURN at pc 5
    svm, stepper = _stepper_for(code)
    state = make_state(code, [])
    state.mstate.stack.append(bv(32))  # length
    state.mstate.stack.append(bv(0))   # offset on top
    state.mstate.pc = 5
    oracle_state = state.clone()
    _oracle, oracle_rd = _interpreter_halt(oracle_state)
    results = stepper.try_step(state)
    assert results is not None
    assert getattr(results, "op_code", None) == "RETURN"
    assert _return_data_key(state.transaction_stack[-1][0]) == oracle_rd


def test_chained_inner_fork_still_gets_cfg_nodes(monkeypatch):
    """Regression (found on stress_dispatch as findings attributed to
    "fallback"): a chained cohort's OWN step may return terminal
    results carrying an op code — an inner fork past the chain budget.
    _rebatch_cohorts must run the node management exec would have run,
    or the inner successors lose their conditional-edge nodes and the
    function-entry naming that rides them."""
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "pruning_factor", 0.0)
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_MULTIPC", "1")
    #  0: DUP1; PUSH1 8; JUMPI;           outer fork
    #  4: DUP1; PUSH1 12; JUMPI;          fall-through forks AGAIN
    #  8: JUMPDEST; STOP; STOP; STOP;
    # 12: JUMPDEST; STOP
    code = (b"\x80\x60\x08\x57"
            b"\x80\x60\x0c\x57"
            b"\x5b\x00\x00\x00"
            b"\x5b\x00")
    svm, stepper = _stepper_for(code)
    state = make_state(code)
    state.mstate.stack.append(_sym("cond"))
    results = stepper.try_step(state)
    assert results is not None and results
    # the width-1 budget chains only the fall-through cohort, whose run
    # ends in the INNER fork past the budget: its successors come back
    # through the chain with op_code "JUMPI" — every live successor
    # must still sit on a fresh node at its own pc (the conditional-
    # edge node exec would have assigned)
    pcs = sorted(s.mstate.pc for s in results)
    assert 12 in pcs  # the inner fork's taken side really came back
    for successor in results:
        assert successor.node is not None
        assert successor.node.start_addr == successor.mstate.pc


def test_rebatch_respects_max_depth(monkeypatch):
    """Chained cohort leads must respect the strategy's depth bound:
    successors AT max_depth come back unchained for the strategy to
    discard on yield, exactly as the per-state path — chaining them
    would execute a run the depth filter forbids (and diverge findings
    between the multipc knob's on/off legs)."""
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "pruning_factor", 0.0)
    code = (b"\x80\x60\x08\x57"
            b"\x80\x60\x0c\x57"
            b"\x5b\x00\x00\x00"
            b"\x5b\x00")
    svm, stepper = _stepper_for(code)
    svm.max_depth = 1
    state = make_state(code)
    state.mstate.stack.append(_sym("cond"))
    results = stepper.try_step(state)
    assert results is not None and len(results) == 2
    assert all(s.mstate.depth == 1 for s in results)
    stats = SolverStatistics()
    assert stats.frontier_vmap_steps == 1  # the fork step only


def test_multipc_zero_restores_worklist_round_trip(monkeypatch):
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "pruning_factor", 0.0)
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_MULTIPC", "0")
    code = (b"\x80\x60\x08\x57"
            b"\x60\x01\x50\x00"
            b"\x5b\x60\x05\x60\x07\x01\x50\x00")
    svm, stepper = _stepper_for(code)
    state = make_state(code)
    state.mstate.stack.append(_sym("cond"))
    results = stepper.try_step(state)
    assert results is not None and len(results) == 2
    assert getattr(results, "op_code", None) == "JUMPI"  # exec manages
    stats = SolverStatistics()
    assert stats.frontier_vmap_steps == 1  # no chaining happened


def test_occupancy_credits_fork_cohort_rows():
    stats = SolverStatistics()
    stats.add_frontier_step(states=4, slots=4)
    stats.add_frontier_fork(rows=4, seconds=0.0, cohort_rows=4)
    # 4 slots produced 8 live rows: occupancy reads 2.0, not 1.0
    assert stats.frontier_batch_occupancy == 2.0
    assert stats.frontier_fork_cohort_rows == 4


# -- deferred-sweep pair packing ----------------------------------------------


def test_deferred_sweep_keeps_pair_packable():
    """A fork pair prepared under deferred_forcing lands in ONE session
    AIG with base roots identical and the diff exactly {L, L^1} — the
    shape _pack_fork_pair requires; the forced sweep diverges it."""
    from mythril_tpu_torch.preanalysis import aig_opt
    from mythril_tpu_torch.smt import simplify
    from mythril_tpu_torch.smt.solver.frontend import Solver

    a = symbol_factory.BitVecSym("dfs_a", 256)
    b = symbol_factory.BitVecSym("dfs_b", 256)
    base = [a + b == bv(10), (a & b) == bv(2)]
    branch = simplify((a - b) != bv(0))
    negated = simplify((a - b) == bv(0))
    preps = []
    for side in (base + [negated], base + [branch]):
        solver = Solver(timeout=5.0)
        solver.add([c.raw for c in side])
        with aig_opt.deferred_forcing():
            preps.append(solver._prepare([]))
    aig_t, roots_t = preps[0].aig_roots[0], set(preps[0].aig_roots[1])
    aig_f, roots_f = preps[1].aig_roots[0], set(preps[1].aig_roots[1])
    assert aig_t is aig_f
    only_t, only_f = roots_t - roots_f, roots_f - roots_t
    assert len(only_t) == 1 and len(only_f) == 1
    lit = next(iter(only_t))
    assert next(iter(only_f)) == (lit ^ 1)


def test_forced_sweep_unchanged_outside_scope():
    """Outside the deferred scope the sweep still forces roots (the
    pinned-input unit roots are its signature) — the defer path must
    not leak into plain traffic."""
    from mythril_tpu_torch.preanalysis import aig_opt
    from mythril_tpu_torch.smt.bitblast import AIG

    aig = AIG()
    x = aig.lit_of_var(aig.new_var())
    y = aig.lit_of_var(aig.new_var())
    root = aig.and_gate(x, y)
    forced = aig_opt.optimize_roots(aig, [root])
    assert forced is not None
    # forcing decomposes the AND into two pinned-input unit roots
    assert sorted(forced.roots) == sorted(
        [2 * v for v in forced.input_map.values()])
    deferred = aig_opt.optimize_roots(aig, [root], force_roots=False)
    if deferred is not None:  # None when incremental prep is disabled
        assert len(deferred.roots) == 1  # the root stayed structural


def test_router_counts_pair_pack_hit_rate(monkeypatch):
    from tests.test_torch_frontier_fork import _fork_pair_problems
    from mythril_tpu_torch.gpu.backend import DeviceSolverBackend
    from mythril_tpu_torch.gpu.router import QueryRouter

    from mythril_tpu_torch.gpu.device import clear_fault

    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    stats = SolverStatistics()
    aig, cond, problem_t, problem_f = _fork_pair_problems()
    router = QueryRouter(DeviceSolverBackend(device="cpu"))
    router.per_cell_s = 1e-9
    try:
        router.dispatch([problem_t, problem_f], 10.0, stats,
                        fork_pairs=[(0, 1)])
    except Exception:
        pass  # the counting happened before any launch
    finally:
        clear_fault()
    assert stats.fork_pair_pack_attempts == 1
    assert stats.fork_pair_pack_hits == 1


# -- gating -------------------------------------------------------------------


def test_symlane_gating_matrix(monkeypatch):
    from mythril_tpu_torch.laser import frontier
    from mythril_tpu_torch.support.args import args

    monkeypatch.delenv("MYTHRIL_GPU_VMAP_FRONTIER", raising=False)
    monkeypatch.delenv("MYTHRIL_GPU_PREANALYSIS", raising=False)
    monkeypatch.setattr(args, "no_vmap_frontier", False)
    monkeypatch.setattr(args, "no_preanalysis", False)
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "1")
    assert frontier.symlane_enabled()
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "0")
    assert not frontier.symlane_enabled()
    monkeypatch.delenv("MYTHRIL_GPU_FRONTIER_SYMLANE", raising=False)
    assert frontier.symlane_enabled()  # default on
    # ... but never over the vmap-frontier switch
    monkeypatch.setattr(args, "no_vmap_frontier", True)
    assert not frontier.symlane_enabled()
    monkeypatch.setattr(args, "no_vmap_frontier", False)
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_MULTIPC", "3")
    assert frontier.multipc_width() == 3
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_MULTIPC", "-2")
    assert frontier.multipc_width() == 0  # clamped


# -- findings parity ----------------------------------------------------------


def test_findings_parity_symlane_on_vs_off(monkeypatch):
    from tests.test_analysis import KILLBILLY, wrap_creation
    from tests.test_torch_frontier import _analyze_issue_keys

    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "1")
    on_keys, _report = _analyze_issue_keys(wrap_creation(KILLBILLY), 1)
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "0")
    off_keys, _report = _analyze_issue_keys(wrap_creation(KILLBILLY), 1)
    assert on_keys == off_keys
    assert on_keys, "the parity check must compare real findings"


@pytest.mark.parametrize("file_name", ["suicide.sol.o", "origin.sol.o"])
def test_snapshot_contract_parity_symlane_on_vs_off(monkeypatch, file_name):
    """Soundness on the report snapshots' contracts: the whole issue JSON
    with the symbolic lane on and off is byte-identical (host CDCL,
    -t 1)."""
    import json

    from tests.torch_helpers import run_analyze, snapshot_input

    monkeypatch.delenv("MYTHRIL_GPU_FRONTIER_BACKEND")  # auto: the host
    code = snapshot_input(file_name)
    stats = SolverStatistics()
    outputs = []
    for env_value in ("1", "0"):
        monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", env_value)
        stats.reset()
        report = run_analyze("mythril_tpu_torch", code, 1, "cpu", 600)
        outputs.append(json.loads(report.as_json())["issues"])
        if env_value == "1":
            assert stats.frontier_symlane_rows > 0
    assert outputs[0] == outputs[1]
    assert outputs[0], "the parity check must compare real findings"
