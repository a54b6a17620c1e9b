"""The port's batched fork (mythril_tpu_torch/laser/frontier/ fork), held
to the port's own per-state interpreter: the cases of the JAX package's
tests/test_frontier_fork.py, with the port's router and K1's plain version
in the router cases.

The core evidence is the differential fork-parity test: randomized
programs terminating in a symbolic JUMPI, stepped (a) by the per-state
interpreter — whose JUMPI handler is the ground truth for successor
pcs, depths, and the appended path-condition terms — and (b) by the
batched fork path (terminal jumpi micro-op, pending-condition table,
fork epilogue), must agree bit for bit. On top: solver-confirmed
infeasible-side masking, loop-bound accounting over forked rows, the
conditionally-transparent MSTORE hook, the router's shared-cone fork
pairing, and the gating matrix.
"""

import random

import pytest

from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.laser import instructions
from mythril_tpu_torch.laser.frontier import FrontierStepper, dense, fastset
from mythril_tpu_torch import preanalysis
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from tests.test_torch_frontier import _engine_with_frontier, _push, bv, make_state


@pytest.fixture(autouse=True)
def fork_env(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_BACKEND", "numpy")
    monkeypatch.delenv("MYTHRIL_GPU_FRONTIER_FORK", raising=False)
    monkeypatch.delenv("MYTHRIL_GPU_FRONTIER_FORK_DEPTH", raising=False)
    # pin the PRE-symlane fork dialect (no halt promotion, no cross-fork
    # re-batching): these tests hold the batched fork itself; the
    # symbolic lane has its own suite in tests/test_torch_frontier_symlane.py
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_SYMLANE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_MULTIPC", "0")
    # feasibility bundles settle on the host CDCL (the port's default
    # backend is the card)
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "solver_backend", "cpu")
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield
    stats.reset()


def _no_prune(monkeypatch):
    """Pin the fork-pruning policy OFF (pruning_factor 0) so parity
    comparisons see both sides, exactly like the per-state path with
    pruning off."""
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "pruning_factor", 0.0)


#  DUP1; PUSH1 dest; JUMPI; STOP; JUMPDEST; STOP  (dest = 5)
FORK_CODE = b"\x80\x60\x05\x57\x00\x5b\x00"


def _sym_state(code=FORK_CODE, name="cond"):
    state = make_state(code, [])
    state.mstate.stack.append(symbol_factory.BitVecSym(name, 256))
    return state


# -- run compilation ---------------------------------------------------------


def test_fork_run_compiles_with_terminal_jumpi():
    state = _sym_state()
    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    stepper = FrontierStepper(svm)
    run = stepper._run_for(state.environment.code, 0)
    assert run is not None
    assert run.op_names == ("DUP1", "PUSH1", "JUMPI")
    assert run.fork is not None
    assert run.fork.pc == 3
    assert run.fork.dest_source == -1      # kernel-computed (the PUSH)
    assert run.fork.cond_source == 0       # original window passthrough
    assert run.end_pc == 4                 # fall-through address
    assert not run.cut_at_jumpi


def test_fork_disabled_cuts_at_jumpi(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", "0")
    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    stepper = FrontierStepper(svm)
    assert not stepper.fork_enabled
    # DUP1 + PUSH1 alone are below MIN_RUN_OPS: no run at all, and the
    # peek must not admit the JUMPI terminal when forking is off
    run = stepper._run_for(Disassembly(FORK_CODE), 0)
    assert run is None


def test_cut_at_jumpi_marks_longer_runs(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", "0")
    # PUSH PUSH ADD DUP1 PUSH dest JUMPI ... : prefix >= MIN_RUN_OPS
    code = b"\x60\x01\x60\x02\x01\x80\x60\x09\x57\x00\x5b\x00"
    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    stepper = FrontierStepper(svm)
    run = stepper._run_for(Disassembly(code), 0)
    assert run is not None and run.fork is None
    assert run.cut_at_jumpi


# -- differential fork parity ------------------------------------------------


def _random_fork_program(rng):
    """A program whose block ends in JUMPI over a symbolic (or sometimes
    concrete) condition: a fast-op prefix computes/shuffles, then
    PUSH dest; JUMPI; STOP; JUMPDEST; STOP. Returns (code, init_stack,
    symbolic_cond?)."""
    prefix = b""
    n_ops = rng.randrange(1, 6)
    depth = 1  # the condition symbol sits at the bottom of the window
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.5:
            prefix += _push(rng.getrandbits(rng.choice((8, 64, 256))))
            depth += 1
        elif roll < 0.75 and depth >= 1:
            n = rng.randrange(1, min(depth, 4) + 1)
            prefix += bytes([0x80 + n - 1])  # DUPn
            depth += 1
        elif depth >= 2:
            prefix += bytes([0x90])  # SWAP1
        else:
            prefix += _push(rng.randrange(256))
            depth += 1
    # ensure a condition on top beneath the dest: DUP the deepest slot
    # (the symbol) so the popped condition can be the original object
    prefix += bytes([0x80 + min(depth, 16) - 1])
    dest = len(prefix) + 3 + 1  # after PUSH1 x; JUMPI; STOP
    if dest > 255:
        return None
    code = prefix + bytes([0x60, dest, 0x57, 0x00, 0x5B, 0x00])
    symbolic = rng.random() < 0.8
    return code, symbolic


def _interpreter_fork(state, fork_pc):
    """Per-state oracle: step to the JUMPI and execute it."""
    while state.mstate.pc < fork_pc:
        successors = instructions.execute(state, state.instruction)
        assert len(successors) == 1
        state = successors[0]
    return instructions.execute(state, state.instruction)


def _state_key(state, base_constraints=1):
    # the first `base_constraints` entries are transaction-setup terms
    # whose fresh-symbol NAMES differ between independently-built states
    # (call_value1 vs call_value2); the fork parity claim is about the
    # appended path-condition suffix
    return (
        state.mstate.pc,
        state.mstate.depth,
        tuple(str(entry) for entry in state.mstate.stack),
        tuple(str(constraint) for constraint
              in state.world_state.constraints
              .get_all_constraints()[base_constraints:]),
        state.mstate.min_gas_used,
        state.mstate.max_gas_used,
    )


def test_differential_fork_parity_random(monkeypatch):
    """Randomized symbolic-JUMPI programs: batched fork successors must
    be bit-identical to the interpreter's JUMPI handler — pcs, depths,
    stacks, gas, and the appended path-condition terms."""
    _no_prune(monkeypatch)
    rng = random.Random(0xF0BE)
    checked = 0
    while checked < 60:
        generated = _random_fork_program(rng)
        if generated is None:
            continue
        code, symbolic = generated
        value = (symbol_factory.BitVecSym(f"c{checked}", 256) if symbolic
                 else bv(rng.choice((0, 0, 1, rng.getrandbits(64)))))

        def fresh():
            state = make_state(code, [])
            state.mstate.stack.append(value)
            return state

        svm, _ = _engine_with_frontier(code, 0, [])
        svm.work_list.clear()
        stepper = FrontierStepper(svm)
        lead = fresh()
        run = stepper._run_for(lead.environment.code, 0)
        if run is None or run.fork is None:
            continue
        if not dense.state_encodable(lead, run):
            continue
        oracle_successors = _interpreter_fork(fresh(), run.fork.pc)
        results = stepper.try_step(lead)
        assert results is not None
        assert getattr(results, "op_code", None) == "JUMPI"
        assert ([_state_key(s) for s in results]
                == [_state_key(s) for s in oracle_successors]), code.hex()
        checked += 1
    stats = SolverStatistics()
    assert stats.frontier_forks > 0
    assert stats.frontier_fork_rows > 0


def test_fork_batches_siblings_both_cohorts(monkeypatch):
    """N sibling rows at one symbolic JUMPI fork into 2N successors in
    one batched step, each with its OWN condition objects (identity:
    the original window BitVecs ride through opaquely)."""
    _no_prune(monkeypatch)
    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    states = [_sym_state(name=f"c{i}") for i in range(4)]
    svm.work_list.extend(states[1:])
    stepper = FrontierStepper(svm)
    results = stepper.try_step(states[0])
    assert results is not None and len(results) == 8
    assert svm.work_list == []
    fall = [s for s in results if s.mstate.pc == 4]
    taken = [s for s in results if s.mstate.pc == 5]
    assert len(fall) == len(taken) == 4
    for s in results:
        assert s.mstate.depth == 1
        last = s.world_state.constraints.get_all_constraints()[-1]
        assert "c" in str(last)
    stats = SolverStatistics()
    assert stats.frontier_forks == 1
    assert stats.frontier_fork_rows == 4


def test_fork_infeasible_side_masked_by_solver(monkeypatch):
    """A side whose path condition is UNSAT against the state's base
    constraints is masked dead (solver-confirmed by the host CDCL —
    get_models_batch's settle pass is the only UNSAT source) and never
    materializes."""
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "pruning_factor", 1.0)
    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    svm.execution_timeout = 3600
    state = _sym_state()
    cond = state.mstate.stack[-1]
    # pin the condition false up front: the taken side (cond != 0) is
    # infeasible before the fork even happens
    from mythril_tpu_torch.smt import simplify

    state.world_state.constraints.append(simplify(cond == bv(0)))
    stepper = FrontierStepper(svm)
    results = stepper.try_step(state)
    assert results is not None
    assert [s.mstate.pc for s in results] == [4]  # fall-through only
    stats = SolverStatistics()
    assert stats.frontier_fork_infeasible_pruned == 1


def test_fork_depth_cap_defers_to_interpreter(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK_DEPTH", "3")
    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    stepper = FrontierStepper(svm)
    state = _sym_state()
    state.mstate.depth = 5
    assert stepper.try_step(state) is None  # per-state path owns it
    assert state._frontier_skip_span is not None
    shallow = _sym_state()
    shallow.mstate.depth = 2
    assert stepper.try_step(shallow) is not None


def test_forked_rows_reach_loop_vetting(monkeypatch):
    """vet_state must see each forked row: successors enter the
    worklist and the bounded-loops wrapper accounts their JUMPDEST
    visits when they are yielded — forking batch-wise must not bypass
    loop bounds."""
    _no_prune(monkeypatch)
    from mythril_tpu_torch.laser.strategy.extensions.bounded_loops import (
        BoundedLoopsStrategy,
        JumpdestCountAnnotation,
    )

    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    svm.extend_strategy(BoundedLoopsStrategy, loop_bound=3)
    state = _sym_state()
    stepper = FrontierStepper(svm)
    results = stepper.try_step(state)
    assert results is not None and len(results) == 2
    svm.work_list.extend(results)
    yielded = list(iter(svm.strategy))
    assert len(yielded) == 2
    taken = next(s for s in yielded if s.mstate.pc == 5)
    annotation = next(a for a in taken.annotations
                      if isinstance(a, JumpdestCountAnnotation))
    # the taken side landed on the JUMPDEST at 5: the vet appended it
    assert annotation.trace == [5]


def test_fork_loop_terminates_under_bounded_loops(monkeypatch):
    """A symbolic loop (JUMPI back to its own head) explored with
    batched forking terminates exactly like the per-state path: the
    loop bound kills the looping cohort."""
    _no_prune(monkeypatch)
    from mythril_tpu_torch.laser.strategy.extensions.bounded_loops import (
        BoundedLoopsStrategy,
    )

    # JUMPDEST; DUP1; PUSH1 0; JUMPI; STOP   (loops to itself)
    code = b"\x5b\x80\x60\x00\x57\x00"
    stops = {}
    for label, env_value in (("on", "1"), ("off", "0")):
        monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", env_value)
        svm, _ = _engine_with_frontier(code, 0, [])
        svm.work_list.clear()
        svm.extend_strategy(BoundedLoopsStrategy, loop_bound=3)
        seen = []
        svm.register_hooks("pre", {"STOP": [lambda s, _seen=seen:
                                            _seen.append(s.mstate.pc)]})
        state = make_state(code, [])
        state.mstate.stack.append(
            symbol_factory.BitVecSym(f"loop_{label}", 256))
        svm.work_list.append(state)
        svm.exec()
        stops[label] = seen
    # each loop pass exits one fall-through state to the STOP; the loop
    # bound cuts the looping cohort at the same pass on both paths
    assert stops["on"] == stops["off"]
    assert stops["on"], "the loop must actually explore"


def test_fork_off_counts_fork_site_exits(monkeypatch):
    """With forking disabled, a state handed to the interpreter at a
    fork-capable site counts a dialect exit (no batch slot involved):
    the branch_fusion off-leg's side of the strictly-lower
    fallback-exit comparison."""
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", "0")
    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    stepper = FrontierStepper(svm)
    state = _sym_state()
    stats = SolverStatistics()
    # pc 0 ([DUP1, PUSH1] prefix, sub-minimal): nothing counted yet —
    # the exit is charged at the MINIMAL site, one fast op before the
    # JUMPI, so one per-state pass counts exactly once
    assert stepper.try_step(state) is None
    assert stats.frontier_fallback_exits == 0
    successors = instructions.execute(state, state.instruction)  # DUP1
    state = successors[0]
    assert state.mstate.pc == 1
    assert stepper.try_step(state) is None  # interpreter takes the branch
    assert stats.frontier_fallback_exits == 1
    assert stats.frontier_batch_bails == 0
    assert stats.frontier_batch_slots == 0  # no slot was occupied
    # the same site batches (and stops counting exits) with the fork on
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", "1")
    svm2, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm2.work_list.clear()
    from mythril_tpu_torch.support.args import args

    monkeypatch.setattr(args, "pruning_factor", 0.0)
    results = FrontierStepper(svm2).try_step(_sym_state())
    assert results is not None and len(results) == 2
    assert stats.frontier_fallback_exits == 1  # unchanged


# -- pre hooks at the fork ----------------------------------------------------


def test_jumpi_pre_hooks_fire_host_side(monkeypatch):
    """Non-transparent JUMPI pre hooks (dependence_on_origin /
    predictable register exactly these) fire per row on the
    reconstructed pre-JUMPI state: pc at the JUMPI, condition and
    destination back on the stack."""
    _no_prune(monkeypatch)
    seen = []

    def hook(state):
        seen.append((state.mstate.pc,
                     str(state.mstate.stack[-2]),
                     state.mstate.stack[-1].concrete_value))

    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    svm.register_hooks("pre", {"JUMPI": [hook]})
    stepper = FrontierStepper(svm)
    state = _sym_state()
    results = stepper.try_step(state)
    assert results is not None and len(results) == 2
    assert seen == [(3, "BitVec(cond)", 5)]


def test_jumpi_pre_hook_skip_drops_row(monkeypatch):
    _no_prune(monkeypatch)
    from mythril_tpu_torch.laser.plugin.signals import PluginSkipState

    def veto(state):
        raise PluginSkipState

    svm, _ = _engine_with_frontier(FORK_CODE, 0, [])
    svm.work_list.clear()
    svm.register_hooks("pre", {"JUMPI": [veto]})
    stepper = FrontierStepper(svm)
    results = stepper.try_step(_sym_state())
    assert results == []  # the row completed with no successors


# -- conditionally transparent MSTORE hook ------------------------------------

MARKER = int("0xcafecafecafecafecafecafecafecafecafecafe" + "00" * 12, 16)


def _marker_code(value):
    #  PUSH32 value; PUSH1 0; MSTORE; PUSH1 1; PUSH1 2; ADD; STOP
    return (b"\x7f" + value.to_bytes(32, "big")
            + b"\x60\x00\x52\x60\x01\x60\x02\x01\x00")


def _guarded_engine(code):
    from mythril_tpu_torch.analysis.module.modules.user_assertions import (
        UserAssertions,
    )
    from mythril_tpu_torch.analysis.module.util import get_detection_module_hooks

    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    svm.register_hooks("pre", get_detection_module_hooks(
        [UserAssertions()], hook_type="pre"))
    return svm


def test_guarded_mstore_batches_and_skips_inert_hook():
    code = _marker_code(0x1234)
    svm = _guarded_engine(code)
    stepper = FrontierStepper(svm)
    run = stepper._run_for(Disassembly(code), 0)
    assert run is not None
    assert "MSTORE" in run.op_names
    assert run.mem_guards  # compiled guarded, not cut
    state = make_state(code, [])
    results = stepper.try_step(state)
    assert results == [state]
    assert state.mstate.pc == run.end_pc  # completed in-batch


def test_guarded_mstore_marker_row_bails_so_hook_fires():
    """The gating test: a row that concretely writes the hevm marker
    trips the guard, bails untouched, and the hook fires on its
    per-state replay exactly as before."""
    code = _marker_code(MARKER)
    svm = _guarded_engine(code)
    stepper = FrontierStepper(svm)
    state = make_state(code, [])
    results = stepper.try_step(state)
    assert results == [state]
    assert state.mstate.pc == 0  # untouched: replays per-state
    assert state._frontier_skip_span is not None
    stats = SolverStatistics()
    assert stats.frontier_fallback_exits == 1


def test_unconditional_mstore_hook_still_cuts():
    code = _marker_code(0x1234)
    svm, _ = _engine_with_frontier(code, 0, [])
    svm.work_list.clear()
    svm.register_hooks("pre", {"MSTORE": [lambda s: None]})
    stepper = FrontierStepper(svm)
    run = stepper._run_for(Disassembly(code), 0)
    assert run is None or "MSTORE" not in run.op_names


# -- router fork lane ---------------------------------------------------------


def _fork_pair_problems():
    """Two side problems sharing one AIG: base roots plus the fork
    literal at opposite polarities — the exact shape the incremental
    prefix resume produces for a fork bundle."""
    from mythril_tpu_torch.smt.bitblast import AIG

    aig = AIG()
    a = aig.lit_of_var(aig.new_var())
    b = aig.lit_of_var(aig.new_var())
    cond = aig.lit_of_var(aig.new_var())
    base = aig.and_gate(a, b)
    roots_taken = [base, cond]
    roots_fall = [base, cond ^ 1]
    num_vars = aig.num_vars
    nv_t, clauses_t, dense_t = aig.to_cnf(roots_taken)
    nv_f, clauses_f, dense_f = aig.to_cnf(roots_fall)
    problem_t = (nv_t, clauses_t, (aig, roots_taken, dense_t))
    problem_f = (nv_f, clauses_f, (aig, roots_fall, dense_f))
    return aig, cond, problem_t, problem_f


def test_router_packs_fork_pair_with_extra_roots():
    from mythril_tpu_torch.gpu.backend import DeviceSolverBackend
    from mythril_tpu_torch.gpu.router import QueryRouter

    aig, cond, problem_t, problem_f = _fork_pair_problems()
    router = QueryRouter(DeviceSolverBackend(device="cpu"))
    pair = router._pack_fork_pair(0, 1, [problem_t, problem_f])
    assert pair is not None
    pc, extra_taken, extra_fall = pair
    assert pc.ok
    lit_local = pc.carry_local[cond >> 1]
    assert extra_taken == ((lit_local, True),)
    assert extra_fall == ((lit_local, False),)
    # the shared cone asserts ONLY the base roots; the fork node is
    # carried, unasserted, for the per-side extra root to pin
    assert pc.num_roots == 1


def test_fork_pair_sides_solve_on_one_ragged_stream():
    """Kernel-level: both sides of a fork pair ride ONE RaggedStream as
    shared-cone replicas and every model honors its side's pinned fork
    literal (K1's plain version on the CPU)."""
    import numpy as np
    import torch

    from mythril_tpu_torch.gpu import circuit, ragged_kernel
    from mythril_tpu_torch.gpu.backend import DeviceSolverBackend
    from mythril_tpu_torch.gpu.router import QueryRouter

    aig, cond, problem_t, problem_f = _fork_pair_problems()
    router = QueryRouter(DeviceSolverBackend(device="cpu"))
    pc, extra_taken, extra_fall = router._pack_fork_pair(
        0, 1, [problem_t, problem_f])
    stream = circuit.RaggedStream([(pc, extra_taken), (pc, extra_fall)])
    assert stream.ok and stream.num_cones == 2
    caps = ragged_kernel.KernelCaps(var_cap=256, cone_cap=4, root_cap=8,
                                    lane_tile=4, cone_tile=4, block=32)
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, caps), "cpu")
    generator = torch.Generator().manual_seed(7)
    x = circuit.init_inputs(generator, 8, caps.var_cap, "cpu")
    lit_local = pc.carry_local[cond >> 1]
    solved = {}
    for seed in range(64):
        x, found = ragged_kernel.run_round_ragged_kernel(
            flat, x, seed, 16, stream.num_levels + 4, caps)
        found_host = found.numpy()
        for ci in range(2):
            if ci not in solved and found_host[:, ci].any():
                lane = int(np.argmax(found_host[:, ci]))
                solved[ci] = stream.cone_assignment(ci, x.numpy()[lane])
        if len(solved) == 2:
            break
    assert len(solved) == 2, "both fork sides must solve on the stream"
    assert bool(solved[0][lit_local]) is True    # taken: cond pinned 1
    assert bool(solved[1][lit_local]) is False   # fall: cond pinned 0


def test_dispatch_counts_fork_stream_dispatches(monkeypatch):
    """Unpaired fork-side cones still ride the ragged stream and count
    fork_stream_dispatches (the acceptance counter)."""
    from tests.test_torch_router import FakeBackend, FakePC, problem

    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    from mythril_tpu_torch.gpu.router import QueryRouter

    pc_a, pc_b = FakePC(128), FakePC(128)
    backend = FakeBackend(answers={id(pc_a): [True], id(pc_b): [True]})
    router = QueryRouter(backend)
    router.per_cell_s = 1e-9
    results = router.dispatch([problem(pc_a), problem(pc_b)], 10.0,
                              SolverStatistics(), fork_pairs=[(0, 1)])
    assert len(backend.ragged_log) == 1
    assert SolverStatistics().fork_stream_dispatches == 1
    assert results == [[True], [True]]


# -- gating -------------------------------------------------------------------


def test_fork_gating_matrix(monkeypatch):
    from mythril_tpu_torch.laser import frontier
    from mythril_tpu_torch.support.args import args

    monkeypatch.delenv("MYTHRIL_GPU_VMAP_FRONTIER", raising=False)
    monkeypatch.delenv("MYTHRIL_GPU_PREANALYSIS", raising=False)
    monkeypatch.setattr(args, "no_vmap_frontier", False)
    monkeypatch.setattr(args, "no_preanalysis", False)
    monkeypatch.setattr(args, "no_frontier_fork", False)
    assert frontier.fork_enabled()
    monkeypatch.setattr(args, "no_frontier_fork", True)
    assert not frontier.fork_enabled()
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", "1")
    assert frontier.fork_enabled()  # env force-enables over the flag
    # ... but never over the vmap-frontier switch
    monkeypatch.setattr(args, "no_vmap_frontier", True)
    assert not frontier.fork_enabled()
    monkeypatch.setattr(args, "no_vmap_frontier", False)
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", "0")
    monkeypatch.setattr(args, "no_frontier_fork", False)
    assert not frontier.fork_enabled()


def test_findings_parity_fork_on_vs_off(monkeypatch):
    from tests.test_analysis import KILLBILLY, wrap_creation
    from tests.test_torch_frontier import _analyze_issue_keys

    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", "1")
    on_keys, _report = _analyze_issue_keys(wrap_creation(KILLBILLY), 1)
    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_FORK", "0")
    off_keys, _report = _analyze_issue_keys(wrap_creation(KILLBILLY), 1)
    assert on_keys == off_keys
    assert on_keys, "the parity check must compare real findings"
