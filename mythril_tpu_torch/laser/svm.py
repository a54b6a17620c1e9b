"""LaserEVM — the worklist symbolic-execution engine
(reference mythril/laser/ethereum/svm.py:812).

Holds open world states between transactions, a strategy-ordered worklist of
GlobalStates within a transaction, per-opcode pre/post hook tables for
detection modules, named laser-hook channels for plugins, and the CFG.

Frame discipline (differs from the reference mechanically, same semantics):
states are mutated in place under single ownership; the caller state is
SNAPSHOTTED when an inner transaction starts, so revert restores it exactly
(the reference gets this by copying every instruction — svm.py:459-579).

With `vmap_frontier` (SymExecWrapper's default for analysis runs) sibling
states step straight-line runs as one batched step (laser/frontier/),
K6 on the card; the rest steps one state at a time through
laser/instructions.py."""

import logging
import random
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from mythril_tpu_torch.laser import instructions
from mythril_tpu_torch.laser.cfg import Edge, JumpType, Node, NodeFlags
from mythril_tpu_torch.observe.tracer import traced
from mythril_tpu_torch.laser.evm_exceptions import VmException
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState, PluginSkipWorldState
from mythril_tpu_torch.laser.state.global_state import GlobalState
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.laser.strategy.basic import BreadthFirstSearchStrategy
from mythril_tpu_torch.laser.transaction.models import (
    ContractCreationTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
)
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.time_handler import time_handler

log = logging.getLogger(__name__)

LASER_HOOK_CHANNELS = (
    "start_sym_exec",
    "stop_sym_exec",
    "start_sym_trans",
    "stop_sym_trans",
    "start_exec",
    "stop_exec",
    "start_execute_transactions",
    "stop_execute_transactions",
    "add_world_state",
    "execute_state",
    "transaction_start",
    "transaction_end",
)


class SVMError(Exception):
    pass


class LaserEVM:
    def __init__(
        self,
        dynamic_loader=None,
        max_depth: int = 128,
        execution_timeout: Optional[int] = 3600,
        create_timeout: Optional[int] = 30,
        strategy=BreadthFirstSearchStrategy,
        transaction_count: int = 2,
        requires_statespace: bool = True,
        iprof=None,
        use_reachability_check: bool = True,
        beam_width: Optional[int] = None,
        preanalysis=None,
        vmap_frontier: bool = False,
    ):
        self.open_states: List[WorldState] = []
        self.work_list: List[GlobalState] = []
        self.dynamic_loader = dynamic_loader
        self.max_depth = max_depth
        self.execution_timeout = execution_timeout or 0
        self.create_timeout = create_timeout or 0
        self.transaction_count = transaction_count
        self.use_reachability_check = use_reachability_check
        self.requires_statespace = requires_statespace
        self.iprof = iprof

        # static pre-analysis summary of the analyzed contract (a
        # preanalysis.CodeSummary, or None when disabled/unavailable).
        # Handed to the search strategy as `effect_hints` (per-function
        # effect summaries) and gates the fork-prune query-skip below —
        # direct engine users (concolic, vmtests) never set it, so their
        # behavior is untouched.
        self.preanalysis = preanalysis

        # batched frontier (laser/frontier/): straight-line stepping over
        # sibling states. Opt-in (SymExecWrapper sets it for analysis
        # runs); the stepper is built lazily on first exec so every hook
        # registration is visible to its eligibility gates
        self.vmap_frontier = vmap_frontier
        self._frontier = None

        strategy_kwargs = {}
        if beam_width is not None:
            strategy_kwargs["beam_width"] = beam_width
        if preanalysis is not None:
            strategy_kwargs["effect_hints"] = preanalysis
        self.strategy = strategy(self.work_list, max_depth, **strategy_kwargs)

        # statespace
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []

        # metrics
        self.total_states = 0
        self.executed_transactions = False

        # hooks
        self._hooks: Dict[str, List[Callable]] = defaultdict(list)  # named channels
        self.pre_hooks: Dict[str, List[Callable]] = defaultdict(list)
        self.post_hooks: Dict[str, List[Callable]] = defaultdict(list)
        self.instr_pre_hook: Dict[str, List[Callable]] = defaultdict(list)
        self.instr_post_hook: Dict[str, List[Callable]] = defaultdict(list)

        self.time: Optional[float] = None
        self._start_time: Optional[float] = None
        # optional selector-ranking provider (laser/tx_prioritiser.py)
        self.tx_prioritiser = None

    # -- hook registration ---------------------------------------------------

    def register_laser_hooks(self, hook_type: str, hook: Callable):
        if hook_type not in LASER_HOOK_CHANNELS:
            raise ValueError(f"unknown hook channel {hook_type}")
        self._hooks[hook_type].append(hook)

    def register_hooks(self, hook_type: str, hook_dict: Dict[str, List[Callable]]):
        """Detection-module opcode hooks: hook_type 'pre' or 'post'."""
        table = self.pre_hooks if hook_type == "pre" else self.post_hooks
        for op_name, hooks in hook_dict.items():
            table[op_name].extend(hooks)

    def register_instr_hooks(self, hook_type: str, opcode: str, hook: Callable):
        """Plugin per-instruction hooks; empty opcode = all opcodes."""
        table = self.instr_pre_hook if hook_type == "pre" else self.instr_post_hook
        if opcode:
            table[opcode].append(hook)
        else:
            from mythril_tpu_torch.support.opcodes import BY_NAME

            for name in BY_NAME:
                table[name].append(hook)

    def extend_strategy(self, extension, **kwargs):
        self.strategy = extension(self.strategy, **kwargs)

    def _fire(self, channel: str, *fire_args):
        for hook in self._hooks[channel]:
            hook(*fire_args)

    # -- top-level drivers ---------------------------------------------------

    def sym_exec(
        self,
        world_state: Optional[WorldState] = None,
        target_address: Optional[int] = None,
        creation_code: Optional[str] = None,
        contract_name: Optional[str] = None,
    ):
        """Creation-mode (creation_code) or existing-contract analysis."""
        from mythril_tpu_torch.laser.transaction.symbolic import (
            execute_contract_creation,
            execute_message_call,
        )
        from mythril_tpu_torch.smt import symbol_factory

        time_handler.start_execution(self.execution_timeout)
        self._fire("start_sym_exec")
        self._start_time = time.monotonic()

        if creation_code is not None:
            log.info("starting contract creation transaction")
            created_account = execute_contract_creation(
                self, creation_code, contract_name, world_state=world_state
            )
            if not self.open_states:
                log.warning(
                    "no contract was created during the creation transaction"
                )
            self.execute_transactions(created_account.address)
        elif target_address is not None:
            address = (
                symbol_factory.BitVecVal(target_address, 256)
                if isinstance(target_address, int)
                else target_address
            )
            if world_state is not None:
                self.open_states = [world_state]
            self.execute_transactions(address)

        self.time = time.monotonic() - (self._start_time or time.monotonic())
        self._fire("stop_sym_exec")

    def execute_transactions(self, address):
        """The message-call transaction loop (reference svm.py:252-309)."""
        from mythril_tpu_torch.laser.transaction.symbolic import execute_message_call

        pinned_sequences = self._parse_transaction_sequences()
        if pinned_sequences is None and getattr(self, "tx_prioritiser", None):
            # non-ordered exploration: the prioritizer pins the selector
            # order per tx (reference svm.py:241-250 via rf_prioritiser)
            pinned_sequences = self.tx_prioritiser.predict_sequences(
                self.transaction_count)
        self._fire("start_execute_transactions")
        self.executed_transactions = True
        for i in range(self.transaction_count):
            if len(self.open_states) == 0:
                break
            # reachability prune of open states (reference :266-286); the
            # pending strategy probes the model cache before full solves
            # (reference constraint_strategy.py "delayed solving")
            if self.use_reachability_check and i > 0:
                from mythril_tpu_torch.service.scheduler import get_scheduler

                before = len(self.open_states)
                # every open state's reachability query rides the
                # coalescing scheduler: one window flush -> one batched
                # get_models_batch -> the router's ragged streams.
                # Engine-path reachability verdicts
                # (no UNSAT crosscheck: a wrong prune costs coverage, not
                # a false "safe")
                outcomes = get_scheduler().solve_batch(
                    [ws.constraints.get_all_constraints()
                     for ws in self.open_states],
                    crosscheck=False,
                )
                self.open_states = [
                    ws for ws, (status, _model) in zip(self.open_states, outcomes)
                    if status != "unsat"
                ]
                log.info(
                    "tx %d: %d/%d open states reachable",
                    i + 1, len(self.open_states), before,
                )
            log.info(
                "starting message call transaction %d, open states: %d",
                i + 1, len(self.open_states),
            )
            self._fire("start_sym_trans")
            func_hashes = (
                pinned_sequences[i]
                if pinned_sequences and i < len(pinned_sequences)
                else None
            )
            execute_message_call(self, address, func_hashes=func_hashes)
            self._fire("stop_sym_trans")
        self._fire("stop_execute_transactions")

    @staticmethod
    def _parse_transaction_sequences():
        """--transaction-sequences '[[0xa9059cbb],[-1]]' -> per-tx selector
        lists (reference symbolic.py:74-100); -1 means the fallback."""
        import ast

        raw = args.transaction_sequences
        if not raw:
            return None
        parsed = ast.literal_eval(raw) if isinstance(raw, str) else raw
        sequences = []
        for tx_entry in parsed:
            hashes = []
            for selector in tx_entry:
                if selector == -1:
                    hashes.append(-1)
                else:
                    hashes.append(int(selector).to_bytes(4, "big"))
            sequences.append(hashes)
        return sequences

    # -- the hot loop --------------------------------------------------------

    @traced("laser.exec", cat="laser")
    def exec(self, create: bool = False, track_gas: bool = False):
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        self._fire("start_exec")
        # states that produced no successors — the ended/leaf states the
        # VMTests harness asserts gas ranges on (reference svm.py:362-363)
        final_states: List[GlobalState] = []
        start = time.monotonic()
        stats = SolverStatistics()
        if self.vmap_frontier and self._frontier is None:
            from mythril_tpu_torch.laser.frontier import FrontierStepper

            self._frontier = FrontierStepper(self)
        # the interleaved corpus run's yield point (service/interleave.py;
        # mythril_tpu/laser/svm.py:293-300): the baton moves between
        # contracts every quantum of exec iterations; a thread-local and a
        # global load and a None check when no coordinator is live
        from mythril_tpu_torch.service.interleave import tick as interleave_tick

        for global_state in self.strategy:
            interleave_tick()
            if create and self.create_timeout:
                if time.monotonic() - start > self.create_timeout:
                    log.info("create timeout reached")
                    break
            if not create and self.execution_timeout:
                # time_handler covers the analyzer path; the local clock
                # covers direct engine use (concolic/tests) where
                # start_execution was never called
                if (
                    time_handler.time_remaining() <= 0
                    or time.monotonic() - start > self.execution_timeout
                ):
                    log.info("execution timeout reached")
                    break
            step_start = time.monotonic()
            solver_before = stats.solver_time
            try:
                # batched frontier step first: a straight-line run over
                # every eligible sibling as one step. op_code None keeps
                # manage_cfg out for straight-line runs; a batched FORK
                # returns op_code "JUMPI" so its successors get the same
                # conditional-edge nodes the per-state handler's states
                # get (feasibility pruning already happened inside the
                # stepper's fork epilogue — one coalesced bundle); a
                # batched HALT returns "RETURN"/"STOP" so frame successors
                # get RETURN nodes (the transaction end already ran
                # through _end_transaction inside the halt epilogue); and
                # a fork whose cohorts chained through their next run
                # (cross-fork re-batching) comes back as op_code None —
                # the stepper ran manage_cfg for the fork's own
                # successors before chaining
                batched = (
                    self._frontier.try_step(global_state)
                    if self._frontier is not None else None
                )
                if batched is not None:
                    new_states = batched
                    op_code = getattr(batched, "op_code", None)
                else:
                    new_states, op_code = self.execute_state(global_state)
            except NotImplementedError:
                log.debug("encountered unimplemented instruction")
                continue
            finally:
                # solver seconds spent INSIDE handlers (concretization,
                # tx-end confirmations) are already attributed to
                # solver_time — subtract them so interp_wall isolates the
                # stepping machinery
                stats.add_interp_seconds(
                    max(0.0, (time.monotonic() - step_start)
                        - (stats.solver_time - solver_before)))

            # stochastic reachability pruning on forks (reference :351-358):
            # with probability pruning_factor, drop fork sides whose path
            # constraints are unsat. Auto: always prune on long-budget runs,
            # never on short ones (reference mythril_analyzer.py:78-82).
            # op_code None = a batched frontier step: its multiple states
            # are SIBLINGS of one straight-line run, not fork sides — no
            # constraint changed, so feasibility solves (or pending-list
            # parking) here would be pure waste. A batched FORK
            # (op_code "JUMPI" with batched set) already pruned and
            # parked inside the stepper — re-solving here would double
            # every fork's feasibility traffic
            if batched is None and op_code is not None \
                    and len(new_states) > 1:
                pruning_factor = args.pruning_factor
                if pruning_factor is None:
                    pruning_factor = 1.0 if self.execution_timeout > 300 else 0.0
                if (
                    pruning_factor > 0.0
                    and self.strategy.run_check()
                    and random.random() < pruning_factor
                ):
                    # ALL fork sides of this exec iteration are submitted
                    # to the coalescing scheduler and demanded together:
                    # one window flush, one device fan-out under
                    # --solver-backend=gpu, instead of serial is_possible
                    from mythril_tpu_torch.service.scheduler import get_scheduler

                    # static effect hints (preanalysis): fork sides whose
                    # remaining cone is provably inert skip the
                    # feasibility solve and are KEPT unchecked — always
                    # findings-sound (issues are solver-confirmed; an
                    # unsat survivor can confirm nothing) and proven
                    # traffic-free (no detector hooks, no effects in the
                    # cone; the next open-state reachability gate still
                    # filters it). Counted as queries_avoided.
                    check_states = new_states
                    if self.preanalysis is not None:
                        from mythril_tpu_torch import preanalysis as pre_mod
                        from mythril_tpu_torch.smt.solver.statistics import (
                            SolverStatistics,
                        )

                        check_states = [
                            s for s in new_states
                            if not pre_mod.prune_check_skippable(s)
                        ]
                        skipped = len(new_states) - len(check_states)
                        if skipped:
                            SolverStatistics().add_queries_avoided(skipped)
                    # engine-path fork pruning: crosscheck off, as above
                    outcomes = get_scheduler().solve_batch(
                        [s.world_state.constraints.get_all_constraints()
                         for s in check_states],
                        crosscheck=False,
                    )
                    pruned = {
                        id(s) for s, (status, _model)
                        in zip(check_states, outcomes) if status == "unsat"
                    }
                    new_states = [
                        s for s in new_states if id(s) not in pruned
                    ]
                elif not self.strategy.run_check():
                    # delayed-solving strategy: forks failing the quick
                    # model-cache probe are parked in pending_worklist and
                    # batch-solved when the ready worklist drains
                    # (strategy/constraint_strategy.py)
                    base = self.strategy
                    while hasattr(base, "super_strategy"):
                        base = base.super_strategy
                    pending = getattr(base, "pending_worklist", None)
                    if pending is not None:
                        from mythril_tpu_torch.support.model import model_cache

                        ready = []
                        for state in new_states:
                            if model_cache.check_quick_sat(
                                state.world_state.constraints
                                .get_all_constraints()
                            ) is not None:
                                ready.append(state)
                            else:
                                pending.append(state)
                        new_states = ready
            self.manage_cfg(op_code, new_states)
            if new_states:
                self.work_list.extend(new_states)
            elif track_gas:
                final_states.append(global_state)
            self.total_states += len(new_states)
        self._fire("stop_exec")
        return final_states if track_gas else None

    def execute_state(
        self, global_state: GlobalState
    ) -> Tuple[List[GlobalState], Optional[str]]:
        # plugin state hooks may skip the state
        try:
            for hook in self._hooks["execute_state"]:
                hook(global_state)
        except PluginSkipState:
            return [], None

        instr = global_state.instruction
        if instr is None:
            # pc beyond code end: implicit STOP (reference harvests :420)
            return self._implicit_stop(global_state)
        op_name = instr.opcode

        # stack arity pre-check
        from mythril_tpu_torch.support.opcodes import BY_NAME

        spec = BY_NAME.get(op_name)
        if spec is not None and len(global_state.mstate.stack) < spec.pops:
            log.debug(
                "stack underflow executing %s at pc %d",
                op_name, global_state.mstate.pc,
            )
            return self.handle_vm_exception(
                global_state, op_name, "stack underflow"
            )

        self._record_state(global_state, instr)

        try:
            for hook in self.pre_hooks[op_name]:
                hook(global_state)
            for hook in self.instr_pre_hook[op_name]:
                hook(global_state)
        except PluginSkipState:
            # a pruner (e.g. dependency_pruner) vetoed this state
            return [], None

        # per-opcode wall histogram of the per-state path (stats JSON
        # interp_opcode_wall): the handler only, hooks and snapshots are
        # engine overhead, not opcode cost
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        stats = SolverStatistics()
        op_start = time.monotonic() if stats.enabled else 0.0
        op_solver_before = stats.solver_time
        try:
            try:
                new_states = instructions.execute(global_state, instr)
            except VmException as error:
                # exceptional halt: the frame reverts
                transaction, return_snapshot = \
                    global_state.transaction_stack[-1]
                self._fire_transaction_end_hooks(
                    global_state, transaction, return_snapshot, True
                )
                new_states = self.handle_vm_exception(
                    global_state, op_name, str(error)
                )[0]
            except TransactionStartSignal as signal:
                new_states = self._start_inner_transaction(
                    global_state, signal)
                return new_states, op_name
            except TransactionEndSignal as signal:
                new_states = self._end_transaction(
                    global_state, signal, op_name)
        finally:
            if stats.enabled:
                # solver seconds inside the handler (concretization,
                # tx-end confirmations) are solver cost, not opcode cost
                stats.add_interp_opcode_wall(
                    op_name, max(0.0, (time.monotonic() - op_start)
                                 - (stats.solver_time - op_solver_before)))

        kept = []
        for state in new_states:
            try:
                for hook in self.post_hooks[op_name]:
                    hook(state)
                for hook in self.instr_post_hook[op_name]:
                    hook(state)
                kept.append(state)
            except PluginSkipState:
                continue
        return kept, op_name

    def _implicit_stop(self, global_state):
        transaction = global_state.current_transaction
        try:
            transaction.end(global_state, return_data=None, revert=False)
        except TransactionEndSignal as signal:
            return self._end_transaction(global_state, signal, "STOP"), "STOP"

    # -- transaction frame handling -----------------------------------------

    def _start_inner_transaction(
        self, global_state: GlobalState, signal: TransactionStartSignal
    ) -> List[GlobalState]:
        # snapshot the caller for resumption (args already popped, pc at op)
        return_snapshot = signal.global_state.clone()
        new_global_state = signal.transaction.initial_global_state()
        new_global_state.transaction_stack = list(
            signal.global_state.transaction_stack
        ) + [(signal.transaction, return_snapshot)]
        new_global_state.node = global_state.node
        new_global_state.world_state.constraints = (
            signal.global_state.world_state.constraints
        )
        new_global_state.transient_storage = signal.global_state.transient_storage
        # an inner call executes in the SAME block as its caller
        new_global_state.environment.block_number = (
            signal.global_state.environment.block_number
        )
        self._fire("transaction_start", signal.transaction, new_global_state)
        return [new_global_state]

    def _end_transaction(
        self, global_state: GlobalState, signal: TransactionEndSignal, op_name: str
    ) -> List[GlobalState]:
        transaction, return_snapshot = signal.global_state.transaction_stack[-1]
        self._fire_transaction_end_hooks(
            signal.global_state, transaction, return_snapshot, signal.revert
        )
        if return_snapshot is None:
            # top-level transaction complete
            if isinstance(transaction, ContractCreationTransaction):
                self._finalize_creation(transaction, signal)
            keep = (
                not isinstance(transaction, ContractCreationTransaction)
                or transaction.return_data is not None
            ) and not signal.revert
            if keep:
                from mythril_tpu_torch.analysis.potential_issues import (
                    check_potential_issues,
                )

                check_potential_issues(signal.global_state)
                signal.global_state.world_state.node = global_state.node
                self._add_world_state(signal.global_state)
            return []

        # inner frame: resume the caller
        for hook in self.post_hooks[op_name]:
            hook(signal.global_state)
        caller_state = return_snapshot.clone()
        # propagate persist_over_calls annotations
        for annotation in signal.global_state.annotations:
            if getattr(annotation, "persist_over_calls", False):
                caller_state.annotations.append(annotation)
        return self._end_message_call(
            caller_state, signal.global_state, transaction, signal.revert
        )

    def _finalize_creation(self, transaction, signal):
        """Install returned runtime bytecode (reference models :283-290)."""
        from mythril_tpu_torch.disasm import Disassembly
        from mythril_tpu_torch.laser.instructions import concrete_or_none

        return_data = transaction.return_data
        if signal.revert or return_data is None:
            return
        raw = []
        symbolic = False
        for byte in return_data.return_data:
            value = byte if isinstance(byte, int) else concrete_or_none(byte)
            if value is None:
                # deploy-time-patched byte (solidity immutable): keep the
                # symbolic expression in the installed code (reference
                # transaction_models.py:283-290 assigns the raw tuple)
                raw.append(byte)
                symbolic = True
            else:
                raw.append(value)
        code = tuple(raw) if symbolic else bytes(raw)
        transaction.callee_account.code = Disassembly(code)

    def _end_message_call(
        self,
        caller_state: GlobalState,
        ended_state: GlobalState,
        transaction,
        revert: bool,
    ) -> List[GlobalState]:
        from mythril_tpu_torch.laser.call_ops import CallReturnContext, _write_return_data
        from mythril_tpu_torch.laser.instructions import bv

        caller_state.world_state.constraints += (
            ended_state.world_state.constraints
        )
        caller_state.last_return_data = transaction.return_data
        if not revert:
            # adopt the callee's final world state and transient storage
            # (EIP-1153: TSTOREs survive successful frame returns)
            new_world = ended_state.world_state
            caller_state.world_state = new_world
            caller_state.transient_storage = ended_state.transient_storage
            addr = caller_state.environment.active_account.address
            if not addr.symbolic and addr.concrete_value in new_world.accounts:
                caller_state.environment.active_account = new_world.accounts[
                    addr.concrete_value
                ]
            if isinstance(transaction, ContractCreationTransaction):
                self._finalize_creation_inner(transaction, ended_state)
                caller_state.mstate.min_gas_used += ended_state.mstate.min_gas_used
                caller_state.mstate.max_gas_used += ended_state.mstate.max_gas_used

        context: CallReturnContext = getattr(transaction, "return_context", None)
        if context is not None and not revert and transaction.return_data is not None:
            _write_return_data(
                caller_state,
                transaction.return_data.return_data,
                context.memory_out_offset,
                context.memory_out_size,
            )
        if isinstance(transaction, ContractCreationTransaction):
            caller_state.mstate.stack.append(
                bv(0) if revert else transaction.callee_account.address
            )
        else:
            caller_state.mstate.stack.append(bv(0) if revert else bv(1))
        caller_state.mstate.pc += 1
        caller_state.node = ended_state.node
        return [caller_state]

    def _finalize_creation_inner(self, transaction, ended_state):
        from mythril_tpu_torch.disasm import Disassembly
        from mythril_tpu_torch.laser.instructions import concrete_or_none

        return_data = transaction.return_data
        if return_data is None:
            return
        raw = bytearray()
        for byte in return_data.return_data:
            value = byte if isinstance(byte, int) else concrete_or_none(byte)
            if value is None:
                return
            raw.append(value)
        transaction.callee_account.code = Disassembly(bytes(raw))

    def _fire_transaction_end_hooks(self, global_state, transaction,
                                    return_snapshot, revert):
        for hook in self._hooks["transaction_end"]:
            hook(global_state, transaction, return_snapshot, revert)

    def _add_world_state(self, global_state: GlobalState):
        try:
            for hook in self._hooks["add_world_state"]:
                hook(global_state)
        except (PluginSkipWorldState, PluginSkipState):
            return
        # persist_to_world_state annotations move to the world state
        for annotation in global_state.annotations:
            if getattr(annotation, "persist_to_world_state", False):
                if annotation not in global_state.world_state.annotations:
                    global_state.world_state.annotate(annotation)
        self.open_states.append(global_state.world_state)

    def handle_vm_exception(
        self, global_state: GlobalState, op_code: str, error_msg: str
    ) -> Tuple[List[GlobalState], str]:
        """A VmException reverts the current frame (reference svm.py)."""
        transaction, return_snapshot = global_state.transaction_stack[-1]
        log.debug("VmException %s at pc %d: %s", op_code,
                  global_state.mstate.pc, error_msg)
        if return_snapshot is None:
            return [], op_code
        caller_state = return_snapshot.clone()
        transaction.return_data = None
        states = self._end_message_call(
            caller_state, global_state, transaction, revert=True
        )
        return states, op_code

    # -- CFG / statespace ----------------------------------------------------

    def new_node(self, transaction, constraints) -> Node:
        contract_name = getattr(
            getattr(transaction, "callee_account", None), "contract_name", "?"
        )
        node = Node(
            contract_name=contract_name,
            constraints=constraints,
            function_name=(
                "constructor"
                if isinstance(transaction, ContractCreationTransaction)
                else "fallback"
            ),
        )
        self.nodes[node.uid] = node
        return node

    def _record_state(self, global_state: GlobalState, instr):
        if not self.requires_statespace:
            return
        node = global_state.node
        if node is None:
            return
        node.states.append(_StateSnapshot(global_state, instr))

    def manage_cfg(self, op_code: Optional[str], new_states: List[GlobalState]):
        # NOT gated on requires_statespace: function-entry naming rides the
        # CFG nodes, so they must exist even when states aren't recorded
        # (reference svm.py:581 builds nodes unconditionally; only state
        # recording inside nodes is statespace-gated)
        if op_code is None:
            return
        if op_code in ("JUMP", "JUMPI"):
            for state in new_states:
                self._new_node_for_state(
                    state,
                    JumpType.UNCONDITIONAL if op_code == "JUMP" else JumpType.CONDITIONAL,
                    condition=(
                        state.world_state.constraints[-1]
                        if op_code == "JUMPI" and state.world_state.constraints
                        else None
                    ),
                )
        elif op_code in ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL",
                         "CREATE", "CREATE2"):
            for state in new_states:
                self._new_node_for_state(state, JumpType.CALL)
        elif op_code in ("RETURN", "STOP", "REVERT", "SELFDESTRUCT"):
            for state in new_states:
                self._new_node_for_state(state, JumpType.RETURN)

    def _new_node_for_state(self, state: GlobalState, edge_type, condition=None):
        old_node = state.node
        new_node = Node(
            contract_name=old_node.contract_name if old_node else "?",
            start_addr=state.mstate.pc,
            constraints=state.world_state.constraints,
            function_name=old_node.function_name if old_node else "unknown",
        )
        self.nodes[new_node.uid] = new_node
        state.node = new_node
        if old_node is not None:
            self.edges.append(
                Edge(old_node.uid, new_node.uid, edge_type, condition)
            )
        # function-entry naming from the dispatcher
        entry_name = state.environment.code.function_name_for_pc(state.mstate.pc)
        if entry_name:
            new_node.function_name = entry_name
            new_node.flags |= NodeFlags.FUNC_ENTRY
            state.environment.active_function_name = entry_name


class _StateSnapshot:
    """Lightweight per-instruction record for POST modules and dumps.

    Captures the mutable scalars (stack copy, pc, constraints copy) and
    shares the heavyweight structures — same fidelity tradeoff the
    reference makes by storing shallow per-instruction copies."""

    __slots__ = ("world_state", "environment", "mstate_stack", "pc",
                 "instruction", "transaction", "constraints", "node",
                 "annotations")

    def __init__(self, global_state: GlobalState, instr):
        self.world_state = global_state.world_state
        self.environment = global_state.environment
        self.mstate_stack = list(global_state.mstate.stack)
        self.pc = global_state.mstate.pc
        self.instruction = instr
        self.transaction = global_state.current_transaction
        self.constraints = global_state.world_state.constraints.copy()
        self.node = global_state.node
        self.annotations = global_state.annotations

    def get_current_instruction(self):
        return self.instruction
