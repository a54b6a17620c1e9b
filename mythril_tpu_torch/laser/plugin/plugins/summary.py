"""Symbolic summaries — record a transaction's parametric effect once,
replay it on later transactions by substitution
(reference laser/plugin/plugins/summary/, 629 LoC; off by default,
`--enable-summaries`).

Mechanism:
* entry (pc==0 of an outermost symbolic message call) — storage arrays,
  the balance array, and the environment symbols (sender/origin/
  callvalue/gasprice/calldata) are swapped for fresh "summary" symbols,
  so the transaction executes parametrically;
* exit (transaction_end) — the accumulated storage/balance expressions,
  the constraints appended during the tx, and any IssueAnnotations are
  recorded as a SymbolicSummary keyed by (entry pc, code); then every
  summary symbol is substituted back to the caller's actual expressions
  so normal exploration continues unchanged;
* apply (a later tx reaches the same entry with summaries available) —
  each summary's effects are substituted into the current world state
  (actual storage/balances in, fresh per-application tx symbols for the
  environment) and pushed as open states; recorded issues are re-solved
  in the new context; the normal execution of the tx is skipped
  (PluginSkipState).

The term-DAG substitution (smt/terms.py substitute) is the engine that
makes replay cheap: no re-execution, just expression rewriting.
"""

import logging
from copy import copy
from typing import List, Optional, Set, Tuple

from mythril_tpu_torch.analysis.issue_annotation import IssueAnnotation
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.laser.plugin.plugins.mutation_pruner import MutationAnnotation
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState
from mythril_tpu_torch.laser.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.state.calldata import SymbolicCalldata
from mythril_tpu_torch.laser.state.environment import Environment
from mythril_tpu_torch.laser.transaction.models import (
    ContractCreationTransaction,
    MessageCallTransaction,
)
from mythril_tpu_torch.smt import Array, symbol_factory
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError
from mythril_tpu_torch.support.args import args

log = logging.getLogger(__name__)


class SummaryTrackingAnnotation(StateAnnotation):
    """Tracks one in-progress summary recording."""

    def __init__(self, entry_pc, storage_pairs, environment_pair,
                 balances_pair, code, constraint_mark):
        self.entry_pc = entry_pc
        self.storage_pairs = storage_pairs  # (addr, actual, summary) wrappers
        self.environment_pair = environment_pair  # (original, summary)
        self.balances_pair = balances_pair  # (original, summary)
        self.code = code
        self.constraint_mark = constraint_mark

    @property
    def persist_over_calls(self) -> bool:
        return True

    def clone(self):
        # immutable record (raw terms + entry references): share across
        # forks instead of deep-copying entire environments per fork
        return self


class SymbolicSummary:
    __slots__ = ("entry", "code", "storage_effect", "balance_effect",
                 "conditions", "issues", "revert", "symbols")

    def __init__(self, entry, code, storage_effect, balance_effect,
                 conditions, issues, revert, symbols):
        self.entry = entry
        self.code = code
        self.storage_effect = storage_effect  # [(addr, raw array term)]
        self.balance_effect = balance_effect  # raw array term
        self.conditions = conditions          # [raw bool terms]
        self.issues = issues                  # [IssueAnnotation]
        self.revert = revert
        # the summary symbols to re-bind on application:
        # {"sender": term, "origin": ..., "callvalue": ..., "gasprice": ...,
        #  "calldata": term, "calldatasize": term,
        #  "storage": {addr: term}, "balances": term}
        self.symbols = symbols


def _raw(expression):
    return expression.raw if hasattr(expression, "raw") else expression


class SymbolicSummaryPlugin(LaserPlugin):
    name = "summaries"

    def __init__(self):
        self.summaries: List[SymbolicSummary] = []
        self.issue_cache: Set[Tuple[str, int, bytes]] = set()
        self._apply_counter = 0
        args.use_issue_annotations = True

    def initialize(self, symbolic_vm) -> None:
        self.laser = symbolic_vm

        def execute_state_hook(global_state):
            if (global_state.mstate.pc != 0
                    or len(global_state.transaction_stack) != 1):
                return
            transaction = global_state.current_transaction
            if isinstance(transaction, ContractCreationTransaction):
                return
            if not isinstance(global_state.environment.calldata,
                              SymbolicCalldata):
                return
            if list(global_state.get_annotations(SummaryTrackingAnnotation)):
                return
            self._apply_summaries(global_state)
            self._summary_entry(global_state)

        def transaction_end_hook(global_state, transaction,
                                 return_global_state, revert):
            if return_global_state is not None:
                return  # inner frame
            annotations = list(
                global_state.get_annotations(SummaryTrackingAnnotation))
            if not annotations:
                return
            # reverted paths are discarded by the engine; only record them
            # when an inner frame already proved an issue (reference
            # core.py transaction_end gate) — promoting potential issues
            # on a rolled-back path would be a false-positive source
            if revert and not list(
                    global_state.get_annotations(IssueAnnotation)):
                return
            from mythril_tpu_torch.analysis.potential_issues import (
                check_potential_issues,
            )

            # promote potential issues NOW so IssueAnnotations are attached
            # while the state is still expressed over summary symbols
            if not revert:
                check_potential_issues(global_state)
            self._summary_exit(global_state, annotations[0], revert)

        def stop_sym_exec_hook():
            log.info("generated %d symbolic summaries", len(self.summaries))

        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)
        symbolic_vm.register_laser_hooks("transaction_end",
                                        transaction_end_hook)
        symbolic_vm.register_laser_hooks("stop_sym_exec", stop_sym_exec_hook)

    # -- recording ---------------------------------------------------------

    def _summary_entry(self, global_state) -> None:
        world_state = global_state.world_state
        n = len(world_state.transaction_sequence)
        # capture RAW terms (immutable), not wrappers: array wrappers are
        # mutated in place by later stores on the shared state object
        storage_pairs = []
        for addr, account in world_state.accounts.items():
            actual_raw = _raw(account.storage._array)
            fresh = Array(f"sum!storage!{addr}!{n}", 256, 256)
            fresh_raw = _raw(fresh)
            account.storage._array = fresh
            storage_pairs.append((addr, actual_raw, fresh_raw))
        prev_balances_raw = _raw(world_state.balances)
        fresh_balances = Array(f"sum!balance!{n}", 256, 256)
        fresh_balances_raw = _raw(fresh_balances)
        world_state.balances = fresh_balances
        for account in world_state.accounts.values():
            account.set_balance_array(fresh_balances)

        prev_env = global_state.environment
        summary_env = Environment(
            active_account=prev_env.active_account,
            sender=symbol_factory.BitVecSym(f"sum!sender!{n}", 256),
            origin=symbol_factory.BitVecSym(f"sum!origin!{n}", 256),
            calldata=SymbolicCalldata(f"sum!{n}"),
            gasprice=symbol_factory.BitVecSym(f"sum!gasprice!{n}", 256),
            callvalue=symbol_factory.BitVecSym(f"sum!callvalue!{n}", 256),
            static=prev_env.static,
            code=prev_env.code,
            basefee=prev_env.basefee,
        )
        summary_env.active_function_name = prev_env.active_function_name
        global_state.environment = summary_env

        global_state.annotate(SummaryTrackingAnnotation(
            entry_pc=global_state.mstate.pc,
            storage_pairs=storage_pairs,
            environment_pair=(prev_env, summary_env),
            balances_pair=(prev_balances_raw, fresh_balances_raw),
            code=prev_env.code.bytecode,
            constraint_mark=len(world_state.constraints),
        ))

    def _summary_exit(self, global_state, annotation, revert) -> None:
        global_state.annotations.remove(annotation)
        recorded = self._record(global_state, annotation, revert)

        # restore: summary symbols -> the caller's actual expressions
        mapping = {}
        for addr, actual_raw, fresh_raw in annotation.storage_pairs:
            mapping[fresh_raw] = actual_raw
        original_balances_raw, summary_balances_raw = annotation.balances_pair
        mapping[summary_balances_raw] = original_balances_raw
        env_original, env_summary = annotation.environment_pair
        for field in ("sender", "origin", "callvalue", "gasprice"):
            mapping[_raw(getattr(env_summary, field))] = \
                _raw(getattr(env_original, field))
        mapping[_raw(env_summary.calldata._array)] = \
            _raw(self._calldata_array(env_original.calldata))
        mapping[_raw(env_summary.calldata.calldatasize)] = \
            _raw(env_original.calldata.calldatasize)

        self._substitute_state(global_state, mapping)
        global_state.environment = env_original

        # report this transaction's own findings in the ACTUAL (restored)
        # context — the recorded conditions are parametric; solving them
        # against the caller's real storage/balances avoids the
        # unconstrained-state false positives direct reporting would give
        if recorded is not None and recorded.issues:
            self._check_issues(global_state, recorded, mapping)

    def _record(self, global_state, annotation,
                revert) -> Optional[SymbolicSummary]:
        has_mutation = bool(
            list(global_state.get_annotations(MutationAnnotation)))
        issues = [copy(a) for a
                  in global_state.get_annotations(IssueAnnotation)]
        if not has_mutation and not issues:
            return None
        world_state = global_state.world_state
        env_summary = annotation.environment_pair[1]
        symbols = {
            "sender": _raw(env_summary.sender),
            "origin": _raw(env_summary.origin),
            "callvalue": _raw(env_summary.callvalue),
            "gasprice": _raw(env_summary.gasprice),
            "calldata": _raw(env_summary.calldata._array),
            "calldatasize": _raw(env_summary.calldata.calldatasize),
            "storage": {addr: fresh_raw
                        for addr, _a, fresh_raw in annotation.storage_pairs},
            "balances": annotation.balances_pair[1],
        }
        summary = SymbolicSummary(
            entry=annotation.entry_pc,
            code=annotation.code,
            storage_effect=[
                (addr, _raw(account.storage._array))
                for addr, account in world_state.accounts.items()
            ],
            balance_effect=_raw(world_state.balances),
            conditions=[
                _raw(c) for c in
                list(world_state.constraints)[annotation.constraint_mark:]
            ],
            issues=issues,
            revert=revert,
            symbols=symbols,
        )
        self.summaries.append(summary)
        return summary

    # -- replay ------------------------------------------------------------

    def _apply_summaries(self, global_state) -> None:
        entry = global_state.mstate.pc
        code = global_state.environment.code.bytecode
        matching = [
            s for s in self.summaries
            if s.entry == entry and s.code == code and not s.revert
            and s.storage_effect
        ]
        if not matching:
            return
        applied = 0
        for summary in matching:
            applied += self._apply_one(global_state, summary)
        if applied:
            raise PluginSkipState
        log.debug("no summary applied at pc %d; executing normally", entry)

    def _application_mapping(self, global_state, summary, tag: str):
        """summary symbols -> current context (actual storage/balances,
        fresh per-application environment symbols)."""
        world_state = global_state.world_state
        from mythril_tpu_torch.smt import Bool  # noqa: F401 (doc import)

        mapping = {}
        for addr, sum_storage in summary.symbols["storage"].items():
            account = world_state.accounts.get(addr)
            if account is None:
                return None  # summary mentions an account we don't have
            mapping[sum_storage] = _raw(account.storage._array)
        mapping[summary.symbols["balances"]] = _raw(world_state.balances)
        for field, size in (("sender", 256), ("origin", 256),
                            ("callvalue", 256), ("gasprice", 256)):
            mapping[summary.symbols[field]] = _raw(
                symbol_factory.BitVecSym(f"sumapp!{field}!{tag}", size))
        fresh_calldata = SymbolicCalldata(f"sumapp!{tag}")
        mapping[summary.symbols["calldata"]] = _raw(fresh_calldata._array)
        mapping[summary.symbols["calldatasize"]] = _raw(
            fresh_calldata.calldatasize)
        return mapping, fresh_calldata

    def _apply_one(self, global_state, summary) -> bool:
        self._apply_counter += 1
        tag = str(self._apply_counter)
        prepared = self._application_mapping(global_state, summary, tag)
        if prepared is None:
            return False
        mapping, fresh_calldata = prepared
        new_state = global_state.clone()
        world_state = new_state.world_state

        roots = ([term for _addr, term in summary.storage_effect]
                 + [summary.balance_effect] + summary.conditions)
        substituted = terms.substitute(roots, mapping)
        storage_terms = substituted[: len(summary.storage_effect)]
        balance_term = substituted[len(summary.storage_effect)]
        condition_terms = substituted[len(summary.storage_effect) + 1:]

        from mythril_tpu_torch.smt.array_expr import BaseArray
        from mythril_tpu_torch.smt.bool_expr import Bool

        for (addr, _), new_term in zip(summary.storage_effect,
                                       storage_terms):
            account = world_state.accounts.get(addr)
            if account is None:
                continue
            wrapper = BaseArray.__new__(type(account.storage._array))
            wrapper.raw = new_term
            wrapper.annotations = set()
            account.storage._array = wrapper
        balances = BaseArray.__new__(type(world_state.balances))
        balances.raw = balance_term
        balances.annotations = set()
        world_state.balances = balances
        for account in world_state.accounts.values():
            account.set_balance_array(balances)
        for term in condition_terms:
            world_state.constraints.append(Bool(term, set()))

        # synthesize the tx record so exploit concretization still works
        transaction = MessageCallTransaction(
            world_state=world_state,
            callee_account=new_state.environment.active_account,
            caller=symbol_factory.BitVecSym(f"sumapp!sender!{tag}", 256),
            call_data=fresh_calldata,
            origin=symbol_factory.BitVecSym(f"sumapp!origin!{tag}", 256),
            call_value=symbol_factory.BitVecSym(f"sumapp!callvalue!{tag}",
                                                256),
        )
        world_state.transaction_sequence.append(transaction)

        self._check_issues(new_state, summary, mapping)
        self.laser._add_world_state(new_state)
        return True

    def _check_issues(self, new_state, summary, mapping) -> None:
        from mythril_tpu_torch.analysis.solver import get_transaction_sequence
        from mythril_tpu_torch.laser.state.constraints import Constraints
        from mythril_tpu_torch.smt.bool_expr import Bool

        for issue_annotation in summary.issues:
            key = (issue_annotation.detector.swc_id,
                   issue_annotation.issue.address,
                   summary.code)
            if key in self.issue_cache:
                continue
            condition_raws = terms.substitute(
                [_raw(c) for c in issue_annotation.conditions], mapping)
            constraints = Constraints(
                list(new_state.world_state.constraints))
            for raw in condition_raws:
                constraints.append(Bool(raw, set()))
            try:
                tx_sequence = get_transaction_sequence(
                    new_state, constraints)
            except (UnsatError, SolverTimeOutException):
                continue
            new_issue = copy(issue_annotation.issue)
            new_issue.transaction_sequence = tx_sequence
            issue_annotation.detector.issues.append(new_issue)
            self.issue_cache.add(key)

    # -- restore helpers ---------------------------------------------------

    @staticmethod
    def _calldata_array(calldata):
        if isinstance(calldata, SymbolicCalldata):
            return calldata._array
        # concrete calldata: materialize as a constant array term
        from mythril_tpu_torch.smt import K

        arr = K(256, 8, 0)
        for i, byte in enumerate(getattr(calldata, "concrete_bytes", [])):
            arr[i] = byte
        return arr

    def _substitute_state(self, global_state, mapping) -> None:
        world_state = global_state.world_state
        from mythril_tpu_torch.smt.array_expr import BaseArray
        from mythril_tpu_torch.smt.bool_expr import Bool

        constraint_raws = [_raw(c) for c in world_state.constraints]
        storage_raws = [_raw(a.storage._array)
                        for a in world_state.accounts.values()]
        balance_raw = _raw(world_state.balances)
        substituted = terms.substitute(
            constraint_raws + storage_raws + [balance_raw], mapping)
        n_constraints = len(constraint_raws)
        from mythril_tpu_torch.laser.state.constraints import Constraints

        new_constraints = Constraints()
        for raw in substituted[:n_constraints]:
            new_constraints.append(Bool(raw, set()))
        world_state.constraints = new_constraints
        for account, new_term in zip(world_state.accounts.values(),
                                     substituted[n_constraints:-1]):
            wrapper = BaseArray.__new__(type(account.storage._array))
            wrapper.raw = new_term
            wrapper.annotations = set()
            account.storage._array = wrapper
        balances = BaseArray.__new__(type(world_state.balances))
        balances.raw = substituted[-1]
        balances.annotations = set()
        world_state.balances = balances
        for account in world_state.accounts.values():
            account.set_balance_array(balances)


class SymbolicSummaryPluginBuilder(PluginBuilder):
    name = "summaries"

    def __call__(self, *args, **kwargs):
        return SymbolicSummaryPlugin()
