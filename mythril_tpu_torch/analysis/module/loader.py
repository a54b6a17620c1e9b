"""ModuleLoader singleton registering the built-in detection modules
(reference analysis/module/loader.py:91-112)."""

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class ModuleLoader:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._modules = []
            cls._instance._register_mythril_modules()
        return cls._instance

    def register_module(self, module: DetectionModule):
        if not isinstance(module, DetectionModule):
            raise ValueError("registered modules must extend DetectionModule")
        self._modules.append(module)

    def get_detection_modules(
        self,
        entry_point: Optional[EntryPoint] = None,
        white_list: Optional[List[str]] = None,
        reachable_opcodes: Optional[frozenset] = None,
    ) -> List[DetectionModule]:
        """`reachable_opcodes`, when given (preanalysis.gating_opcodes —
        None means "no static information", gate nothing), statically
        gates CALLBACK modules: a module whose trigger opcodes are all
        unreachable in the analyzed bytecode can never fire a hook, so it
        is not attached at all — no hooks, no predicate solves, no solver
        traffic. Every gate is counted (`modules_gated`); POST modules
        always run (they read the statespace, not opcode hooks)."""
        result = self._modules[:]
        if white_list:
            # accept both the reference's class names (`-m Exceptions`,
            # reference loader.py:65-79) and our internal snake_case names
            def names_of(module):
                return {module.name, type(module).__name__}

            available = set().union(*(names_of(m) for m in result))
            unknown = set(white_list) - available
            if unknown:
                raise ValueError(
                    f"unknown detection module(s): {', '.join(sorted(unknown))}"
                )
            wanted = set(white_list)
            result = [m for m in result if names_of(m) & wanted]
        if entry_point:
            result = [m for m in result if m.entry_point == entry_point]
        if reachable_opcodes is not None:
            result = self._gate_unreachable(result, reachable_opcodes)
        return result

    @staticmethod
    def _gate_unreachable(modules: List[DetectionModule],
                          reachable_opcodes: frozenset
                          ) -> List[DetectionModule]:
        from mythril_tpu_torch.analysis.module.util import module_trigger_opcodes
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        kept = []
        stats = SolverStatistics()
        for module in modules:
            if module.entry_point == EntryPoint.CALLBACK:
                triggers = module_trigger_opcodes(module)
                if triggers and not (triggers & reachable_opcodes):
                    stats.add_module_gated()
                    log.info(
                        "preanalysis: gating module %s (trigger opcodes "
                        "%s statically unreachable)",
                        module.name, ",".join(sorted(triggers)))
                    continue
            kept.append(module)
        return kept

    def _register_mythril_modules(self):
        from mythril_tpu_torch.analysis.module.modules.arbitrary_jump import ArbitraryJump
        from mythril_tpu_torch.analysis.module.modules.arbitrary_write import (
            ArbitraryStorage,
        )
        from mythril_tpu_torch.analysis.module.modules.delegatecall import (
            ArbitraryDelegateCall,
        )
        from mythril_tpu_torch.analysis.module.modules.dependence_on_origin import TxOrigin
        from mythril_tpu_torch.analysis.module.modules.dependence_on_predictable_vars import (
            PredictableVariables,
        )
        from mythril_tpu_torch.analysis.module.modules.ether_thief import EtherThief
        from mythril_tpu_torch.analysis.module.modules.exceptions import Exceptions
        from mythril_tpu_torch.analysis.module.modules.external_calls import ExternalCalls
        from mythril_tpu_torch.analysis.module.modules.integer import IntegerArithmetics
        from mythril_tpu_torch.analysis.module.modules.multiple_sends import MultipleSends
        from mythril_tpu_torch.analysis.module.modules.requirements_violation import (
            RequirementsViolation,
        )
        from mythril_tpu_torch.analysis.module.modules.state_change_external_calls import (
            StateChangeAfterCall,
        )
        from mythril_tpu_torch.analysis.module.modules.suicide import AccidentallyKillable
        from mythril_tpu_torch.analysis.module.modules.transaction_order_dependence import (
            TxOrderDependence,
        )
        from mythril_tpu_torch.analysis.module.modules.unchecked_retval import (
            UncheckedRetval,
        )
        from mythril_tpu_torch.analysis.module.modules.unexpected_ether import (
            UnexpectedEther,
        )
        from mythril_tpu_torch.analysis.module.modules.user_assertions import (
            UserAssertions,
        )

        self._modules = [
            ArbitraryJump(),
            ArbitraryStorage(),
            ArbitraryDelegateCall(),
            TxOrigin(),
            PredictableVariables(),
            EtherThief(),
            Exceptions(),
            ExternalCalls(),
            IntegerArithmetics(),
            MultipleSends(),
            RequirementsViolation(),
            StateChangeAfterCall(),
            AccidentallyKillable(),
            TxOrderDependence(),
            UncheckedRetval(),
            UnexpectedEther(),
            UserAssertions(),
        ]
