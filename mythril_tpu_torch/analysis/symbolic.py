"""SymExecWrapper — builds/configures the engine for one contract
(reference analysis/symbolic.py:334)."""

import copy
import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module import (
    EntryPoint,
    ModuleLoader,
    get_detection_module_hooks,
)
from mythril_tpu_torch.analysis.ops import Call, get_call_from_state, get_variable
from mythril_tpu_torch.laser.strategy.basic import (
    BreadthFirstSearchStrategy,
    DepthFirstSearchStrategy,
    ReturnRandomNaivelyStrategy,
    ReturnWeightedRandomStrategy,
)
from mythril_tpu_torch.laser.strategy.extensions.bounded_loops import (
    BoundedLoopsStrategy,
)
from mythril_tpu_torch.laser.svm import LaserEVM
from mythril_tpu_torch.laser.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.support.args import args

log = logging.getLogger(__name__)


class SymExecWrapper:
    def __init__(
        self,
        contract,
        address,
        strategy: str = "bfs",
        dynloader=None,
        max_depth: int = 128,
        execution_timeout: Optional[int] = None,
        loop_bound: int = 3,
        create_timeout: Optional[int] = None,
        transaction_count: int = 2,
        modules: Optional[List[str]] = None,
        compulsory_statespace: bool = True,
        disable_dependency_pruning: bool = False,
        run_analysis_modules: bool = True,
        custom_modules_directory: str = "",
    ):
        if isinstance(address, str):
            address = symbol_factory.BitVecVal(int(address, 16), 256)
        elif isinstance(address, int):
            address = symbol_factory.BitVecVal(address, 256)

        from mythril_tpu_torch.laser.strategy.beam import BeamSearch
        from mythril_tpu_torch.laser.strategy.constraint_strategy import (
            DelayConstraintStrategy,
        )

        strategies = {
            "dfs": DepthFirstSearchStrategy,
            "bfs": BreadthFirstSearchStrategy,
            "naive-random": ReturnRandomNaivelyStrategy,
            "weighted-random": ReturnWeightedRandomStrategy,
            "beam-search": BeamSearch,
            "pending": DelayConstraintStrategy,
        }
        try:
            strategy_class = strategies[strategy]
        except KeyError:
            raise ValueError(f"invalid search strategy {strategy!r}")

        requires_statespace = compulsory_statespace or (
            run_analysis_modules
            and len(
                ModuleLoader().get_detection_modules(EntryPoint.POST, modules)
            )
            > 0
        )

        # static bytecode pre-analysis (mythril_tpu_torch/preanalysis/): one CFG
        # + effect-summary pass per contract before LASER starts. The
        # summary feeds the engine/strategies as effect hints; the
        # reachable-opcode set (non-None ONLY when gating is sound:
        # runtime-mode code, no dynloader, resolved CFG, no CREATE) gates
        # detection-module attachment below.
        from mythril_tpu_torch import preanalysis

        self.preanalysis = None
        gating = None
        if preanalysis.enabled():
            try:
                code_object = (
                    contract.creation_disassembly
                    if contract.creation_code is not None
                    and contract.is_create_mode
                    else contract.disassembly
                )
            except AttributeError:
                code_object = None
            self.preanalysis = preanalysis.get_code_summary(code_object)
            gating = preanalysis.gating_opcodes(contract, dynloader)

        # batched frontier (laser/frontier/): on for analysis runs unless
        # gated off, but never when a full per-instruction statespace was
        # compulsorily requested (--statespace-json / graph dumps expect
        # interior snapshots of straight-line runs, which batched steps
        # elide; the default analyze statespace only feeds POST modules,
        # which key on fork/call/return snapshots runs never contain)
        from mythril_tpu_torch.laser import frontier

        self.laser = LaserEVM(
            dynamic_loader=dynloader,
            max_depth=max_depth,
            execution_timeout=execution_timeout,
            create_timeout=create_timeout,
            strategy=strategy_class,
            transaction_count=transaction_count,
            requires_statespace=requires_statespace,
            beam_width=(getattr(args, "beam_width", None)
                        if strategy == "beam-search" else None),
            preanalysis=self.preanalysis,
            vmap_frontier=frontier.enabled() and not compulsory_statespace,
        )
        self.laser.extend_strategy(BoundedLoopsStrategy, loop_bound=loop_bound)

        if not args.incremental_txs:
            from mythril_tpu_torch.laser.tx_prioritiser import RfTxPrioritiser

            self.laser.tx_prioritiser = RfTxPrioritiser(
                contract, model_path=getattr(args, "rf_model_path", None)
            )

        # engine plugins (pruners/coverage/etc.) are registered here
        from mythril_tpu_torch.laser.plugin.loader import LaserPluginLoader
        from mythril_tpu_torch.laser.plugin.plugins import (
            CoveragePluginBuilder,
            DependencyPrunerBuilder,
            InstructionProfilerBuilder,
            MutationPrunerBuilder,
        )

        plugin_loader = LaserPluginLoader()
        plugin_loader.reset()
        plugin_loader.load(CoveragePluginBuilder())
        if not args.disable_mutation_pruner:
            plugin_loader.load(MutationPrunerBuilder())
        if not disable_dependency_pruning and not args.disable_dependency_pruning:
            plugin_loader.load(DependencyPrunerBuilder())
        if not args.disable_iprof:
            plugin_loader.load(InstructionProfilerBuilder())
        if args.enable_state_merging:
            from mythril_tpu_torch.laser.plugin.plugins import (
                StateMergePluginBuilder,
            )

            plugin_loader.load(StateMergePluginBuilder())
        if args.enable_summaries:
            from mythril_tpu_torch.laser.plugin.plugins.summary import (
                SymbolicSummaryPluginBuilder,
            )

            plugin_loader.load(SymbolicSummaryPluginBuilder())
        plugin_loader.instrument_virtual_machine(self.laser)

        if not args.disable_coverage_strategy:
            from mythril_tpu_torch.laser.plugin.plugins.coverage import (
                CoverageStrategy,
            )

            coverage_plugin = plugin_loader.plugin_list.get("coverage")
            if coverage_plugin is not None:
                self.laser.extend_strategy(
                    CoverageStrategy, coverage_plugin=coverage_plugin
                )

        if run_analysis_modules:
            analysis_modules = ModuleLoader().get_detection_modules(
                EntryPoint.CALLBACK, white_list=modules,
                reachable_opcodes=gating,
            )
            self.laser.register_hooks(
                hook_type="pre",
                hook_dict=get_detection_module_hooks(
                    analysis_modules, hook_type="pre"
                ),
            )
            self.laser.register_hooks(
                hook_type="post",
                hook_dict=get_detection_module_hooks(
                    analysis_modules, hook_type="post"
                ),
            )

        # run symbolic execution
        if contract.creation_code is not None and contract.is_create_mode:
            self.laser.sym_exec(
                creation_code=contract.creation_code,
                contract_name=contract.name,
            )
        else:
            from mythril_tpu_torch.laser.state.world_state import WorldState
            from mythril_tpu_torch.disasm import Disassembly

            world_state = WorldState()
            account = world_state.create_account(
                balance=0,
                address=address.concrete_value,
                dynamic_loader=dynloader,
                concrete_storage=False,
                code=contract.disassembly,
            )
            account.contract_name = contract.name
            self.laser.sym_exec(
                world_state=world_state, target_address=address.concrete_value
            )

        # expose the statespace for POST modules and dumps
        self.nodes = self.laser.nodes
        self.edges = self.laser.edges
        self.tx_id_to_address = {}

    @property
    def calls(self) -> List[Call]:
        """Extract Call records from the statespace (reference :250-330)."""
        out = []
        for node in self.nodes.values():
            for index, state in enumerate(node.states):
                instruction = state.get_current_instruction()
                if instruction is None:
                    continue
                if instruction.opcode in (
                    "CALL", "CALLCODE", "DELEGATECALL", "STATICCALL"
                ):
                    call = get_call_from_state(state, node, index)
                    if call is not None:
                        out.append(call)
        return out
