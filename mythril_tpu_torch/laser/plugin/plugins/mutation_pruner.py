"""Mutation pruner — drop world states whose transaction did not mutate
anything and carried no value (reference laser/plugin/plugins/
mutation_pruner.py:89): such "clean" suffixes cannot enable new behavior."""

import logging

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.laser.plugin.signals import PluginSkipWorldState
from mythril_tpu_torch.laser.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.transaction.models import ContractCreationTransaction
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


class MutationAnnotation(StateAnnotation):
    """Present iff the path performed a state mutation (SSTORE/CALL)."""

    @property
    def persist_over_calls(self) -> bool:
        return True

    def clone(self):
        return self


class MutationPruner(LaserPlugin):
    def initialize(self, symbolic_vm):
        def on_sstore(global_state):
            if not global_state.get_annotations(MutationAnnotation):
                global_state.annotate(MutationAnnotation())

        symbolic_vm.register_hooks(
            "pre",
            {
                "SSTORE": [on_sstore],
                "CALL": [on_sstore],
                "STATICCALL": [on_sstore],
                "CREATE": [on_sstore],
                "CREATE2": [on_sstore],
                "SELFDESTRUCT": [on_sstore],
            },
        )

        def add_world_state_hook(global_state):
            if isinstance(
                global_state.current_transaction, ContractCreationTransaction
            ):
                return
            if global_state.get_annotations(MutationAnnotation):
                return
            # no mutation: world state only matters if value could be forced
            call_value = global_state.current_transaction.call_value
            if call_value is None or not call_value.symbolic:
                if call_value is not None and call_value.concrete_value != 0:
                    return
                raise PluginSkipWorldState
            try:
                get_model(
                    global_state.world_state.constraints.get_all_constraints()
                    + [call_value == 0]
                )
                # value can be zero: the tx is a no-op, drop the world state
                raise PluginSkipWorldState
            except UnsatError:
                return
            except SolverTimeOutException:
                # undecided: keep the world state (conservative)
                return

        symbolic_vm.register_laser_hooks(
            "add_world_state", add_world_state_hook
        )


class MutationPrunerBuilder(PluginBuilder):
    name = "mutation_pruner"

    def __call__(self, *args, **kwargs):
        return MutationPruner()
