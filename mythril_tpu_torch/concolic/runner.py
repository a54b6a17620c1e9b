"""Concolic runner: concrete replay -> symbolic flip pass
(reference mythril/concolic/concolic_execution.py:17-76; CLI entry
`myth concolic input.json --branches 34,57`).

The flip pass prunes its JUMPI forks through the coalescing scheduler
(its 600 s budget is past the 300 s below which pruning is off), so on the
gpu backend, the port's default, those windows go to the router and K1.
The device is therefore resolved, and its kernels built, before the
concrete pass: with no card and none named this raises NoDeviceError.
The flipped branch's transaction sequence stays on the host CDCL
(analysis/solver.get_transaction_sequence), as in the JAX package. The
execution budget ends with the flip pass; the args fields it sets
(pruning_factor, solver_timeout) stay, as in the JAX package."""

from copy import deepcopy
from typing import Any, Dict, List

from mythril_tpu_torch.concolic.concrete_data import ConcreteData
from mythril_tpu_torch.concolic.find_trace import concrete_execution
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.laser.strategy.concolic import ConcolicStrategy
from mythril_tpu_torch.laser.svm import LaserEVM
from mythril_tpu_torch.laser.transaction.models import tx_id_manager
from mythril_tpu_torch.laser.transaction.symbolic import (
    execute_contract_creation,
    execute_message_call,
)
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.time_handler import time_handler


def flip_branches(
    init_state: WorldState,
    concrete_data: ConcreteData,
    jump_addresses: List[str],
    trace: List,
) -> List[Dict[str, Any]]:
    """Symbolically replay the tx steps along `trace`, flipping each JUMPI
    in `jump_addresses`; returns one concretized tx sequence per flip."""
    tx_id_manager.restart_counter()
    laser_evm = LaserEVM(
        execution_timeout=600,
        use_reachability_check=False,
        transaction_count=10,
    )
    laser_evm.open_states = [deepcopy(init_state)]
    laser_evm.strategy = ConcolicStrategy(
        work_list=laser_evm.work_list,
        max_depth=100,
        trace=trace,
        flip_branch_addresses=jump_addresses,
    )
    time_handler.start_execution(laser_evm.execution_timeout)
    for transaction in concrete_data["steps"]:
        address = transaction["address"]
        if address == "":
            for world_state in laser_evm.open_states[:]:
                execute_contract_creation(
                    laser_evm, transaction["input"][2:],
                    world_state=world_state,
                )
        else:
            execute_message_call(
                laser_evm,
                symbol_factory.BitVecVal(int(address, 16), 256),
            )
    return [laser_evm.strategy.results.get(addr)
            for addr in jump_addresses]


def _prepare_device() -> None:
    """The gpu backend's device and kernels, before any window: raises
    NoDeviceError with no card and no device named (args.torch_device)."""
    if args.solver_backend != "gpu":
        return
    from mythril_tpu_torch.gpu.device import resolve_device

    if resolve_device(args.torch_device).type == "cuda":
        from mythril_tpu_torch.core import build_device_kernels

        build_device_kernels()


def concolic_execution(
    concrete_data: ConcreteData,
    jump_addresses: List,
    solver_timeout: int = 100000,
) -> List[Dict[str, Any]]:
    _prepare_device()
    try:
        init_state, trace = concrete_execution(concrete_data)
        args.solver_timeout = solver_timeout
        return flip_branches(
            init_state=init_state,
            concrete_data=concrete_data,
            jump_addresses=[str(addr) for addr in jump_addresses],
            trace=trace,
        )
    finally:
        time_handler.start_execution(None)


def run_concolic(concrete_data: ConcreteData, branches: List[int],
                 solver_timeout: int = 100000) -> List[Dict[str, Any]]:
    """CLI adapter (interfaces/cli.py `concolic` subcommand)."""
    return concolic_execution(concrete_data, branches, solver_timeout)
