"""Spec conformance of the port: the official Ethereum VMTests vectors
replayed through mythril_tpu_torch's engine with concrete transactions
(laser/transaction/concolic.py), the post-state asserted as
tests/test_vmtests.py asserts the JAX package's, with the same vectors,
gate and documented skip list."""

import binascii

import pytest

from tests.test_vmtests import IGNORED, TEST_TYPES, VMTESTS_DIR, load_test_data

pytestmark = pytest.mark.skipif(
    not VMTESTS_DIR.is_dir(), reason="VMTests vectors not mounted"
)


@pytest.mark.parametrize(
    "test_name, environment, pre_condition, action, gas_used, post_condition",
    load_test_data(TEST_TYPES),
)
def test_vmtest(test_name, environment, pre_condition, action, gas_used,
                post_condition):
    if test_name in IGNORED:
        pytest.skip("documented engine gap (same skip list as reference)")

    from mythril_tpu_torch.disasm import Disassembly
    from mythril_tpu_torch.laser.state.world_state import WorldState
    from mythril_tpu_torch.laser.svm import LaserEVM
    from mythril_tpu_torch.laser.transaction.concolic import execute_message_call
    from mythril_tpu_torch.laser.transaction.models import tx_id_manager
    from mythril_tpu_torch.smt import symbol_factory
    from mythril_tpu_torch.smt.bitvec import Expression
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.time_handler import time_handler

    tx_id_manager.restart_counter()
    args.reset()
    # concrete replay: the host solver, so no device is needed
    args.solver_backend = "cpu"
    args.pruning_factor = 1
    world_state = WorldState()
    for address, details in pre_condition.items():
        account = world_state.create_account(
            address=int(address, 16),
            concrete_storage=True,
            balance=int(details["balance"], 16),
        )
        account.code = Disassembly(details["code"][2:])
        account.nonce = int(details["nonce"], 16)
        for key, value in details["storage"].items():
            key_bv = symbol_factory.BitVecVal(int(key, 16), 256)
            account.storage[key_bv] = symbol_factory.BitVecVal(
                int(value, 16), 256
            )

    time_handler.start_execution(10000)
    laser_evm = LaserEVM()
    laser_evm.open_states = [world_state]

    try:
        final_states = execute_message_call(
            laser_evm,
            callee_address=int(action["address"], 16),
            caller_address=int(action["caller"], 16),
            origin_address=int(action["origin"], 16),
            code=action["code"][2:],
            gas_limit=int(action["gas"], 16),
            data=list(binascii.a2b_hex(action["data"][2:])),
            gas_price=int(action["gasPrice"], 16),
            value=int(action["value"], 16),
            track_gas=True,
            block_number=int(environment["currentNumber"], 16),
        )
    finally:
        time_handler.start_execution(None)
        args.reset()

    if gas_used is not None and gas_used < int(
        environment["currentGasLimit"], 16
    ):
        gas_min_max = [
            (s.mstate.min_gas_used, s.mstate.max_gas_used)
            for s in final_states
        ]
        assert all(low <= high for low, high in gas_min_max)
        assert any(low <= gas_used for low, _high in gas_min_max)

    if post_condition == {}:
        # error or out-of-gas: no surviving world state
        assert len(laser_evm.open_states) == 0
    else:
        assert len(laser_evm.open_states) == 1
        world_state = laser_evm.open_states[0]
        for address, details in post_condition.items():
            account = world_state.accounts[int(address, 16)]
            assert account.nonce == int(details["nonce"], 16)
            expected_code = details["code"][2:]
            actual_code = account.code.bytecode
            if isinstance(actual_code, bytes):
                actual_code = actual_code.hex()
            assert actual_code == expected_code
            for index, value in details["storage"].items():
                expected = int(value, 16)
                actual = account.storage[
                    symbol_factory.BitVecVal(int(index, 16), 256)
                ]
                if isinstance(actual, Expression):
                    actual = actual.value if not hasattr(actual, "concrete_value") \
                        else actual.concrete_value
                    actual = (
                        1 if actual is True
                        else 0 if actual is False
                        else actual
                    )
                elif isinstance(actual, bytes):
                    actual = int(binascii.b2a_hex(actual), 16)
                elif isinstance(actual, str):
                    actual = int(actual, 16)
                assert actual == expected, (
                    f"storage[{index}] = {actual}, expected {expected}"
                )
