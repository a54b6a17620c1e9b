"""Foundry/hevm cheat-code address recognition
(reference laser/ethereum/cheat_code.py:44). Calls to it are stubbed."""

HEVM_CHEAT_ADDRESS = 0x7109709ECFA91A80626FF3989D68F67F5B1DD12D


def is_cheat_address(address) -> bool:
    if hasattr(address, "symbolic"):
        if address.symbolic:
            return False
        address = address.concrete_value
    return address == HEVM_CHEAT_ADDRESS
