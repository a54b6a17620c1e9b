"""EVM opcode metadata table (through Cancun).

Behavioral parity with the reference opcode registry
(mythril/support/opcodes.py:15, mythril/laser/ethereum/instruction_data.py),
re-expressed as a byte-indexed spec table. Gas values are (min, max) bounds
used for symbolic gas accounting; stack arity drives pre-dispatch underflow
checks (reference svm.py:423-434).
"""

from typing import Dict, NamedTuple, Optional


class OpSpec(NamedTuple):
    byte: int
    name: str
    pops: int
    pushes: int
    gas_min: int
    gas_max: int


def _spec(byte, name, pops, pushes, gas_min, gas_max=None):
    return OpSpec(byte, name, pops, pushes, gas_min,
                  gas_max if gas_max is not None else gas_min)


_RAW = [
    # byte, name, pops, pushes, gas_min[, gas_max]
    (0x00, "STOP", 0, 0, 0),
    (0x01, "ADD", 2, 1, 3),
    (0x02, "MUL", 2, 1, 5),
    (0x03, "SUB", 2, 1, 3),
    (0x04, "DIV", 2, 1, 5),
    (0x05, "SDIV", 2, 1, 5),
    (0x06, "MOD", 2, 1, 5),
    (0x07, "SMOD", 2, 1, 5),
    (0x08, "ADDMOD", 3, 1, 8),
    (0x09, "MULMOD", 3, 1, 8),
    (0x0A, "EXP", 2, 1, 10, 10 + 50 * 32),  # 10 + 50/byte of exponent
    (0x0B, "SIGNEXTEND", 2, 1, 5),
    (0x10, "LT", 2, 1, 3),
    (0x11, "GT", 2, 1, 3),
    (0x12, "SLT", 2, 1, 3),
    (0x13, "SGT", 2, 1, 3),
    (0x14, "EQ", 2, 1, 3),
    (0x15, "ISZERO", 1, 1, 3),
    (0x16, "AND", 2, 1, 3),
    (0x17, "OR", 2, 1, 3),
    (0x18, "XOR", 2, 1, 3),
    (0x19, "NOT", 1, 1, 3),
    (0x1A, "BYTE", 2, 1, 3),
    (0x1B, "SHL", 2, 1, 3),
    (0x1C, "SHR", 2, 1, 3),
    (0x1D, "SAR", 2, 1, 3),
    (0x20, "SHA3", 2, 1, 30, 30 + 6 * 8),
    (0x30, "ADDRESS", 0, 1, 2),
    (0x31, "BALANCE", 1, 1, 100, 2600),
    (0x32, "ORIGIN", 0, 1, 2),
    (0x33, "CALLER", 0, 1, 2),
    (0x34, "CALLVALUE", 0, 1, 2),
    (0x35, "CALLDATALOAD", 1, 1, 3),
    (0x36, "CALLDATASIZE", 0, 1, 2),
    (0x37, "CALLDATACOPY", 3, 0, 2, 2 + 3 * 768),
    (0x38, "CODESIZE", 0, 1, 2),
    (0x39, "CODECOPY", 3, 0, 2, 2 + 3 * 768),
    (0x3A, "GASPRICE", 0, 1, 2),
    (0x3B, "EXTCODESIZE", 1, 1, 100, 2600),
    (0x3C, "EXTCODECOPY", 4, 0, 100, 2600 + 3 * 768),
    (0x3D, "RETURNDATASIZE", 0, 1, 2),
    (0x3E, "RETURNDATACOPY", 3, 0, 2, 2 + 3 * 768),
    (0x3F, "EXTCODEHASH", 1, 1, 100, 2600),
    (0x40, "BLOCKHASH", 1, 1, 20),
    (0x41, "COINBASE", 0, 1, 2),
    (0x42, "TIMESTAMP", 0, 1, 2),
    (0x43, "NUMBER", 0, 1, 2),
    (0x44, "PREVRANDAO", 0, 1, 2),
    (0x45, "GASLIMIT", 0, 1, 2),
    (0x46, "CHAINID", 0, 1, 2),
    (0x47, "SELFBALANCE", 0, 1, 5),
    (0x48, "BASEFEE", 0, 1, 2),
    (0x49, "BLOBHASH", 1, 1, 3),
    (0x4A, "BLOBBASEFEE", 0, 1, 2),
    (0x50, "POP", 1, 0, 2),
    (0x51, "MLOAD", 1, 1, 3, 96),
    (0x52, "MSTORE", 2, 0, 3, 98),
    (0x53, "MSTORE8", 2, 0, 3, 98),
    (0x54, "SLOAD", 1, 1, 100, 2100),
    (0x55, "SSTORE", 2, 0, 100, 22100),
    (0x56, "JUMP", 1, 0, 8),
    (0x57, "JUMPI", 2, 0, 10),
    (0x58, "PC", 0, 1, 2),
    (0x59, "MSIZE", 0, 1, 2),
    (0x5A, "GAS", 0, 1, 2),
    (0x5B, "JUMPDEST", 0, 0, 1),
    (0x5C, "TLOAD", 1, 1, 100),
    (0x5D, "TSTORE", 2, 0, 100),
    (0x5E, "MCOPY", 3, 0, 3, 3 + 3 * 768),
    (0x5F, "PUSH0", 0, 1, 2),
    (0xA0, "LOG0", 2, 0, 375, 375 + 8 * 32),
    (0xA1, "LOG1", 3, 0, 750, 750 + 8 * 32),
    (0xA2, "LOG2", 4, 0, 1125, 1125 + 8 * 32),
    (0xA3, "LOG3", 5, 0, 1500, 1500 + 8 * 32),
    (0xA4, "LOG4", 6, 0, 1875, 1875 + 8 * 32),
    (0xF0, "CREATE", 3, 1, 32000, 32000 + 200 * 24576),
    (0xF1, "CALL", 7, 1, 100, 2600 + 9000 + 25000),
    (0xF2, "CALLCODE", 7, 1, 100, 2600 + 9000),
    (0xF3, "RETURN", 2, 0, 0),
    (0xF4, "DELEGATECALL", 6, 1, 100, 2600),
    (0xF5, "CREATE2", 4, 1, 32000, 32000 + 200 * 24576 + 6 * 768),
    (0xFA, "STATICCALL", 6, 1, 100, 2600),
    (0xFD, "REVERT", 2, 0, 0),
    (0xFE, "INVALID", 0, 0, 0),
    (0xFF, "SELFDESTRUCT", 1, 0, 5000, 5000 + 25000),
]

BY_BYTE: Dict[int, OpSpec] = {}
BY_NAME: Dict[str, OpSpec] = {}

for row in _RAW:
    spec = _spec(*row)
    BY_BYTE[spec.byte] = spec
    BY_NAME[spec.name] = spec

# PUSH1..PUSH32 (0x60..0x7F)
for width in range(1, 33):
    spec = _spec(0x5F + width, f"PUSH{width}", 0, 1, 3)
    BY_BYTE[spec.byte] = spec
    BY_NAME[spec.name] = spec

# DUP1..DUP16 (0x80..0x8F): DUPn pops n, pushes n+1 (net +1, needs n on stack)
for depth in range(1, 17):
    spec = _spec(0x7F + depth, f"DUP{depth}", depth, depth + 1, 3)
    BY_BYTE[spec.byte] = spec
    BY_NAME[spec.name] = spec

# SWAP1..SWAP16 (0x90..0x9F): SWAPn needs n+1 on stack
for depth in range(1, 17):
    spec = _spec(0x8F + depth, f"SWAP{depth}", depth + 1, depth + 1, 3)
    BY_BYTE[spec.byte] = spec
    BY_NAME[spec.name] = spec

# The detection layer hooks "ASSERT_FAIL" for the solidity 0.8 panic opcode;
# 0xFE is rendered as ASSERT_FAIL to match reference report vocabulary.
ASSERT_FAIL_NAME = "ASSERT_FAIL"


def spec_for_byte(byte: int) -> Optional[OpSpec]:
    return BY_BYTE.get(byte)


def name_of(byte: int) -> str:
    spec = BY_BYTE.get(byte)
    return spec.name if spec else f"UNKNOWN_0x{byte:02x}"


def push_width(name: str) -> int:
    """Operand byte count for PUSHn; 0 for anything else (incl. PUSH0)."""
    if name.startswith("PUSH") and name != "PUSH0":
        return int(name[4:])
    return 0


def required_stack(name: str) -> int:
    return BY_NAME[name].pops if name in BY_NAME else 0
