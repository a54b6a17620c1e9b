"""SWC registry constants (reference mythril/analysis/swc_data.py:67)."""

REENTRANCY = "107"
UNPROTECTED_SELFDESTRUCT = "106"
UNPROTECTED_ETHER_WITHDRAWAL = "105"
UNCHECKED_RET_VAL = "104"
DEPRECATED_FUNCTIONS_USAGE = "111"
DELEGATECALL_TO_UNTRUSTED_CONTRACT = "112"
INTEGER_OVERFLOW_AND_UNDERFLOW = "101"
DOS_WITH_BLOCK_GAS_LIMIT = "128"
TX_ORDER_DEPENDENCE = "114"
TX_ORIGIN_USAGE = "115"
TIMESTAMP_DEPENDENCE = "116"
WEAK_RANDOMNESS = "120"
ASSERT_VIOLATION = "110"
DEFAULT_FUNCTION_VISIBILITY = "100"
MULTIPLE_SENDS = "113"
UNPROTECTED_SUICIDE = "106"
WRITE_TO_ARBITRARY_STORAGE = "124"
ARBITRARY_JUMP = "127"
UNEXPECTED_ETHER_BALANCE = "132"
REQUIREMENT_VIOLATION = "123"

SWC_TO_TITLE = {
    "100": "Function Default Visibility",
    "101": "Integer Overflow and Underflow",
    "102": "Outdated Compiler Version",
    "103": "Floating Pragma",
    "104": "Unchecked Call Return Value",
    "105": "Unprotected Ether Withdrawal",
    "106": "Unprotected SELFDESTRUCT Instruction",
    "107": "Reentrancy",
    "108": "State Variable Default Visibility",
    "109": "Uninitialized Storage Pointer",
    "110": "Assert Violation",
    "111": "Use of Deprecated Solidity Functions",
    "112": "Delegatecall to Untrusted Callee",
    "113": "DoS with Failed Call",
    "114": "Transaction Order Dependence",
    "115": "Authorization through tx.origin",
    "116": "Block values as a proxy for time",
    "117": "Signature Malleability",
    "118": "Incorrect Constructor Name",
    "119": "Shadowing State Variables",
    "120": "Weak Sources of Randomness from Chain Attributes",
    "123": "Requirement Violation",
    "124": "Write to Arbitrary Storage Location",
    "127": "Arbitrary Jump with Function Type Variable",
    "128": "DoS With Block Gas Limit",
    "132": "Unexpected Ether balance",
}
