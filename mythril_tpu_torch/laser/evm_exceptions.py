"""VM exception family (reference laser/ethereum/evm_exceptions.py:43)."""


class VmException(Exception):
    pass


class StackUnderflowException(IndexError, VmException):
    pass


class StackOverflowException(VmException):
    pass


class InvalidJumpDestination(VmException):
    pass


class InvalidInstruction(VmException):
    pass


class OutOfGasException(VmException):
    pass


class WriteProtection(VmException):
    """State modification inside STATICCALL."""
