"""CFG nodes/edges for graph + statespace outputs
(reference laser/ethereum/cfg.py:122)."""

from enum import Enum
from typing import List


class JumpType(Enum):
    CONDITIONAL = 1
    UNCONDITIONAL = 2
    CALL = 3
    RETURN = 4
    Transaction = 5


class NodeFlags:
    FUNC_ENTRY = 1
    CALL_RETURN = 2


_next_uid = [0]


class Node:
    def __init__(self, contract_name: str, start_addr: int = 0,
                 constraints=None, function_name: str = "unknown"):
        self.contract_name = contract_name
        self.start_addr = start_addr
        self.constraints = constraints if constraints is not None else []
        self.function_name = function_name
        self.flags = 0
        self.states: List = []
        _next_uid[0] += 1
        self.uid = _next_uid[0]

    def get_dict(self):
        return {
            "contract_name": self.contract_name,
            "start_addr": self.start_addr,
            "function_name": self.function_name,
        }


class Edge:
    def __init__(self, node_from: int, node_to: int,
                 edge_type: JumpType = JumpType.UNCONDITIONAL, condition=None):
        self.node_from = node_from
        self.node_to = node_to
        self.type = edge_type
        self.condition = condition

    def as_dict(self):
        return {"from": self.node_from, "to": self.node_to}
