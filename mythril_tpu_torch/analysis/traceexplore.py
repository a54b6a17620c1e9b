"""Statespace JSON serialization for `-j` (reference analysis/traceexplore.py:166)."""

from typing import Dict, List

from mythril_tpu_torch.smt import terms as _terms


def get_serializable_statespace(sym) -> Dict:
    nodes: List[Dict] = []
    node_uid_to_index = {}
    for node in sym.nodes.values():
        states = []
        for state in node.states:
            instruction = state.get_current_instruction()
            stack = (
                state.mstate_stack
                if hasattr(state, "mstate_stack")
                else list(state.mstate.stack)
            )
            states.append(
                {
                    "address": instruction.address if instruction else None,
                    "opcode": instruction.opcode if instruction else "END",
                    "stack": [
                        _terms.term_to_str(v.raw, max_depth=6) for v in stack
                    ],
                }
            )
        node_uid_to_index[node.uid] = len(nodes)
        nodes.append(
            {
                "id": node.uid,
                "contract": node.contract_name,
                "function": node.function_name,
                "startAddr": node.start_addr,
                "constraints": [
                    _terms.term_to_str(c.raw, max_depth=6)
                    for c in list(node.constraints)
                ],
                "states": states,
            }
        )
    edges = [
        {
            "from": edge.node_from,
            "to": edge.node_to,
            "type": edge.type.name,
        }
        for edge in sym.edges
    ]
    return {"nodes": nodes, "edges": edges}
