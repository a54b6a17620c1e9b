"""Per-function feature extraction from the solc AST
(reference mythril/solidity/features.py:234) — the feature vector feeding
the transaction-sequence prioritizer (laser/tx_prioritiser.py).

Walks the standard-json AST of each function and records state-changing or
guard constructs: selfdestruct/call-family use, payability, owner-style
modifiers, assert/require guards (require'd variables propagate from
modifiers into the functions that use them), and the address variables that
receive transfer()/send() value."""

from typing import Dict, List, Set


FEATURES = (
    "contains_selfdestruct",
    "contains_call",
    "contains_delegatecall",
    "contains_callcode",
    "contains_staticcall",
    "contains_assert",
    "all_require_vars",
    "transfer_vars",
    "payable",
    "is_constructor",
    "has_modifiers",
    "has_owner_modifier",
    "transfers_value",
)

_CALL_KIND = {
    "call": "contains_call",
    "delegatecall": "contains_delegatecall",
    "callcode": "contains_callcode",
    "staticcall": "contains_staticcall",
}

_TRANSFER_METHODS = ("transfer", "send")
_OWNER_HINTS = ("owner", "admin", "auth")


def _walk(node, visit) -> None:
    if isinstance(node, dict):
        visit(node)
        for value in node.values():
            _walk(value, visit)
    elif isinstance(node, list):
        for item in node:
            _walk(item, visit)


def _identifiers_in(node) -> Set[str]:
    names: Set[str] = set()
    _walk(node, lambda n: (
        names.add(n["name"]) if n.get("nodeType") == "Identifier" else None
    ))
    return names


class SolidityFeatureExtractor:
    def __init__(self, ast: dict):
        self.ast = ast or {}

    def extract_features(self) -> Dict[str, Dict]:
        """function name -> feature dict. Modifier guard variables resolve
        within the function's own contract (same-named modifiers in other
        contracts of the file don't leak in)."""
        out: Dict[str, Dict] = {}
        modifier_cache: Dict[int, Dict[str, Set[str]]] = {}
        for fn, contract in self._function_nodes():
            scope = contract or self.ast
            if id(scope) not in modifier_cache:
                modifier_cache[id(scope)] = self._modifier_require_vars(scope)
            out[fn.get("name") or "constructor"] = self._features_of(
                fn, modifier_cache[id(scope)])
        return out

    def _function_nodes(self) -> List[tuple]:
        """(function node, enclosing ContractDefinition or None) pairs."""
        nodes = []

        def collect(node, contract):
            if isinstance(node, dict):
                if node.get("nodeType") == "ContractDefinition":
                    contract = node
                if node.get("nodeType") == "FunctionDefinition":
                    nodes.append((node, contract))
                for value in node.values():
                    collect(value, contract)
            elif isinstance(node, list):
                for item in node:
                    collect(item, contract)

        collect(self.ast, None)
        return nodes

    @staticmethod
    def _modifier_require_vars(scope: dict) -> Dict[str, Set[str]]:
        """modifier name -> variables required inside it, within one
        contract's scope (reference features.py:28-35: modifier guards
        count toward the functions that carry the modifier)."""
        out: Dict[str, Set[str]] = {}

        def visit(node):
            if node.get("nodeType") != "ModifierDefinition":
                return
            required: Set[str] = set()

            def inner(call):
                if call.get("nodeType") == "FunctionCall" and \
                        call.get("expression", {}).get("name") in (
                            "require", "assert"):
                    for arg in call.get("arguments", []):
                        required.update(_identifiers_in(arg))

            _walk(node.get("body") or {}, inner)
            out[node.get("name", "")] = required

        _walk(scope, visit)
        return out

    def _features_of(self, fn: dict,
                     modifier_vars: Dict[str, Set[str]]) -> Dict:
        features: Dict = {name: False for name in FEATURES}
        features["all_require_vars"] = set()
        features["transfer_vars"] = set()
        features["is_constructor"] = fn.get("kind") == "constructor"
        features["payable"] = fn.get("stateMutability") == "payable"
        modifiers = fn.get("modifiers") or []
        features["has_modifiers"] = bool(modifiers)
        features["has_owner_modifier"] = any(
            hint in (m.get("modifierName", {}).get("name", "").lower())
            for m in modifiers for hint in _OWNER_HINTS
        )
        for modifier in modifiers:
            name = modifier.get("modifierName", {}).get("name", "")
            features["all_require_vars"] |= modifier_vars.get(name, set())

        def visit(node):
            if node.get("nodeType") != "FunctionCall":
                return
            callee = node.get("expression", {})
            name = callee.get("name")
            member = callee.get("memberName")
            if name in ("selfdestruct", "suicide"):
                features["contains_selfdestruct"] = True
            if member in _CALL_KIND:
                features[_CALL_KIND[member]] = True
            if member in _TRANSFER_METHODS:
                features["transfers_value"] = True
                # the address variable receiving the value, e.g. `to` in
                # `to.transfer(amount)` (reference extract_address_variable)
                target = callee.get("expression", {})
                if target.get("nodeType") == "Identifier" and \
                        target.get("name"):
                    features["transfer_vars"].add(target["name"])
            if name == "assert":
                features["contains_assert"] = True
            if name in ("require", "assert"):
                for arg in node.get("arguments", []):
                    features["all_require_vars"] |= _identifiers_in(arg)

        _walk(fn.get("body") or {}, visit)
        return features
