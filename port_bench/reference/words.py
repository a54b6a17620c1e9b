"""256-bit words, plainly: evaluate a query's description (see
generate.py) under an assignment, prove a query UNSAT by a complementary
pair of atoms, prove it SAT by a witness, and judge an answer."""

from typing import Dict, Optional

RELATIONS = {
    "ult": lambda a, b: a < b, "ule": lambda a, b: a <= b,
    "ugt": lambda a, b: a > b, "uge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
}
COMPLEMENT = {"ult": "uge", "uge": "ult", "ugt": "ule", "ule": "ugt",
              "eq": "ne", "ne": "eq"}


def width(node) -> int:
    tag = node[0]
    if tag in ("var", "const"):
        return node[2]
    if tag == "extract":
        return node[1] - node[2] + 1
    return width(node[1])


def value(node, assignment: Dict[str, int]) -> int:
    """The term's value, unsigned, modulo 2**width. A variable the
    assignment leaves out reads 0 (a model's completion)."""
    tag = node[0]
    if tag == "var":
        return assignment.get(node[1], 0) & ((1 << node[2]) - 1)
    if tag == "const":
        return node[1]
    if tag == "add":
        return (value(node[1], assignment) + value(node[2], assignment)) \
            & ((1 << width(node)) - 1)
    if tag == "extract":
        hi, lo = node[1], node[2]
        return (value(node[3], assignment) >> lo) & ((1 << (hi - lo + 1)) - 1)
    raise ValueError(f"unknown term {tag!r}")


def holds(atoms, assignment: Dict[str, int]) -> bool:
    return all(RELATIONS[rel](value(a, assignment), value(b, assignment))
               for rel, a, b in atoms)


def unsat_proof(atoms) -> bool:
    """True when two atoms over the same operands have complementary
    relations: no assignment satisfies both."""
    seen = {(rel, _key(a), _key(b)) for rel, a, b in atoms}
    return any((COMPLEMENT[rel], a, b) in seen for rel, a, b in seen)


def _key(node):
    return tuple(_key(part) if isinstance(part, tuple) else part
                 for part in node)


def decide(atoms, witness: Optional[Dict[str, int]]) -> str:
    """The reference's own verdict: "unsat" by a complementary pair, "sat"
    by a witness that it checks; anything else is a generator fault."""
    if unsat_proof(atoms):
        return "unsat"
    if witness is not None and holds(atoms, witness):
        return "sat"
    raise ValueError("the reference cannot decide this query")


def judge(atoms, verdict: str, status: str,
          model: Optional[Dict[str, int]]) -> Optional[str]:
    """None when the program's answer (status and model) is right, else
    what is wrong with it."""
    if status == "sat":
        if verdict == "unsat":
            return "sat for an unsat query"
        if model is None or not holds(atoms, model):
            return "a model that fails its query"
        return None
    if status == "unsat":
        return None if verdict == "unsat" else "unsat for a sat query"
    return f"no answer ({status})"
