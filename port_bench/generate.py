"""The traffic generator: every mix under traffic/ is parameters for it.
A mix's "kind" names its runner, runners/<kind>.py. The kinds so far:

- "analyze_pool": a seeded stream of contracts from the configuration. Round
  r of the stream is the configuration's contracts in an order drawn from
  (seed, r); each contract of the stream has its dispatcher's selectors
  redrawn from (seed, stream index), so no two contracts of a run send the
  same query and no result tier answers a repeat. The redraw keeps the
  selectors' order (a dispatcher that splits on GT routes alike), the
  opcodes, the lengths and so every PC address; a pinned finding follows
  its function's new selector.

- "solve_windows": windows of sibling-path feasibility queries at EVM
  width, each fresh from (seed, window index). A query is a plain
  description (terms and atoms over 256-bit words, below) from which the
  port's terms are built, with a witness planted beside it for every
  query that is satisfiable. Its prefix is a frozen copy of
  mythril_tpu_torch/support/workloads.py `sibling_window` (the selector
  dispatch, `callvalue < 2**40`, `caller != 0`); its branch links are
  shapes, one module each under shapes/, which the mix names.

Description terms: ("var", name, width), ("const", value, width),
("add", a, b), ("extract", hi, lo, a); atoms: (relation, a,
b) with relation one of ult, ule, ugt, uge, eq, ne. The reference
(reference/words.py) evaluates them with Python integers.
"""

import importlib
import json
import os
import random
from typing import Dict, List, NamedTuple, Optional

WIDTH = 256
MASK = (1 << WIDTH) - 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng(*parts) -> random.Random:
    """A generator seeded from a label: the same parts give the same
    draws on every machine (string seeds hash with SHA-512)."""
    return random.Random(":".join(str(part) for part in parts))


# -- contract streams ----------------------------------------------------------


class ContractTask(NamedTuple):
    index: int            # position in the stream
    name: str             # the configuration's contract
    code: str             # creation bytecode, hex, selectors redrawn
    tx_count: int
    expected: tuple       # sorted (swc, function, address) of the findings


def load_json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as handle:
        return json.load(handle)


def read_text(path: str) -> str:
    with open(os.path.join(ROOT, path)) as handle:
        return handle.read().strip()


def redraw_selectors(code: bytes, sites, rng: random.Random):
    """(code with every selector site redrawn, {old selector: new}). New
    selectors are distinct, never 0 or 0xffffffff, and keep the old ones'
    order."""
    old = sorted({int(selector, 16) for _offset, selector in sites})
    fresh = set()
    while len(fresh) < len(old):
        value = rng.getrandbits(32)
        if value not in (0, 0xFFFFFFFF):
            fresh.add(value)
    mapping = dict(zip(old, sorted(fresh)))
    out = bytearray(code)
    for offset, selector in sites:
        if out[offset] != 0x63 or out[offset + 1: offset + 5] \
                != bytes.fromhex(selector):
            raise ValueError(f"no PUSH4 0x{selector} at {offset}")
        out[offset + 1: offset + 5] = mapping[int(selector, 16)].to_bytes(
            4, "big")
    return bytes(out), mapping


class ContractSource:
    """The configuration's contracts, their selector sites and pinned
    findings, read once."""

    def __init__(self, config: dict):
        pins = load_json(config["pins"]["file"])["contracts"]
        self.contracts = []
        for entry in config["contracts"]:
            pin = pins[entry["name"]]
            self.contracts.append(
                (entry["name"], bytes.fromhex(read_text(entry["file"])),
                 int(entry["tx_count"]), pin["sites"], pin["findings"]))

    def task(self, seed: int, index: int, label: str = "stream"
             ) -> ContractTask:
        count = len(self.contracts)
        order = list(range(count))
        _rng(label, seed, "round", index // count).shuffle(order)
        name, code, tx_count, sites, findings = \
            self.contracts[order[index % count]]
        redrawn, mapping = redraw_selectors(
            code, sites, _rng(label, seed, "redraw", index))
        expected = tuple(sorted(
            (pin["swc"], "_function_0x%08x" % mapping[int(pin["selector"],
                                                          16)],
             int(pin["address"]))
            for pin in findings))
        return ContractTask(index, name, redrawn.hex(), tx_count, expected)


# -- solve windows -------------------------------------------------------------


def var(name: str, width: int = WIDTH):
    return ("var", name, width)


def const(value: int, width: int = WIDTH):
    return ("const", value & ((1 << width) - 1), width)


NEGATION = {"ult": "uge", "uge": "ult", "ugt": "ule", "ule": "ugt",
            "eq": "ne", "ne": "eq"}


class Query(NamedTuple):
    atoms: tuple                 # the plain description
    witness: Optional[Dict]      # name -> value, planted when satisfiable
    unsat: bool                  # planted infeasible sibling


def shape(kind: str):
    """The branch shape `kind`: the module shapes/<kind>.py, whose
    `branch(i, rng)` gives (atom, witness values) of that link of query i,
    taken. A new shape is a new file there; a mix names it."""
    return importlib.import_module("port_bench.shapes." + kind)


def query_window(mix: dict, seed: int, index: int) -> List[Query]:
    """Window `index` of a solve_windows mix: mix["window"] queries, every
    mix["unsat_every"]-th (1-based) one the infeasible sibling (both sides
    of its last link). mix["patterns"] lists the branch chains, each a
    list of shapes/ names, taken in turn; every link is taken, as
    sibling_window takes it."""
    rng = _rng("window", seed, index)
    unsat_every = int(mix.get("unsat_every", 0))
    patterns = [[shape(kind) for kind in pattern]
                for pattern in mix["patterns"]]
    calldata, callvalue, caller = (var("calldata_0"), var("callvalue"),
                                   var("caller"))
    prefix = (("ult", callvalue, const(2 ** 40)),
              ("ne", caller, const(0)))
    queries = []
    for i in range(int(mix["window"])):
        selector = rng.getrandbits(32)
        atoms = list(prefix) + [
            ("eq", ("extract", WIDTH - 1, WIDTH - 32, calldata),
             const(selector, 32))]
        witness = {"callvalue": 0, "caller": 1,
                   "calldata_0": selector << (WIDTH - 32)}
        for link in patterns[i % len(patterns)]:
            atom, values = link.branch(i, rng)
            atoms.append(atom)
            witness.update(values)
        unsat = bool(unsat_every) and i % unsat_every == unsat_every - 1
        if unsat:
            last = atoms[-1]
            atoms.append((NEGATION[last[0]],) + last[1:])
        queries.append(Query(tuple(atoms), None if unsat else witness,
                             unsat))
    return queries


def port_terms(smt, atoms) -> list:
    """The port's constraint list for one description (smt is the port's
    mythril_tpu_torch.smt)."""
    sf = smt.symbol_factory
    symbols = {}

    def term(node):
        tag = node[0]
        if tag == "var":
            if node[1] not in symbols:
                symbols[node[1]] = sf.BitVecSym(node[1], node[2])
            return symbols[node[1]]
        if tag == "const":
            return sf.BitVecVal(node[1], node[2])
        if tag == "add":
            return term(node[1]) + term(node[2])
        if tag == "extract":
            return smt.Extract(node[1], node[2], term(node[3]))
        raise ValueError(f"unknown term {tag!r}")

    relations = {"ult": smt.ULT, "ule": smt.ULE, "ugt": smt.UGT,
                 "uge": smt.UGE, "eq": lambda a, b: a == b,
                 "ne": lambda a, b: a != b}
    return [relations[rel](term(a), term(b)) for rel, a, b in atoms]


def variables(atoms) -> List[str]:
    """Every variable name of a description, in first-use order."""
    names = []

    def walk(node):
        if node[0] == "var":
            if node[1] not in names:
                names.append(node[1])
        elif node[0] == "add":
            walk(node[1])
            walk(node[2])
        elif node[0] == "extract":
            walk(node[3])

    for _rel, a, b in atoms:
        walk(a)
        walk(b)
    return names
