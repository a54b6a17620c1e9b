"""QF_BV -> AIG -> CNF lowering.

The seam between the word-level term DAG and both SAT backends (C++ CDCL on
host, the circuit-SLS kernel on the GPU). Terms reaching this layer must be pure
QF_BV — arrays and UFs are eliminated by the solver frontend first
(ackermannization + read-over-write unwinding, see solver/frontend.py).

Literal encoding (standard AIG): variable v -> literals 2v (pos) / 2v+1
(neg); constants FALSE=0, TRUE=1. AND gates are structurally hashed.
Bit vectors are LSB-first literal lists. CNF via Tseitin (3 clauses/gate).
"""

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from mythril_tpu_torch.smt.terms import BOOL, Term

FALSE_LIT = 0
TRUE_LIT = 1


_AIG_UID = 0


class CNF:
    """Flat CNF: DIMACS literals in one int32 array + int64 clause offsets.

    The numpy buffers go straight to the C++ CDCL via pointer (no per-lit
    marshalling) and to the vectorized clause checker; iteration yields the
    legacy tuple-of-ints view for the pure-Python fallback paths."""

    __slots__ = ("lits", "offsets", "num_clauses", "has_empty")

    def __init__(self, lits, offsets, num_clauses: int, has_empty: bool):
        self.lits = lits
        self.offsets = offsets
        self.num_clauses = num_clauses
        self.has_empty = has_empty

    def __len__(self) -> int:
        return self.num_clauses

    def __iter__(self) -> Iterator[Tuple[int, ...]]:
        lits, offsets = self.lits, self.offsets
        for c in range(self.num_clauses):
            yield tuple(int(l) for l in lits[offsets[c]:offsets[c + 1]])

    @classmethod
    def from_clauses(cls, clauses) -> "CNF":
        offsets = np.zeros(len(clauses) + 1, dtype=np.int64)
        flat: List[int] = []
        has_empty = False
        for i, clause in enumerate(clauses):
            if not clause:
                has_empty = True
            flat.extend(clause)
            offsets[i + 1] = len(flat)
        return cls(np.array(flat, dtype=np.int32), offsets, len(clauses),
                   has_empty)


class DenseMap:
    """global AIG var -> dense CNF var, over a numpy column (0 = absent).
    Drop-in for the dict the Python exporter used (.get protocol)."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr

    def get(self, var: int, default=None):
        if 0 <= var < len(self.arr):
            dense = int(self.arr[var])
            if dense:
                return dense
        return default

    def __getitem__(self, var: int) -> int:
        dense = self.get(var)
        if dense is None:
            raise KeyError(var)
        return dense

    def __len__(self) -> int:
        return int(np.count_nonzero(self.arr))


class _GateView:
    """Dict-like read view of the AIG's flat gate arrays (compat shim for
    the levelizer and tests; no per-gate dict is materialized)."""

    __slots__ = ("_aig",)

    def __init__(self, aig: "AIG"):
        self._aig = aig

    def get(self, var: int, default=None):
        lhs = self._aig.gate_lhs
        if 0 <= var < len(lhs) and lhs[var] >= 0:
            return (lhs[var], self._aig.gate_rhs[var])
        return default

    def __getitem__(self, var: int) -> Tuple[int, int]:
        gate = self.get(var)
        if gate is None:
            raise KeyError(var)
        return gate

    def items(self):
        lhs, rhs = self._aig.gate_lhs, self._aig.gate_rhs
        for var in range(1, len(lhs)):
            if lhs[var] >= 0:
                yield var, (lhs[var], rhs[var])


class AIG:
    """And-Inverter Graph with structural hashing. Append-only: a root
    literal's cone never changes once created, so (aig.uid, roots) is a
    sound cache key for packed/blasted artifacts.

    Gates live in flat per-var lists (gate_lhs/gate_rhs, -1 = circuit
    input), mirrored incrementally into numpy arrays so cone extraction and
    Tseitin export run in native/sat.cpp instead of per-node Python."""

    def __init__(self):
        global _AIG_UID
        _AIG_UID += 1
        self.uid = _AIG_UID
        self.num_vars = 0          # var 0 reserved for constant TRUE/FALSE
        self.gate_lhs: List[int] = [-1]   # per var: defining gate's inputs
        self.gate_rhs: List[int] = [-1]   # (-1 for circuit inputs / const)
        self._strash: Dict[Tuple[int, int], int] = {}
        self._np_lhs: Optional[np.ndarray] = None
        self._np_rhs: Optional[np.ndarray] = None
        self._np_count = 0  # entries already mirrored into the numpy arrays

    @classmethod
    def from_gate_arrays(cls, gate_lhs, gate_rhs) -> "AIG":
        """Rebuild an AIG from another blaster's gate table (the arrays
        AIG.gate_arrays() returns: per var its gate's input literals, -1
        for circuit inputs and the constant). Var ids and the strash table
        come back unchanged, so a query blasted elsewhere packs into the
        same cones here."""
        aig = cls()
        aig.gate_lhs = [int(v) for v in gate_lhs]
        aig.gate_rhs = [int(v) for v in gate_rhs]
        aig.num_vars = len(aig.gate_lhs) - 1
        for var in range(1, aig.num_vars + 1):
            lhs = aig.gate_lhs[var]
            if lhs >= 0:
                aig._strash[(lhs, aig.gate_rhs[var])] = 2 * var
        return aig

    @property
    def gate_of_var(self) -> _GateView:
        return _GateView(self)

    def new_var(self) -> int:
        self.num_vars += 1
        self.gate_lhs.append(-1)
        self.gate_rhs.append(-1)
        return self.num_vars

    def lit_of_var(self, var: int, negated: bool = False) -> int:
        return 2 * var + (1 if negated else 0)

    def gate_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """int32 views of the gate table, synced to the current watermark
        (only the tail appended since the last call is converted)."""
        n = self.num_vars + 1
        if self._np_lhs is None or len(self._np_lhs) < n:
            # capacity-doubling growth: a concatenate-per-sync would
            # re-copy the whole mirrored prefix on every blast call
            # (quadratic over an analyze run on the shared global AIG)
            capacity = 1024
            while capacity < n:
                capacity *= 2
            new_lhs = np.empty(capacity, dtype=np.int32)
            new_rhs = np.empty(capacity, dtype=np.int32)
            if self._np_lhs is not None and self._np_count:
                new_lhs[:self._np_count] = self._np_lhs[:self._np_count]
                new_rhs[:self._np_count] = self._np_rhs[:self._np_count]
            else:
                self._np_count = 0
            self._np_lhs, self._np_rhs = new_lhs, new_rhs
        if self._np_count < n:
            self._np_lhs[self._np_count:n] = self.gate_lhs[self._np_count:n]
            self._np_rhs[self._np_count:n] = self.gate_rhs[self._np_count:n]
            self._np_count = n
        return self._np_lhs[:n], self._np_rhs[:n]

    def and_gate(self, a: int, b: int) -> int:
        if a > b:
            a, b = b, a
        if a == FALSE_LIT:
            return FALSE_LIT
        if a == TRUE_LIT:
            return b
        if a == b:
            return a
        if a ^ 1 == b:
            return FALSE_LIT
        key = (a, b)
        hit = self._strash.get(key)
        if hit is not None:
            return hit
        var = self.new_var()
        self.gate_lhs[var] = a
        self.gate_rhs[var] = b
        lit = 2 * var
        self._strash[key] = lit
        return lit

    def or_gate(self, a: int, b: int) -> int:
        return self.and_gate(a ^ 1, b ^ 1) ^ 1

    def xor_gate(self, a: int, b: int) -> int:
        return self.or_gate(self.and_gate(a, b ^ 1), self.and_gate(a ^ 1, b))

    def xnor_gate(self, a: int, b: int) -> int:
        return self.xor_gate(a, b) ^ 1

    def mux(self, sel: int, then: int, otherwise: int) -> int:
        return self.or_gate(self.and_gate(sel, then), self.and_gate(sel ^ 1, otherwise))

    def to_cnf(self, roots: List[int], defined: List[int] = ()):
        """Tseitin-encode gates reachable from `roots` + `defined`.

        `roots` are asserted true; `defined` literals only get their defining
        gate clauses emitted (used by Optimize to constrain objective bits
        via SAT assumptions without asserting them).

        The cone's variables are renumbered into a DENSE 1..N space — the
        AIG is shared across problems (frontend get_global_blaster), and a
        CNF in global numbering would make every solve pay O(all vars ever
        blasted). Returns (num_dense_vars, cnf, dense_of_global) where `cnf`
        is a CNF of DIMACS-signed DENSE literals and dense_of_global a
        DenseMap. Cone extraction + emission run in native/sat.cpp, in the
        port's host library (a pure-Python exporter dominated heavy-contract
        wall time; the JAX package keeps one as the reference)."""
        import ctypes

        from mythril_tpu_torch.smt.solver import sat_backend

        lib = sat_backend.get_native_lib()
        i32p = ctypes.POINTER(ctypes.c_int)
        i64p = ctypes.POINTER(ctypes.c_longlong)
        u8p = ctypes.POINTER(ctypes.c_ubyte)

        def p32(arr):
            return arr.ctypes.data_as(i32p)

        lhs, rhs = self.gate_arrays()
        seeds = np.array(
            [r for r in list(roots) + list(defined) if (r >> 1) != 0],
            dtype=np.int32,
        )
        needed = np.empty(self.num_vars + 1, dtype=np.uint8)
        counts = np.zeros(2, dtype=np.int64)
        lib.aig_cone(self.num_vars, p32(lhs), p32(rhs), p32(seeds),
                     len(seeds), needed.ctypes.data_as(u8p),
                     counts.ctypes.data_as(i64p))
        gates = int(counts[0])
        roots_arr = np.asarray(list(roots), dtype=np.int32)
        lits = np.empty(7 * gates + len(roots_arr), dtype=np.int32)
        offsets = np.empty(3 * gates + len(roots_arr) + 1, dtype=np.int64)
        dense_arr = np.empty(self.num_vars + 1, dtype=np.int32)
        meta = np.zeros(3, dtype=np.int64)
        n_lits = lib.aig_emit_cnf(
            self.num_vars, p32(lhs), p32(rhs), needed.ctypes.data_as(u8p),
            p32(roots_arr), len(roots_arr), p32(dense_arr), p32(lits),
            offsets.ctypes.data_as(i64p), meta.ctypes.data_as(i64p))
        num_clauses = int(meta[1])
        cnf = CNF(lits[:n_lits], offsets[:num_clauses + 1], num_clauses,
                  bool(meta[2]))
        return int(meta[0]), cnf, DenseMap(dense_arr)


class Blaster:
    """Memoized lowering of a term DAG into one shared AIG."""

    def __init__(self):
        self.aig = AIG()
        self._bv_cache: Dict[int, List[int]] = {}
        self._bool_cache: Dict[int, int] = {}
        # memo keys are id(term): pin every memoized term so it cannot be
        # garbage collected — a reused id would make the cache return
        # another term's literals (the blaster outlives single problems)
        self._pinned: List[Term] = []
        # (name, width) -> var ids (LSB first) for model extraction
        self.bv_symbol_vars: Dict[Tuple[str, int], List[int]] = {}
        self.bool_symbol_vars: Dict[str, int] = {}

    # -- public -------------------------------------------------------------

    def assert_bool(self, term: Term) -> int:
        return self._bool(term)

    def bv_bits(self, term: Term) -> List[int]:
        """AIG literals (LSB-first) of a bitvector term; grows the AIG."""
        return self._bv(term)

    def cnf(self, assertion_terms: List[Term], defined_lits: List[int] = ()):
        roots = [self._bool(t) for t in assertion_terms]
        # kept for the device circuit-SLS path (gpu/circuit.py), which
        # searches over AIG inputs instead of CNF variables
        self.last_roots = roots
        return self.aig.to_cnf(roots, defined_lits)

    # -- bool lowering ------------------------------------------------------

    def _bool(self, term: Term) -> int:
        assert term.sort == BOOL, f"not a bool: {term!r}"
        hit = self._bool_cache.get(id(term))
        if hit is not None:
            return hit
        lit = self._bool_compute(term)
        self._bool_cache[id(term)] = lit
        self._pinned.append(term)
        return lit

    def _bool_compute(self, term: Term) -> int:
        aig = self.aig
        op = term.op
        if op == "true":
            return TRUE_LIT
        if op == "false":
            return FALSE_LIT
        if op == "sym":
            name = term.params[0]
            var = self.bool_symbol_vars.get(name)
            if var is None:
                var = aig.new_var()
                self.bool_symbol_vars[name] = var
            return 2 * var
        if op == "not":
            return self._bool(term.children[0]) ^ 1
        if op == "and":
            acc = TRUE_LIT
            for child in term.children:
                acc = aig.and_gate(acc, self._bool(child))
            return acc
        if op == "or":
            acc = FALSE_LIT
            for child in term.children:
                acc = aig.or_gate(acc, self._bool(child))
            return acc
        if op == "xor":
            return aig.xor_gate(self._bool(term.children[0]), self._bool(term.children[1]))
        if op == "ite":
            return aig.mux(
                self._bool(term.children[0]),
                self._bool(term.children[1]),
                self._bool(term.children[2]),
            )
        if op == "eq":
            a, b = term.children
            if a.sort == BOOL:
                return aig.xnor_gate(self._bool(a), self._bool(b))
            return self._eq_bits(self._bv(a), self._bv(b))
        if op in ("bvult", "bvule", "bvslt", "bvsle"):
            return self._compare(op, term.children[0], term.children[1])
        if op == "umul_novfl":
            return self._umul_no_ovfl(
                self._bv(term.children[0]), self._bv(term.children[1])
            )
        raise NotImplementedError(f"bool lowering: {op}")

    def _umul_no_ovfl(self, xs: List[int], ys: List[int]) -> int:
        """No-unsigned-mul-overflow at ~half the gates of a double-width
        multiplier: the product's high half is zero iff no partial product
        sheds bits past the width (x's top i bits with y_i set) and no
        accumulation step carries out of the low half. Exact: terms are
        non-negative, so the running total once >= 2^n stays there."""
        aig = self.aig
        size = len(xs)
        # suffix[j] = OR of xs[j:] (shed-bits detector, shared across steps)
        suffix = [FALSE_LIT] * (size + 1)
        for j in range(size - 1, -1, -1):
            suffix[j] = aig.or_gate(xs[j], suffix[j + 1])
        acc = [FALSE_LIT] * size
        overflow = FALSE_LIT
        for i, y in enumerate(ys):
            if y == FALSE_LIT:
                continue
            if i > 0:
                overflow = aig.or_gate(overflow, aig.and_gate(y, suffix[size - i]))
            partial = [FALSE_LIT] * i + [aig.and_gate(x, y) for x in xs[: size - i]]
            acc, carry = self._add_carry(acc, partial)
            overflow = aig.or_gate(overflow, carry)
        return overflow ^ 1

    def _eq_bits(self, xs: List[int], ys: List[int]) -> int:
        acc = TRUE_LIT
        for x, y in zip(xs, ys):
            acc = self.aig.and_gate(acc, self.aig.xnor_gate(x, y))
        return acc

    def _compare(self, op: str, a: Term, b: Term) -> int:
        xs, ys = self._bv(a), self._bv(b)
        if op in ("bvult", "bvule"):
            lt = self._ult(xs, ys)
            if op == "bvult":
                return lt
            return self.aig.or_gate(lt, self._eq_bits(xs, ys))
        # signed: flip sign bits then unsigned compare
        xs2 = xs[:-1] + [xs[-1] ^ 1]
        ys2 = ys[:-1] + [ys[-1] ^ 1]
        lt = self._ult(xs2, ys2)
        if op == "bvslt":
            return lt
        return self.aig.or_gate(lt, self._eq_bits(xs, ys))

    def _ult(self, xs: List[int], ys: List[int]) -> int:
        """Unsigned less-than via borrow chain, LSB->MSB."""
        aig = self.aig
        lt = FALSE_LIT
        for x, y in zip(xs, ys):
            x_eq_y = aig.xnor_gate(x, y)
            x_lt_y = aig.and_gate(x ^ 1, y)
            lt = aig.or_gate(x_lt_y, aig.and_gate(x_eq_y, lt))
        return lt

    # -- bitvector lowering -------------------------------------------------

    def _bv(self, term: Term) -> List[int]:
        hit = self._bv_cache.get(id(term))
        if hit is not None:
            return hit
        bits = self._bv_compute(term)
        assert len(bits) == term.size, f"{term.op}: {len(bits)} != {term.size}"
        self._bv_cache[id(term)] = bits
        self._pinned.append(term)
        return bits

    def _bv_compute(self, term: Term) -> List[int]:
        aig = self.aig
        op = term.op
        size = term.size
        if op == "const":
            return [TRUE_LIT if (term.value >> i) & 1 else FALSE_LIT for i in range(size)]
        if op == "sym":
            # keyed by (name, size): the blaster outlives one problem, and
            # an unrelated same-named symbol of another width must not
            # alias (model reconstruction writes per-name, latest wins)
            key = (term.params[0], size)
            cached = self.bv_symbol_vars.get(key)
            if cached is None:
                cached = [aig.new_var() for _ in range(size)]
                self.bv_symbol_vars[key] = cached
            return [2 * v for v in cached]
        child_bits = [self._bv(c) for c in term.children if isinstance(c.sort, int)]
        if op == "bvand":
            return [aig.and_gate(x, y) for x, y in zip(*child_bits)]
        if op == "bvor":
            return [aig.or_gate(x, y) for x, y in zip(*child_bits)]
        if op == "bvxor":
            return [aig.xor_gate(x, y) for x, y in zip(*child_bits)]
        if op == "bvnot":
            return [x ^ 1 for x in child_bits[0]]
        if op == "bvneg":
            return self._add(
                [x ^ 1 for x in child_bits[0]],
                [TRUE_LIT] + [FALSE_LIT] * (size - 1),
            )
        if op == "bvadd":
            return self._add(child_bits[0], child_bits[1])
        if op == "bvsub":
            return self._add(child_bits[0], [y ^ 1 for y in child_bits[1]], carry_in=TRUE_LIT)
        if op == "bvmul":
            return self._mul(child_bits[0], child_bits[1])
        if op in ("bvudiv", "bvurem"):
            quotient, remainder = self._udivrem(child_bits[0], child_bits[1])
            return quotient if op == "bvudiv" else remainder
        if op in ("bvsdiv", "bvsrem"):
            return self._sdivrem(op, child_bits[0], child_bits[1])
        if op in ("bvshl", "bvlshr", "bvashr"):
            return self._shift(op, child_bits[0], child_bits[1])
        if op == "concat":
            out: List[int] = []
            for c, bits in zip(reversed(term.children), reversed(child_bits)):
                out.extend(bits)
            return out
        if op == "extract":
            hi, lo = term.params
            return child_bits[0][lo : hi + 1]
        if op == "zext":
            return child_bits[0] + [FALSE_LIT] * term.params[0]
        if op == "sext":
            return child_bits[0] + [child_bits[0][-1]] * term.params[0]
        if op == "ite":
            sel = self._bool(term.children[0])
            then_bits = self._bv(term.children[1])
            else_bits = self._bv(term.children[2])
            return [aig.mux(sel, t, e) for t, e in zip(then_bits, else_bits)]
        raise NotImplementedError(f"bv lowering: {op}")

    def _add(self, xs: List[int], ys: List[int], carry_in: int = FALSE_LIT) -> List[int]:
        return self._add_carry(xs, ys, carry_in)[0]

    def _add_carry(
        self, xs: List[int], ys: List[int], carry_in: int = FALSE_LIT
    ) -> Tuple[List[int], int]:
        """Ripple-carry adder returning (sum bits, carry out)."""
        aig = self.aig
        out = []
        carry = carry_in
        for x, y in zip(xs, ys):
            x_xor_y = aig.xor_gate(x, y)
            out.append(aig.xor_gate(x_xor_y, carry))
            carry = aig.or_gate(aig.and_gate(x, y), aig.and_gate(carry, x_xor_y))
        return out, carry

    def _mul(self, xs: List[int], ys: List[int]) -> List[int]:
        """Shift-and-add; constant zero partial products vanish via folding."""
        aig = self.aig
        size = len(xs)
        acc = [FALSE_LIT] * size
        for i, y in enumerate(ys):
            if y == FALSE_LIT:
                continue
            partial = [FALSE_LIT] * i + [aig.and_gate(x, y) for x in xs[: size - i]]
            acc = self._add(acc, partial)
        return acc

    def _udivrem(self, xs: List[int], ys: List[int]) -> Tuple[List[int], List[int]]:
        """Restoring division MSB-first; EVM convention: x/0 = 0, x%0 = 0."""
        aig = self.aig
        size = len(xs)
        remainder = [FALSE_LIT] * size
        quotient = [FALSE_LIT] * size
        for i in range(size - 1, -1, -1):
            remainder = [xs[i]] + remainder[:-1]  # shift left, bring down bit i
            geq = self._ult(remainder, ys) ^ 1   # remainder >= divisor
            diff = self._add(remainder, [y ^ 1 for y in ys], carry_in=TRUE_LIT)
            remainder = [aig.mux(geq, d, r) for d, r in zip(diff, remainder)]
            quotient[i] = geq
        # EVM convention: x/0 = 0 and x%0 = 0
        zero = self._eq_bits(ys, [FALSE_LIT] * size)
        quotient = [aig.and_gate(q, zero ^ 1) for q in quotient]
        remainder = [aig.and_gate(r, zero ^ 1) for r in remainder]
        return quotient, remainder

    def _sdivrem(self, op: str, xs: List[int], ys: List[int]) -> List[int]:
        aig = self.aig
        size = len(xs)
        sign_x, sign_y = xs[-1], ys[-1]
        abs_x = self._abs(xs)
        abs_y = self._abs(ys)
        quotient, remainder = self._udivrem(abs_x, abs_y)
        if op == "bvsdiv":
            neg = aig.xor_gate(sign_x, sign_y)
            result = quotient
        else:  # bvsrem takes the sign of the dividend
            neg = sign_x
            result = remainder
        negated = self._add([r ^ 1 for r in result], [TRUE_LIT] + [FALSE_LIT] * (size - 1))
        return [aig.mux(neg, n, r) for n, r in zip(negated, result)]

    def _abs(self, xs: List[int]) -> List[int]:
        aig = self.aig
        size = len(xs)
        sign = xs[-1]
        negated = self._add([x ^ 1 for x in xs], [TRUE_LIT] + [FALSE_LIT] * (size - 1))
        return [aig.mux(sign, n, x) for n, x in zip(negated, xs)]

    def _shift(self, op: str, xs: List[int], ys: List[int]) -> List[int]:
        """Barrel shifter; shift amounts >= size give 0 (or sign for ashr)."""
        aig = self.aig
        size = len(xs)
        stages = max(1, (size - 1).bit_length())
        fill = xs[-1] if op == "bvashr" else FALSE_LIT
        bits = list(xs)
        for stage in range(stages):
            amount = 1 << stage
            sel = ys[stage] if stage < len(ys) else FALSE_LIT
            if op == "bvshl":
                shifted = [fill] * min(amount, size) + bits[: max(size - amount, 0)]
            else:
                shifted = bits[amount:] + [fill] * min(amount, size)
            bits = [aig.mux(sel, s, b) for s, b in zip(shifted, bits)]
        overshoot = FALSE_LIT
        for extra_bit in ys[stages:]:
            overshoot = aig.or_gate(overshoot, extra_bit)
        return [aig.mux(overshoot, fill, b) for b in bits]
