"""Seeded windows of sibling-path feasibility queries at EVM width, and
seeded random cones for the ragged round.

The query shapes LASER's forks send to get_models_batch: a 256-bit
function-selector dispatch on the first calldata word, `callvalue < 2**40`,
`caller != 0`, an adder-overflow branch `a + b < a`, a comparison branch
`x > 0x1000`, and infeasible siblings (both sides of one comparison).
fork_window builds the two sides of batched JUMPI forks: a shared prefix
plus the jump condition word `!= 0` on one side and `== 0` on the other.
`smt` is an SMT package with the mythril_tpu.smt API (this package's own,
or the JAX package's when a test holds the two against each other), so the
same seed builds the same constraint sets in either.

random_cones and big_cone build packed AIG cones directly (no SMT layer):
small cones for kernel windows, and one cone too large for the ragged
kernel's shared-memory path.
"""

import random
from typing import List

WIDTH = 256


def sibling_window(smt, count: int, seed: int = 0,
                   unsat_every: int = 8) -> List[list]:
    """`count` constraint lists; every `unsat_every`-th one is UNSAT."""
    sf = smt.symbol_factory
    rng = random.Random(seed)
    calldata = sf.BitVecSym("calldata_0", WIDTH)
    callvalue = sf.BitVecSym("callvalue", WIDTH)
    caller = sf.BitVecSym("caller", WIDTH)
    prefix = [
        smt.ULT(callvalue, sf.BitVecVal(2 ** 40, WIDTH)),
        caller != sf.BitVecVal(0, WIDTH),
    ]
    window = []
    for i in range(count):
        selector = sf.BitVecVal(rng.getrandbits(32), 32)
        dispatch = smt.Extract(WIDTH - 1, WIDTH - 32, calldata) == selector
        a = sf.BitVecSym(f"storage_a_{i}", WIDTH)
        b = sf.BitVecSym(f"calldata_{i + 1}", WIDTH)
        x = sf.BitVecSym(f"balance_{i}", WIDTH)
        bound = sf.BitVecVal(0x1000 + rng.getrandbits(16), WIDTH)
        kind = i % 3
        if kind == 0:
            branch = [smt.ULT(a + b, a)]            # adder overflow
        elif kind == 1:
            branch = [smt.UGT(x, bound)]            # comparison branch
        else:
            branch = [smt.ULT(a + b, a), smt.UGT(x, bound)]
        if unsat_every and i % unsat_every == unsat_every - 1:
            # the infeasible sibling: both sides of the comparison
            branch = branch + [smt.ULE(x, bound), smt.UGT(x, bound)]
        window.append(list(prefix) + [dispatch] + branch)
    return window


def fork_window(smt, pairs: int, seed: int = 0, unsat_every: int = 4):
    """(constraint lists, (taken, fall) index pairs) of `pairs` JUMPI forks.

    Each pair shares its prefix — selector dispatch, `callvalue < 2**40`,
    `caller != 0` and a comparison branch — and forks on the word
    `If(a + b < a, 1, 0)`: the taken side asserts it `!= 0`, the fall side
    `== 0`, so both lower to one boolean at opposite polarity. In every
    `unsat_every`-th pair the prefix bounds a and b below 2**16, which makes
    the taken side infeasible."""
    sf = smt.symbol_factory
    rng = random.Random(seed)
    calldata = sf.BitVecSym("calldata_0", WIDTH)
    callvalue = sf.BitVecSym("callvalue", WIDTH)
    caller = sf.BitVecSym("caller", WIDTH)
    one, zero = sf.BitVecVal(1, WIDTH), sf.BitVecVal(0, WIDTH)
    sets, index_pairs = [], []
    for i in range(pairs):
        selector = sf.BitVecVal(rng.getrandbits(32), 32)
        a = sf.BitVecSym(f"storage_a_{i}", WIDTH)
        b = sf.BitVecSym(f"calldata_{i + 1}", WIDTH)
        x = sf.BitVecSym(f"balance_{i}", WIDTH)
        bound = sf.BitVecVal(0x1000 + rng.getrandbits(16), WIDTH)
        prefix = [
            smt.ULT(callvalue, sf.BitVecVal(2 ** 40, WIDTH)),
            caller != zero,
            smt.Extract(WIDTH - 1, WIDTH - 32, calldata) == selector,
            smt.UGT(x, bound),
        ]
        if unsat_every and i % unsat_every == unsat_every - 1:
            limit = sf.BitVecVal(2 ** 16, WIDTH)
            prefix += [smt.ULT(a, limit), smt.ULT(b, limit)]
        word = smt.If(smt.ULT(a + b, a), one, zero)
        index_pairs.append((len(sets), len(sets) + 1))
        sets.append(prefix + [word != zero])
        sets.append(prefix + [word == zero])
    return sets, index_pairs


def random_cones(rng: random.Random, count: int) -> list:
    """`count` packed cones of 4-12 inputs and 20-80 random AND gates
    (inputs negated at random), each asserting its last gate."""
    from mythril_tpu_torch.gpu.circuit import PackedCircuit
    from mythril_tpu_torch.smt.bitblast import AIG

    cones = []
    while len(cones) < count:
        aig = AIG()
        lits = [aig.lit_of_var(aig.new_var())
                for _ in range(rng.randint(4, 12))]
        for _ in range(rng.randint(20, 80)):
            lits.append(aig.and_gate(rng.choice(lits) ^ rng.randint(0, 1),
                                     rng.choice(lits) ^ rng.randint(0, 1)))
        pc = PackedCircuit(aig, [lits[-1]])
        if pc.ok:
            cones.append(pc)
    return cones


def big_cone(rng: random.Random, gates: int = 30000, inputs: int = 64,
             reach: int = 2048, roots: int = 32):
    """A packed cone of about 20,000 variables over some 80 levels: each
    gate reads two of the `reach` literals before it, and the last `roots`
    gates are asserted, each negated at random."""
    from mythril_tpu_torch.gpu.circuit import PackedCircuit
    from mythril_tpu_torch.smt.bitblast import AIG

    while True:
        aig = AIG()
        lits = [aig.lit_of_var(aig.new_var()) for _ in range(inputs)]
        for _ in range(gates):
            low = max(0, len(lits) - reach)
            lits.append(aig.and_gate(
                lits[rng.randrange(low, len(lits))] ^ rng.randint(0, 1),
                lits[rng.randrange(low, len(lits))] ^ rng.randint(0, 1)))
        pc = PackedCircuit(aig, [lit ^ rng.randint(0, 1)
                                 for lit in lits[-roots:]])
        if pc.ok:
            return pc
