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
kernel's shared-memory path; circuit_batch pads small cones into a batch
of the bucketed path's round.

frontier_program and frontier_frame build what the batched frontier step
(K6) takes: seeded random straight-line programs over the fast set (the
generator of the JAX package's tests/test_frontier.py, same draws for the
same seed when `edge_bias` is 0), and dense frames of sibling rows for a
compiled run.
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


def circuit_batch(rng: random.Random, max_queries: int = 16,
                  min_v1: int = 0) -> dict:
    """A numpy batch of the bucketed path's round (K3): 1-max_queries
    random cones asserting 1-4 of their last gates, each negated at
    random, padded to one shape a little past the largest cone (at least
    `min_v1` variables), the query axis to a power of two whose spare
    slots are all zeros."""
    from mythril_tpu_torch.gpu.circuit import PackedCircuit
    from mythril_tpu_torch.gpu.circuit_kernel import stack_padded
    from mythril_tpu_torch.smt.bitblast import AIG

    count, pcs = rng.randint(1, max_queries), []
    while len(pcs) < count:
        aig = AIG()
        lits = [aig.lit_of_var(aig.new_var())
                for _ in range(rng.randint(4, 12))]
        for _ in range(rng.randint(20, 80)):
            lits.append(aig.and_gate(rng.choice(lits) ^ rng.randint(0, 1),
                                     rng.choice(lits) ^ rng.randint(0, 1)))
        pc = PackedCircuit(aig, [lit ^ rng.randint(0, 1) for lit
                                 in lits[-rng.randint(1, 4):]])
        if pc.ok:
            pcs.append(pc)
    shape = (max(pc.num_levels for pc in pcs) + rng.randint(0, 3),
             max(pc.max_width for pc in pcs) + rng.randint(0, 5),
             max(max(pc.v1 for pc in pcs) + rng.randint(0, 40), min_v1),
             max(pc.num_roots for pc in pcs) + rng.randint(0, 2))
    slots = 1
    while slots < len(pcs):
        slots *= 2
    return stack_padded(pcs, shape, slots)


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


def deep_cone(rng: random.Random, gates: int = 24000, reach: int = 48,
              inputs: int = 64, roots: int = 16):
    """big_cone's deeper twin: at the defaults a packed cone of some 13,000
    variables over about 1,000 levels (the depth of the bucketed analyze
    runs' largest batches). Each gate reads one of the `reach` literals
    before it and one from anywhere before it, never one variable twice;
    a gate that folds to a constant is dropped, so the circuit does not
    collapse. The last `roots` gates are asserted, each negated at
    random."""
    from mythril_tpu_torch.gpu.circuit import PackedCircuit
    from mythril_tpu_torch.smt.bitblast import AIG

    aig = AIG()
    lits = [aig.lit_of_var(aig.new_var()) for _ in range(inputs)]
    for _ in range(gates):
        while True:
            a = lits[rng.randrange(max(0, len(lits) - reach), len(lits))] \
                ^ rng.randint(0, 1)
            b = lits[rng.randrange(len(lits))] ^ rng.randint(0, 1)
            if a >> 1 != b >> 1:
                break
        gate = aig.and_gate(a, b)
        if gate > 1:
            lits.append(gate)
    pc = PackedCircuit(aig, [lit ^ rng.randint(0, 1)
                             for lit in lits[-roots:]])
    if not pc.ok:
        raise ValueError(f"deep_cone({gates}, reach {reach}) is past the "
                         f"device caps")
    return pc


def deep_batch(rng: random.Random, cones: int = 3, min_v1: int = 0,
               **cone_args) -> dict:
    """A numpy batch of K3's round of `cones` deep_cone cones (cone_args
    passed on), padded to their largest shape and at least `min_v1`
    variables, the query axis to a power of two whose spare slots are all
    zeros."""
    from mythril_tpu_torch.gpu.circuit_kernel import stack_padded

    pcs = [deep_cone(rng, **cone_args) for _ in range(cones)]
    shape = (max(pc.num_levels for pc in pcs),
             max(pc.max_width for pc in pcs),
             max(max(pc.v1 for pc in pcs), min_v1),
             max(pc.num_roots for pc in pcs))
    slots = 1
    while slots < len(pcs):
        slots *= 2
    return stack_padded(pcs, shape, slots)


# -- straight-line frontier programs -------------------------------------------

FRONTIER_BIN_BYTES = {
    "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "SIGNEXTEND": 0x0B,
    "DIV": 0x04, "SDIV": 0x05, "MOD": 0x06, "SMOD": 0x07,
    "LT": 0x10, "GT": 0x11, "SLT": 0x12, "SGT": 0x13, "EQ": 0x14,
    "AND": 0x16, "OR": 0x17, "XOR": 0x18, "BYTE": 0x1A,
    "SHL": 0x1B, "SHR": 0x1C, "SAR": 0x1D,
}
# the words where 256-bit arithmetic goes wrong first
EDGE_WORDS = (0, 1, 2, (1 << 255) - 1, 1 << 255, (1 << 256) - 1)


def push_bytes(value: int, width: int = None) -> bytes:
    """PUSHn of `value` (the shortest width when none is given)."""
    if width is None:
        width = max(1, (value.bit_length() + 7) // 8)
    return bytes([0x60 + width - 1]) + value.to_bytes(width, "big")


def frontier_program(rng: random.Random, allow_huge_offsets: bool = False,
                     edge_bias: float = 0.0):
    """(code bytes, initial stack ints): straight-line, fast-set only,
    ending in STOP. Memory offsets are pushed constants (small by default
    so runs complete; huge to exercise the bail path). With `edge_bias`,
    that share of the pushed and initial words are EDGE_WORDS, so DIV,
    SDIV, MOD, SMOD, MUL and the shifts meet 0, 1, 2^255 and 2^256 - 1;
    shift amounts and positions already lean to 0-300."""

    def word(bits: int) -> int:
        if edge_bias and rng.random() < edge_bias:
            return rng.choice(EDGE_WORDS)
        return rng.getrandbits(bits)

    depth = rng.randrange(0, 6)
    init_stack = [word(256) for _ in range(depth)]
    sim_depth = depth
    body = b""
    n_ops = rng.randrange(3, 22)
    emitted = 0
    while emitted < n_ops:
        roll = rng.random()
        if roll < 0.28 or sim_depth == 0:
            if rng.random() < 0.5:
                body += push_bytes(word(rng.choice((8, 16, 64, 256))))
            else:
                body += push_bytes(rng.randrange(0, 512))
            sim_depth += 1
        elif roll < 0.40 and sim_depth >= 1:
            n = rng.randrange(1, min(sim_depth, 16) + 1)
            body += bytes([0x80 + n - 1])
            sim_depth += 1
        elif roll < 0.50 and sim_depth >= 2:
            n = rng.randrange(1, min(sim_depth - 1, 16) + 1)
            body += bytes([0x90 + n - 1])
        elif roll < 0.56 and sim_depth >= 1:
            body += bytes([0x50])  # POP
            sim_depth -= 1
        elif roll < 0.62 and sim_depth >= 1:
            body += bytes([rng.choice((0x15, 0x19))])  # ISZERO / NOT
        elif roll < 0.70:
            body += bytes([rng.choice((0x58, 0x59, 0x5B))])  # PC/MSIZE/JD
            if body[-1] != 0x5B:
                sim_depth += 1
        elif roll < 0.80 and sim_depth >= 1:
            # MSTORE/MSTORE8 with a pushed offset over an existing value
            offset = (rng.randrange(0, 1 << 250) if allow_huge_offsets
                      and rng.random() < 0.5
                      else rng.randrange(0, 1024))
            body += push_bytes(offset) + bytes([rng.choice((0x52, 0x53))])
            sim_depth -= 1
            emitted += 1
        elif roll < 0.88:
            offset = (rng.randrange(0, 1 << 250) if allow_huge_offsets
                      and rng.random() < 0.5
                      else rng.randrange(0, 1024))
            body += push_bytes(offset) + bytes([0x51])  # MLOAD
            sim_depth += 1
            emitted += 1
        elif sim_depth >= 2:
            name = rng.choice(list(FRONTIER_BIN_BYTES))
            if name in ("SHL", "SHR", "SAR", "BYTE", "SIGNEXTEND") \
                    and rng.random() < 0.6:
                # bias toward meaningful small shift amounts / positions
                body += push_bytes(rng.randrange(0, 300))
                sim_depth += 1
                if sim_depth < 2:
                    continue
            body += bytes([FRONTIER_BIN_BYTES[name]])
            sim_depth -= 1
        else:
            continue
        emitted += 1
    return body + b"\x00", init_stack  # STOP terminator


def frontier_run(code: bytes):
    """The straight-line run at pc 0 of `code` with no engine hooks (the
    JUMPI fork, halts and CALLDATALOAD left out), or None."""
    from mythril_tpu_torch import preanalysis
    from mythril_tpu_torch.disasm import Disassembly
    from mythril_tpu_torch.laser.frontier import fastset

    summary = preanalysis.get_code_summary(Disassembly(code))
    if summary is None:
        return None
    return fastset.extract_run(summary, 0, lambda name: False,
                               lambda name: False)


def frontier_frame(rng: random.Random, run, rows: int, init_stack=(),
                   edge_bias: float = 0.0, starved_share: float = 0.1):
    """A DenseFrontier of `rows` sibling rows for `run`: row 0's window is
    `init_stack` (padded with random words), the others random words (a
    share of them EDGE_WORDS); memory holds random bytes below a random
    msize; a `starved_share` of the rows gets a gas limit the run may
    pass, so the ok mask has both values."""
    import numpy as np

    from mythril_tpu_torch.laser.frontier import dense

    frame = dense.DenseFrontier(rows, run.touch, run.window)
    for i in range(rows):
        values = (list(init_stack)[max(len(init_stack) - run.touch, 0):]
                  if i == 0 and run.touch else [])
        while len(values) < run.touch:
            values.insert(0, rng.choice(EDGE_WORDS)
                          if edge_bias and rng.random() < edge_bias
                          else rng.getrandbits(256))
        for j, value in enumerate(values):
            frame.stack[i, j] = np.frombuffer(value.to_bytes(32, "big"),
                                              dtype=np.uint8)
        msize = 0
        if run.has_mem:
            msize = 32 * rng.randrange(0, run.window // 32 + 1)
            frame.mem[i, :msize] = np.frombuffer(
                rng.randbytes(msize), dtype=np.uint8)
        frame.msize[i] = msize
        frame.min_gas[i] = rng.randrange(0, 5000)
        frame.max_gas[i] = frame.min_gas[i] + rng.randrange(0, 5000)
        frame.gas_limit[i] = (frame.min_gas[i] + rng.randrange(0, 400)
                              if rng.random() < starved_share
                              else 8_000_000)
        frame.live[i] = True
    return frame
