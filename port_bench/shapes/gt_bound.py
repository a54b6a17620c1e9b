"""sibling_window's comparison branch, taken: a balance above a bound
drawn from the window's generator (x > bound)."""

from port_bench.generate import const, var


def branch(i, rng):
    x = var(f"balance_{i}")
    bound = 0x1000 + rng.getrandbits(16)
    return ("ugt", x, const(bound)), {x[1]: bound + 1}
