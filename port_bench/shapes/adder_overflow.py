"""sibling_window's adder-overflow branch, taken: storage + calldata wraps
below storage (a + b < a)."""

from port_bench.generate import MASK, var


def branch(i, rng):
    a, b = var(f"storage_a_{i}"), var(f"calldata_{i + 1}")
    return ("ult", ("add", a, b), a), {a[1]: MASK, b[1]: 1}
