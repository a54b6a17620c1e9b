"""The plain reference: it accepts a model that satisfies a query, rejects
one with a bit flipped, proves the planted siblings UNSAT, and holds a
report to its pinned findings."""

import pytest

from port_bench import generate, spec
from port_bench.reference import findings, words


def _window(cell, seed=5):
    return generate.query_window(spec.load_cell(cell).mix, seed, 0)


@pytest.mark.parametrize("cell", ["upstream-siblings64"])
def test_a_known_model_passes_and_a_flipped_bit_fails(cell):
    for query in _window(cell):
        if query.unsat:
            continue
        assert words.judge(query.atoms, "sat", "sat", query.witness) is None
        flipped = dict(query.witness)
        flipped["calldata_0"] ^= 1 << 224       # the selector's low bit
        assert words.judge(query.atoms, "sat", "sat", flipped) is not None


@pytest.mark.parametrize("cell", ["upstream-siblings64"])
def test_verdicts_are_judged(cell):
    for query in _window(cell):
        verdict = words.decide(query.atoms, query.witness)
        assert words.judge(query.atoms, verdict, "unknown", None) is not None
        if query.unsat:
            assert words.judge(query.atoms, verdict, "unsat", None) is None
            assert words.judge(query.atoms, verdict, "sat", {}) is not None
        else:
            assert words.judge(query.atoms, verdict, "unsat", None) \
                is not None


def test_word_arithmetic_wraps_at_256_bits():
    a, b = generate.var("a"), generate.var("b")
    top = (1 << 256) - 1
    assert words.value(("add", a, b), {"a": top, "b": 2}) == 1
    assert words.value(("extract", 255, 224, a), {"a": 0xABCD << 240}) \
        == 0xABCD0000
    assert words.holds([("ult", ("add", a, b), a)], {"a": top, "b": 1})
    assert not words.holds([("ult", ("add", a, b), a)], {"a": 3, "b": 1})
    assert words.unsat_proof([("ugt", a, b), ("ule", a, b)])
    assert not words.unsat_proof([("ugt", a, b), ("ule", b, a)])


def test_reports_against_the_pins():
    expected = (("106", "_function_0x11223344", 146),)
    assert findings.judge(expected, list(expected)) is None
    assert findings.judge(expected, []) is not None
    assert findings.judge(expected, [("106", "_function_0x11223345", 146)]) \
        is not None
    assert findings.judge(expected, list(expected) * 2) is not None
    assert findings.judge(expected, list(expected), errors=1) is not None
