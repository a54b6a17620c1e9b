"""The generator: the same seed gives the same stream and windows, windows
share no query, and a selector redraw keeps the dispatcher's order and
carries every pinned finding to its function's new selector."""

import sys

import pytest

from port_bench import generate, spec
from port_bench.reference import words

SEEDS = (0, 7, 2 ** 31 + 11, 98765432109876)
WINDOW_CELLS = ("upstream-siblings64",)


def _pool_source():
    return generate.ContractSource(spec.load_cell("upstream-pool4").config)


@pytest.mark.parametrize("seed", SEEDS)
def test_contract_stream_repeats_for_a_seed(seed):
    source = _pool_source()
    first = [source.task(seed, index) for index in range(12)]
    assert first == [source.task(seed, index) for index in range(12)]
    assert len({task.code for task in first}) == 12   # no two alike


@pytest.mark.parametrize("seed", SEEDS)
def test_every_round_holds_each_contract_once(seed):
    source = _pool_source()
    names = sorted(c[0] for c in source.contracts)
    for start in range(0, 16, 4):
        assert sorted(source.task(seed, index).name
                      for index in range(start, start + 4)) == names


@pytest.mark.parametrize("cell", WINDOW_CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_windows_repeat_and_share_no_query(cell, seed):
    mix = spec.load_cell(cell).mix
    windows = [generate.query_window(mix, seed, index) for index in range(6)]
    assert windows[0] == generate.query_window(mix, seed, 0)
    atoms = [query.atoms for window in windows for query in window]
    assert len(atoms) == 6 * mix["window"]
    assert len(set(atoms)) == len(atoms)
    for window in windows:
        assert [q.unsat for q in window].count(True) \
            == mix["window"] // mix["unsat_every"]


@pytest.mark.parametrize("cell", WINDOW_CELLS)
def test_every_query_is_decided_by_the_reference(cell):
    mix = spec.load_cell(cell).mix
    for seed in SEEDS:
        for query in generate.query_window(mix, seed, 3):
            verdict = words.decide(query.atoms, query.witness)
            assert verdict == ("unsat" if query.unsat else "sat")


def test_a_new_shape_needs_no_edit(tmp_path, monkeypatch):
    """A mix that names a shape added as a file of its own under shapes/
    is generated and decided with no other file touched."""
    from port_bench import shapes

    (tmp_path / "throwaway_ne.py").write_text(
        "from port_bench.generate import const, var\n\n\n"
        "def branch(i, rng):\n"
        "    x = var(f'slot_{i}')\n"
        "    return ('ne', x, const(7)), {x[1]: 8}\n")
    monkeypatch.setattr(shapes, "__path__",
                        [*shapes.__path__, str(tmp_path)])
    mix = {"kind": "solve_windows", "window": 6, "unsat_every": 3,
           "patterns": [["throwaway_ne"], ["gt_bound", "throwaway_ne"]]}
    try:
        window = generate.query_window(mix, 11, 0)
    finally:
        sys.modules.pop("port_bench.shapes.throwaway_ne", None)
    assert [words.decide(q.atoms, q.witness) for q in window] \
        == ["sat", "sat", "unsat"] * 2
    assert window[1].atoms[-2][0] == "ugt" and window[1].atoms[-1][0] == "ne"


@pytest.mark.parametrize("seed", SEEDS)
def test_redraw_keeps_the_order_and_maps_the_findings(seed):
    source = _pool_source()
    for index in range(8):
        task = source.task(seed, index)
        name, code, _tx, sites, pins = next(
            c for c in source.contracts if c[0] == task.name)
        redrawn = bytes.fromhex(task.code)
        assert len(redrawn) == len(code)
        changed = [i for i, (a, b) in enumerate(zip(code, redrawn)) if a != b]
        site_bytes = {offset + k for offset, _sel in sites
                      for k in range(1, 5)}
        assert set(changed) <= site_bytes
        old = [int(sel, 16) for _offset, sel in sites]
        new = [int.from_bytes(redrawn[offset + 1: offset + 5], "big")
               for offset, _sel in sites]
        # the dispatcher's order kept, every selector new
        assert sorted(range(len(old)), key=old.__getitem__) \
            == sorted(range(len(new)), key=new.__getitem__)
        assert not set(old) & set(new)
        mapping = dict(zip(old, new))
        assert task.expected == tuple(sorted(
            (pin["swc"], "_function_0x%08x" % mapping[int(pin["selector"],
                                                          16)],
             pin["address"]) for pin in pins))


def test_redraw_refuses_a_site_that_is_not_there():
    with pytest.raises(ValueError):
        generate.redraw_selectors(bytes(16), [[2, "12345678"]],
                                  generate._rng("x"))
