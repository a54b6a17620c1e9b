"""The port's incremental cross-query preparation
(mythril_tpu_torch/smt/solver/incremental.py and the session strash table
of preanalysis/aig_opt.py), held to the JAX package's
tests/test_incremental_prep.py: incremental-vs-full equivalence over
randomized monotone constraint chains (the same verdicts and the same
models through _reconstruct), the new-definition and narrowing fallback
guards, cross-query strash reuse, clear_caches and term-generation
invalidation, flag and env gating, and findings parity on and off; plus
the chains' verdicts and models equal to the JAX package's."""

import json
import os
import random
import subprocess
import sys

import pytest

from mythril_tpu_torch.preanalysis import aig_opt
from mythril_tpu_torch.smt import ULT, symbol_factory, terms
from mythril_tpu_torch.smt.solver import incremental
from mythril_tpu_torch.smt.solver.frontend import Solver
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    args.reset()
    incremental.reset()
    aig_opt.reset_cache()
    monkeypatch.delenv("MYTHRIL_GPU_INCR_PREP", raising=False)
    monkeypatch.delenv("MYTHRIL_GPU_PREFIX_MEMO_MAX", raising=False)
    monkeypatch.delenv("MYTHRIL_GPU_SNAPSHOT_NODE_CAP", raising=False)
    yield
    args.reset()
    incremental.reset()
    aig_opt.reset_cache()


def _stats():
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    return stats


def _solve(constraints, on, monkeypatch, timeout=20.0):
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1" if on else "0")
    solver = Solver(timeout=timeout)
    solver.add(constraints)
    verdict = solver.check()
    model = solver.model().assignment if verdict == "sat" else None
    return verdict, model


def _chain_steps(smt, trial, rng, ult, stem="mc"):
    """One monotone chain of five constraints over three 8-bit symbols,
    built with `smt`'s symbol factory (either package's)."""
    syms = [smt.BitVecSym(f"{stem}{trial}_{i}", 8) for i in range(3)]
    chain = []
    for _step in range(5):
        kind = rng.randrange(5)
        a, b = rng.choice(syms), rng.choice(syms)
        const = smt.BitVecVal(rng.randrange(256), 8)
        if kind == 0:
            chain.append(a + b != const)
        elif kind == 1:
            chain.append((a & 0xF) == rng.randrange(16))
        elif kind == 2:
            chain.append(ult(a, const))  # narrowing-shaped bound
        elif kind == 3:
            chain.append(a == const)     # definition (fallback food)
        else:
            chain.append(a * 3 != b + const)
        yield list(chain)


# -- incremental-vs-full equivalence (property test) --------------------------


def test_monotone_chains_identical_verdicts_and_models(monkeypatch):
    """Randomized monotone constraint chains: every prefix solved with the
    layer on gives the same verdict and the same model as the full
    pipeline (the resumed pipeline emits a byte-identical instance, and
    every SAT model has passed _reconstruct's validation)."""
    rng = random.Random(0x19C4)
    stats = _stats()
    mismatches = 0
    for trial in range(25):
        for chain in _chain_steps(symbol_factory, trial, rng, ULT):
            on = _solve(chain, True, monkeypatch)
            off = _solve(chain, False, monkeypatch)
            if on != off:
                mismatches += 1
    assert mismatches == 0
    assert stats.prepare_prefix_resumes > 0, "prefix resumes never fired"
    assert stats.prepare_incremental_hits > 0, "simplify memo never hit"


def test_chain_verdicts_and_models_equal_the_reference(monkeypatch):
    """The same chains through the JAX package's Solver with its layer on,
    both on the host backend: the same verdict and the same model at
    every prefix."""
    from mythril_tpu.preanalysis import aig_opt as ref_aig_opt
    from mythril_tpu.smt import ULT as ref_ult
    from mythril_tpu.smt import symbol_factory as ref_factory
    from mythril_tpu.smt.solver import incremental as ref_incremental
    from mythril_tpu.smt.solver.frontend import Solver as RefSolver
    from mythril_tpu.support.args import args as ref_args
    from mythril_tpu.support.model import clear_caches as ref_clear
    from mythril_tpu_torch.support.model import clear_caches

    args.solver_backend = "cpu"
    ref_args.solver_backend = "cpu"

    monkeypatch.setenv("MYTHRIL_TPU_INCR_PREP", "1")
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    # both packages from cold: no memory tier or quick-sat model of an
    # earlier test may answer a prefix
    clear_caches()
    ref_clear()
    ref_incremental.reset()
    ref_aig_opt.reset_cache()
    port_rng, ref_rng = random.Random(0x5EED), random.Random(0x5EED)
    try:
        for trial in range(12):
            for port_chain, ref_chain in zip(
                    _chain_steps(symbol_factory, trial, port_rng, ULT,
                                 "mcref"),
                    _chain_steps(ref_factory, trial, ref_rng, ref_ult,
                                 "mcref")):
                port = Solver(timeout=20.0)
                port.add(port_chain)
                ref = RefSolver(timeout=20.0)
                ref.add(ref_chain)
                verdict = port.check()
                assert verdict == ref.check()
                if verdict == "sat":
                    assert port.model().assignment == \
                        ref.model().assignment
    finally:
        ref_args.reset()
        ref_clear()
        ref_incremental.reset()
        ref_aig_opt.reset_cache()


def test_resume_reuses_prefix_and_counts(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    stats = _stats()
    data = symbol_factory.BitVecSym("icp_data", 64)
    value = symbol_factory.BitVecSym("icp_value", 64)
    sender = symbol_factory.BitVecSym("icp_sender", 64)
    base = [(data >> 32) == 0x41C0E1B5,
            ULT(value, symbol_factory.BitVecVal(1 << 40, 64))]
    s1 = Solver(timeout=20.0)
    s1.add(base)
    assert s1.check() == "sat"
    assert stats.prepare_prefix_resumes == 0
    s2 = Solver(timeout=20.0)
    s2.add(base)
    s2.add(value + data != sender)
    assert s2.check() == "sat"
    assert stats.prepare_prefix_resumes == 1
    assert stats.prepare_suffix_terms == 1
    assert stats.prepare_suffix_hist.get("1") == 1
    # the resumed model still pins the selector (validated reconstruction)
    assert (s2.model().assignment["icp_data"] >> 32) == 0x41C0E1B5


# -- fallback guards ----------------------------------------------------------


def test_suffix_definition_on_prefix_symbol_falls_back(monkeypatch):
    """A suffix `sym == rhs` over a symbol the prefix residual references
    would substitute back through the lowered prefix: the guard forces the
    full pipeline (counted) and the result stays correct."""
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    stats = _stats()
    x = symbol_factory.BitVecSym("icfb_x", 16)
    y = symbol_factory.BitVecSym("icfb_y", 16)
    s1 = Solver(timeout=20.0)
    s1.add(x + y != 3)
    assert s1.check() == "sat"
    s2 = Solver(timeout=20.0)
    s2.add(x + y != 3)
    s2.add(x == 5)
    assert s2.check() == "sat"
    assert stats.prepare_prefix_fallbacks == 1
    assert stats.prepare_prefix_resumes == 0
    assert s2.model().assignment["icfb_x"] == 5


def test_suffix_narrowing_bound_on_prefix_symbol_falls_back(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    stats = _stats()
    x = symbol_factory.BitVecSym("icnb_x", 16)
    y = symbol_factory.BitVecSym("icnb_y", 16)
    s1 = Solver(timeout=20.0)
    s1.add(x + y != 3)
    assert s1.check() == "sat"
    s2 = Solver(timeout=20.0)
    s2.add(x + y != 3)
    s2.add(ULT(x, symbol_factory.BitVecVal(16, 16)))
    assert s2.check() == "sat"
    assert stats.prepare_prefix_fallbacks == 1
    assert s2.model().assignment["icnb_x"] < 16


def test_suffix_only_definition_and_bound_resume(monkeypatch):
    """Definitions and bounds over symbols the prefix never saw are handled
    incrementally: no fallback, and the substituted value reaches the
    model through the standard resolution order."""
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    stats = _stats()
    x = symbol_factory.BitVecSym("icso_x", 16)
    y = symbol_factory.BitVecSym("icso_y", 16)
    z = symbol_factory.BitVecSym("icso_z", 16)
    w = symbol_factory.BitVecSym("icso_w", 16)
    s1 = Solver(timeout=20.0)
    s1.add(x + y != 3)
    assert s1.check() == "sat"
    s2 = Solver(timeout=20.0)
    s2.add(x + y != 3)
    s2.add(z == 9)
    assert s2.check() == "sat"
    assert s2.model().assignment["icso_z"] == 9
    s3 = Solver(timeout=20.0)
    s3.add(x + y != 3)
    s3.add(z == 9)
    s3.add(ULT(w, symbol_factory.BitVecVal(16, 16)), w != 3)
    assert s3.check() == "sat"
    model = s3.model().assignment
    assert model["icso_w"] < 16 and model["icso_w"] != 3
    assert stats.prepare_prefix_fallbacks == 0
    assert stats.prepare_prefix_resumes == 2


def test_chained_definitions_substitute_to_fixpoint(monkeypatch):
    """A definition chain three deep (x == y+1, y == z+1, z == 3) leaves no
    symbol free in the residual: both pipelines fold it to the fixpoint
    and agree."""
    x = symbol_factory.BitVecSym("icchain_x", 32)
    y = symbol_factory.BitVecSym("icchain_y", 32)
    z = symbol_factory.BitVecSym("icchain_z", 32)
    w = symbol_factory.BitVecSym("icchain_w", 32)
    chain = [x == y + 1, y == z + 1, z == 3]
    for on in (False, True):
        verdict, _ = _solve(
            chain + [ULT(x * x, symbol_factory.BitVecVal(7, 32))],
            on, monkeypatch)
        assert verdict == "unsat"  # x folds to 5, 25 < 7 is false
        verdict, model = _solve(
            chain + [w == x,
                     ULT(w + x, symbol_factory.BitVecVal(100, 32))],
            on, monkeypatch)
        assert verdict == "sat"
        assert (model["icchain_z"], model["icchain_y"],
                model["icchain_x"], model["icchain_w"]) == (3, 4, 5, 5)


def test_suffix_contradiction_settles_unsat(monkeypatch):
    """A suffix term folding to False under the prefix substitutions is a
    trivial UNSAT on the resumed path (as on the full pipeline)."""
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    x = symbol_factory.BitVecSym("icuns_x", 16)
    c = symbol_factory.BitVecSym("icuns_c", 16)
    s1 = Solver(timeout=20.0)
    s1.add(x == 7, ULT(c, symbol_factory.BitVecVal(100, 16)))
    assert s1.check() == "sat"
    s2 = Solver(timeout=20.0)
    s2.add(x == 7, ULT(c, symbol_factory.BitVecVal(100, 16)))
    s2.add(x == 9)  # contradicts the prefix definition
    assert s2.check() == "unsat"


# -- session strash table -----------------------------------------------------


def test_session_strash_reuses_sibling_cones(monkeypatch):
    """Two sibling queries with different root sets but overlapping cones:
    the second rewrite reuses the first's swept and strashed gates from the
    session table (strash_xquery_merges > 0)."""
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    stats = _stats()
    data = symbol_factory.BitVecSym("icss_data", 64)
    value = symbol_factory.BitVecSym("icss_value", 64)
    sender = symbol_factory.BitVecSym("icss_sender", 64)
    s1 = Solver(timeout=20.0)
    s1.add((data >> 32) == 0x1234ABCD, value + data != 77)
    assert s1.check() == "sat"
    first = stats.strash_xquery_merges
    s2 = Solver(timeout=20.0)
    s2.add((data >> 32) == 0x1234ABCD, value + data != 77)
    s2.add(sender != 0)
    assert s2.check() == "sat"
    assert stats.strash_xquery_merges > first, \
        "sibling cone rewrote against a fresh table"


def test_session_strash_shares_one_aig_across_siblings():
    """Sibling rewrites land in one session AIG (its stable uid feeds the
    backend's pack and pad caches), and the partition stays cone-local."""
    from mythril_tpu_torch.preanalysis import aig_partition

    a = symbol_factory.BitVecSym("icsa_a", 32)
    b = symbol_factory.BitVecSym("icsa_b", 32)
    c = symbol_factory.BitVecSym("icsa_c", 32)
    s1 = Solver(timeout=20.0)
    s1.add(a + b != 3, (a & 0xF0F0) != 0)
    prep1 = s1._prepare([])
    s2 = Solver(timeout=20.0)
    s2.add(c * 3 != b + 1, (c | 1) != 9)
    prep2 = s2._prepare([])
    assert prep1.aig_roots is not None and prep2.aig_roots is not None
    if getattr(prep1.aig_roots[0], "_aig_opt_cone", False) \
            and getattr(prep2.aig_roots[0], "_aig_opt_cone", False):
        assert prep1.aig_roots[0] is prep2.aig_roots[0], \
            "sibling rewrites did not share the session AIG"
        # the partition over s1's roots holds only s1's roots
        partition = aig_partition.partition_cached(
            prep1.aig_roots[0], prep1.aig_roots[1])
        if partition is not None:
            s1_roots = set(prep1.aig_roots[1])
            for component in partition.components:
                assert set(component.roots) <= s1_roots
    assert s1._solve_prepared(prep1) == "sat"
    assert s2._solve_prepared(prep2) == "sat"


# -- invalidation -------------------------------------------------------------


def test_clear_caches_resets_prefix_memo_and_session(monkeypatch):
    """clear_caches drops the prefix memo and the session strash table
    (stale-generation entries must never resolve against a rebuilt term
    graph)."""
    from mythril_tpu_torch.support.model import clear_caches

    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    x = symbol_factory.BitVecSym("iccc_x", 32)
    y = symbol_factory.BitVecSym("iccc_y", 32)
    solver = Solver(timeout=20.0)
    solver.add((x >> 16) == 0xBEEF, x + y != 5)
    assert solver.check() == "sat"
    assert incremental._state().prefix_memo, "snapshot was not recorded"
    assert aig_opt._session is not None, "session table was not created"
    clear_caches()
    assert incremental._state_obj is None
    assert aig_opt._session is None
    # and everything still works from cold
    stats = _stats()
    solver2 = Solver(timeout=20.0)
    solver2.add((x >> 16) == 0xBEEF, x + y != 5)
    assert solver2.check() == "sat"
    assert stats.prepare_prefix_resumes == 0  # first query after the clear


def test_generation_bump_invalidates_memos(monkeypatch):
    """A term-intern clear bumps Term.generation: id-keyed memo entries
    would dangle, so the state rebuilds itself (and the session keys off
    the fresh global blaster's uid)."""
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    x = symbol_factory.BitVecSym("icgen_x", 32)
    y = symbol_factory.BitVecSym("icgen_y", 32)
    solver = Solver(timeout=20.0)
    solver.add((x >> 16) == 0xFACE, x + y != 5)
    assert solver.check() == "sat"
    state_before = incremental._state()
    assert state_before.prefix_memo
    terms.clear_intern()
    state_after = incremental._state()
    assert state_after is not state_before
    assert not state_after.prefix_memo
    assert state_after.generation == terms.Term.generation
    # re-interned terms re-prepare correctly against the rebuilt graph
    x2 = symbol_factory.BitVecSym("icgen_x", 32)
    y2 = symbol_factory.BitVecSym("icgen_y", 32)
    solver2 = Solver(timeout=20.0)
    solver2.add((x2 >> 16) == 0xFACE, x2 + y2 != 5)
    assert solver2.check() == "sat"
    assert (solver2.model().assignment["icgen_x"] >> 16) == 0xFACE


def test_prefix_memo_and_snapshot_caps_are_live_knobs(monkeypatch):
    """MYTHRIL_GPU_PREFIX_MEMO_MAX bounds the memo and
    MYTHRIL_GPU_SNAPSHOT_NODE_CAP the snapshotted lowerings, read at use
    (a tuned profile applied at start reaches them)."""
    from mythril_tpu_torch.support import env as env_mod

    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    monkeypatch.setenv("MYTHRIL_GPU_PREFIX_MEMO_MAX", "2")
    for k in range(5):
        v = symbol_factory.BitVecSym(f"iccap_{k}", 16)
        solver = Solver(timeout=20.0)
        solver.add(v + k != 3, (v & 7) != k % 8)
        assert solver.check() == "sat"
    assert 0 < len(incremental._state().prefix_memo) <= 2
    incremental.reset()
    monkeypatch.delenv("MYTHRIL_GPU_PREFIX_MEMO_MAX")
    env_mod.set_tuned({"MYTHRIL_GPU_SNAPSHOT_NODE_CAP": 0})
    try:
        solver = Solver(timeout=20.0)
        v = symbol_factory.BitVecSym("iccap_cap", 16)
        solver.add(v + 1 != 3)
        assert solver.check() == "sat"
        assert not incremental._state().prefix_memo
    finally:
        env_mod.clear_overrides()


# -- gating -------------------------------------------------------------------


def test_flag_and_env_gates(monkeypatch):
    x = symbol_factory.BitVecSym("icgate_x", 16)
    y = symbol_factory.BitVecSym("icgate_y", 16)

    def resumes_with(no_flag, env):
        args.no_incremental_prep = no_flag
        if env is None:
            monkeypatch.delenv("MYTHRIL_GPU_INCR_PREP", raising=False)
        else:
            monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", env)
        incremental.reset()
        stats = _stats()
        s1 = Solver(timeout=20.0)
        s1.add(x + y != 3)
        assert s1.check() == "sat"
        s2 = Solver(timeout=20.0)
        s2.add(x + y != 3)
        s2.add((y & 3) != 2)
        assert s2.check() == "sat"
        return stats.prepare_prefix_resumes

    assert resumes_with(False, None) > 0        # default: on
    assert resumes_with(True, None) == 0        # --no-incremental-prep
    assert resumes_with(True, "1") > 0          # env force-enable wins
    assert resumes_with(False, "0") == 0        # env force-disable wins
    args.no_preanalysis = True                  # master switch gates all
    assert resumes_with(False, "1") == 0


# -- findings parity ----------------------------------------------------------


def test_findings_parity_incremental_on_vs_off(monkeypatch):
    """The layer is invisible in the findings: the same report JSON with
    MYTHRIL_GPU_INCR_PREP on and off, and the JAX package's report with
    its layer on."""
    from tests.test_analysis import KILLBILLY
    from tests.torch_helpers import run_analyze

    stats = _stats()
    reports = {}
    for on in ("1", "0"):
        monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", on)
        reports[on] = run_analyze("mythril_tpu_torch", KILLBILLY.hex(), 1,
                                  "cpu", 60, pruning_factor=1,
                                  bin_runtime=True).as_json()
        if on == "1":
            # this one-transaction contract issues too few sibling
            # queries for a prefix resume, but the cross-query simplify
            # memo serves
            assert stats.prepare_incremental_hits > 0, \
                "the incremental layer should fire during analyze"
    monkeypatch.setenv("MYTHRIL_TPU_INCR_PREP", "1")
    reference = run_analyze("mythril_tpu", KILLBILLY.hex(), 1, "cpu", 60,
                            pruning_factor=1, bin_runtime=True).as_json()
    assert json.loads(reports["1"])["issues"]
    assert json.loads(reports["1"])["issues"] == \
        json.loads(reports["0"])["issues"]
    assert reports["1"] == reference


def test_cli_corpus_parity_incremental_on_vs_off(tmp_path):
    """The whole CLI in a child process, the layer on and off
    (--no-incremental-prep with MYTHRIL_GPU_INCR_PREP=0): the same issue
    JSON on a repo contract (KILLBILLY's creation code, two
    transactions)."""
    from tests.test_analysis import KILLBILLY, wrap_creation

    code = tmp_path / "killbilly.hex"
    code.write_text(wrap_creation(KILLBILLY))
    outputs = []
    for env_value, flags in (("1", ()), ("0", ("--no-incremental-prep",))):
        cmd = [sys.executable, "-m", "mythril_tpu_torch", "analyze",
               "-f", str(code), "-t", "2", "-o", "json",
               "--solver-timeout", "60000", "--solver-backend", "cpu"] \
            + list(flags)
        env = dict(os.environ)
        env["MYTHRIL_GPU_INCR_PREP"] = env_value
        env["MYTHRIL_GPU_AUTOTUNE"] = "0"
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=REPO_ROOT, env=env)
        assert proc.returncode == 1, proc.stderr[-2000:]
        outputs.append(
            json.loads(proc.stdout.strip().splitlines()[-1])["issues"])
    assert outputs[0] and outputs[0] == outputs[1]
