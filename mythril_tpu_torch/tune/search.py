"""Measured schedule search over the knob space
(`python -m mythril_tpu_torch autotune`; mythril_tpu.tune.search).

Candidate configurations are measured against a bounded probe workload
(the committed corpus by default) and the platform's winner persists
beside the calibration entries. In order:

  soundness   a findings-parity guard: a candidate whose probe findings
              are not byte-identical to the default configuration's is
              rejected and counted (autotune_rejected_parity), and its
              wall never ranks. A tuned profile can make the analyzer
              faster, never different. A reject whose witness-masked rows
              still match is reported as witness drift (an equally valid
              model), rejected all the same.
  direction   candidates come knob by knob in the order of the baseline
              run's `sol_gaps` roofline ranking (space.gap_ordered), so
              the budget goes where the measured recoverable seconds are.
  bound       every candidate runs in a child process under a wall budget
              (a pathological configuration times out and is rejected);
              successive halving re-measures only the faster half.
  provenance  the persisted profile carries the probe's digest, the git
              revision, the platform, each knob's before and after, and
              the measured delta; a later search on the same probe is
              answered by the profile (--force searches again).

The children are `python -m mythril_tpu_torch analyze` runs on the device
path (--solver-backend gpu): on the card they launch K1 (the default
`pallas` mode), K2 (the MYTHRIL_GPU_KERNEL=xla candidate, and K1's
capacity fallback) and K6 (the frontier). The parent builds those kernels
before the baseline, so no child's wall pays nvcc. With no card and no
device named the baseline child exits 2 and the search answers
baseline_failed: it never moves to the CPU unasked.

The objective is the probe's end-to-end analyze wall (the solver wall is
reported beside it). A winner persists only if its mean wall beats the
baseline's by more than --min-delta and by more than the spread of the
baseline's own walls (the first run and each halving round's rebase).
"""

import glob
import hashlib
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from mythril_tpu_torch.support.env import env_float, env_int
from mythril_tpu_torch.tune import (
    AUTOTUNE_ENV,
    BUDGET_ENV,
    CANDIDATES_ENV,
    MIN_DELTA_ENV,
    default_platform,
)

log = logging.getLogger(__name__)

DEFAULT_BUDGET_S = 180.0     # a candidate child's wall budget
DEFAULT_CANDIDATES = 8
DEFAULT_ROUNDS = 2           # successive-halving measurement rounds
# least relative improvement over the baseline before a winner persists:
# below it the delta is the probe's noise, and a noise-tuned profile
# would change at every search
DEFAULT_MIN_DELTA = 0.02


class Measurement(NamedTuple):
    ok: bool
    wall_s: float
    solver_wall_s: float
    findings: Tuple[str, ...]   # the full per-issue JSON, sorted (guard)
    canonical: Tuple[str, ...]  # witness-masked rows (diagnosis only)
    stats: dict
    fail: str                   # "" | timeout | rc=N | unparseable


def _canonical_findings(issues) -> Tuple[str, ...]:
    """Witness-masked rows: another schedule may pick another, equally
    valid witness (a transaction step's input, value and origin are the
    solver's choice)."""
    issues = json.loads(json.dumps(issues))
    for issue in issues:
        for step in (issue.get("tx_sequence") or {}).get("steps", ()):
            step["input"] = f"<{len(step.get('input', '')) // 2}B>"
            step["value"] = "<witness>"
            step["origin"] = "<witness>"
    return tuple(sorted(
        json.dumps(issue, sort_keys=True) for issue in issues))


class Candidate:
    __slots__ = ("knobs", "label", "stage", "walls", "parity_ok",
                 "witness_drift", "fail")

    def __init__(self, knobs: Dict[str, object], label: str, stage: str):
        self.knobs = knobs
        self.label = label
        self.stage = stage
        self.walls: List[float] = []
        self.parity_ok = True
        self.witness_drift = False  # a parity reject whose witness-masked
        #   rows still matched (a benign model choice)
        self.fail = ""

    @property
    def mean_wall(self) -> float:
        return sum(self.walls) / len(self.walls) if self.walls else math.inf


def default_probe_inputs(repo_root: Optional[str] = None) -> List[str]:
    """The committed probe corpus, bench_inputs/corpus/*.hex, cut to its
    first two files: the probe runs once a candidate."""
    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    files = sorted(glob.glob(
        os.path.join(root, "bench_inputs", "corpus", "*.hex")))
    return files[:2]


def probe_digest(paths: Sequence[str], tx_count: int,
                 extra_args: Sequence[str] = ()) -> str:
    """Content digest of the probe workload: the provenance key of what a
    tuned profile's delta was measured on."""
    digest = hashlib.sha256()
    digest.update(f"t{tx_count}|{','.join(extra_args)}".encode())
    for path in paths:
        try:
            with open(path, "rb") as fd:
                digest.update(fd.read())
        except OSError:
            digest.update(f"missing:{os.path.basename(path)}".encode())
    return digest.hexdigest()[:16]


def subprocess_runner(inputs: Sequence[str], tx_count: int,
                      extra_args: Sequence[str], knobs: Dict[str, object],
                      budget_s: float) -> Measurement:
    """One probe run in a child process: the candidate's knobs ride as env
    vars (the seam a tuned profile uses), and MYTHRIL_GPU_AUTOTUNE=0 pins
    the child to exactly the candidate's configuration (a persisted
    profile must not stack under the measurement). `extra_args` carry the
    solver backend and, when the search named one, the torch device."""
    argv = [sys.executable, "-m", "mythril_tpu_torch", "analyze"]
    for path in inputs:
        argv += ["-f", path]
    argv += ["-t", str(tx_count), "-o", "json", "--solver-timeout", "10000"]
    argv += list(extra_args)
    fd, stats_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    env = {**os.environ,
           AUTOTUNE_ENV: "0",
           "MYTHRIL_GPU_STATS_JSON": stats_path,
           **{name: str(value) for name, value in knobs.items()}}
    start = time.monotonic()
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=budget_s, env=env)
    except subprocess.TimeoutExpired:
        return Measurement(False, budget_s, 0.0, (), (), {}, "timeout")
    except (OSError, subprocess.SubprocessError) as error:
        return Measurement(False, 0.0, 0.0, (), (), {},
                           f"oserror:{error}")
    finally:
        stats = {}
        try:
            with open(stats_path) as handle:
                stats = json.load(handle)
        except (OSError, ValueError):
            stats = {}
        try:
            os.unlink(stats_path)
        except OSError:
            pass
    wall = time.monotonic() - start
    label = ",".join(f"{k}={v}" for k, v in knobs.items()) or "baseline"
    # one line a child (the CLI's -v 4 shows it): what each measurement
    # cost, beside K1's solve rounds in it
    log.info("autotune child %s: rc=%d wall=%.3f s solver=%s s "
             "k1_solve_rounds=%s", label, proc.returncode, wall,
             stats.get("solver_time"), stats.get("kernel_launches"))
    if proc.returncode not in (0, 1):   # 1: issues found (a success)
        log.warning("autotune child %s exited %d: %s", label,
                    proc.returncode, proc.stderr[-500:])
        return Measurement(False, wall, 0.0, (), (), stats,
                           f"rc={proc.returncode}")
    try:
        issues = json.loads(proc.stdout.strip().splitlines()[-1])["issues"]
        findings = tuple(sorted(
            json.dumps(issue, sort_keys=True) for issue in issues))
    except Exception:
        return Measurement(False, wall, 0.0, (), (), stats, "unparseable")
    return Measurement(True, wall,
                       float(stats.get("solver_time", 0.0) or 0.0),
                       findings, _canonical_findings(issues), stats, "")


def propose_candidates(gap_stages: Sequence[str],
                       limit: int) -> List[Candidate]:
    """Single-knob candidates in gap order: the knobs of the baseline's
    top sol_gaps stages first, each with its registered values (a value
    equal to the knob's resolved setting is skipped: a no-op cannot
    win)."""
    from mythril_tpu_torch.support.env import resolve_source
    from mythril_tpu_torch.tune import space

    out: List[Candidate] = []
    for knob in space.gap_ordered(gap_stages):
        current, _source = resolve_source(knob.env, knob.default, knob.kind)
        for value in knob.candidates:
            if current is not None and value == current:
                continue
            out.append(Candidate({knob.env: value},
                                 f"{knob.env}={value}", knob.stage))
            if len(out) >= limit:
                return out
    return out


def _already_tuned(platform: str, digest: str, force: bool):
    """The summary answering the search from an existing profile of this
    platform and probe, or None (search)."""
    from mythril_tpu_torch.service.calibration import load_tuned

    existing, _reject = load_tuned(platform)
    if existing is None or force or existing.get("probe_digest") != digest:
        return None
    return {"autotune": "already_tuned", "platform": platform,
            "probe_digest": digest, "knobs": existing.get("knobs"),
            "tuned_at": existing.get("tuned_at"),
            "delta_frac": existing.get("delta_frac")}


def run_search(inputs: Sequence[str], tx_count: int,
               extra_args: Sequence[str] = (),
               candidates: Optional[int] = None,
               budget_s: Optional[float] = None,
               rounds: int = DEFAULT_ROUNDS,
               min_delta: Optional[float] = None,
               force: bool = False,
               runner=subprocess_runner,
               platform: Optional[str] = None) -> dict:
    """The whole search: baseline -> gap-directed candidates -> successive
    halving -> a parity-guarded winner -> the persisted profile. `runner`
    is injectable (tests measure without children). Returns the summary
    the CLI prints."""
    from mythril_tpu_torch.observe import metrics
    from mythril_tpu_torch.service.calibration import save_tuned
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.tune import space

    stats = SolverStatistics()
    n_candidates = candidates if candidates is not None else env_int(
        CANDIDATES_ENV, DEFAULT_CANDIDATES)
    budget = budget_s if budget_s is not None else env_float(
        BUDGET_ENV, DEFAULT_BUDGET_S)
    min_improvement = min_delta if min_delta is not None else env_float(
        MIN_DELTA_ENV, DEFAULT_MIN_DELTA)
    rounds = max(1, rounds)
    digest = probe_digest(inputs, tx_count, extra_args)
    # this process's guess only gates the skip; the baseline child's stamp
    # is the platform the profile is keyed by
    guess_platform = platform or default_platform() or "cpu"

    # an existing profile for the same probe answers the search: a second
    # call loads, it does not measure again (--force searches)
    answered = _already_tuned(guess_platform, digest, force)
    if answered is not None:
        return answered

    baseline = runner(inputs, tx_count, extra_args, {}, budget)
    if not baseline.ok:
        return {"autotune": "baseline_failed", "fail": baseline.fail}
    measured_platform = baseline.stats.get("platform") or guess_platform
    if measured_platform != guess_platform:
        # the child's stamp is authoritative: check the skip again under
        # the platform the profile is keyed by
        answered = _already_tuned(measured_platform, digest, force)
        if answered is not None:
            return answered
    baseline_walls = [baseline.wall_s]
    gap_stages = [row.get("stage") for row in _gap_rows(baseline.stats)]

    pool = propose_candidates(gap_stages, n_candidates)
    proposed = list(pool)
    rejected_parity = 0
    for rnd in range(rounds):
        for candidate in pool:
            measurement = runner(inputs, tx_count, extra_args,
                                 candidate.knobs, budget)
            if rnd == 0:
                stats.add_autotune_candidate()
            if not measurement.ok:
                candidate.fail = measurement.fail
                continue
            if measurement.findings != baseline.findings:
                # the parity guard: rejected and counted, its wall never
                # ranks (a break in any round drops the candidate for
                # good: it leaves the pool, so it is counted once)
                candidate.parity_ok = False
                candidate.witness_drift = (
                    bool(measurement.canonical)
                    and measurement.canonical == baseline.canonical)
                rejected_parity += 1
                stats.add_autotune_rejected(parity=True)
                continue
            candidate.walls.append(measurement.wall_s)
        pool = [c for c in pool if c.parity_ok and not c.fail and c.walls]
        if not pool:
            break
        if rnd + 1 < rounds:
            # successive halving: only the faster half earns another
            # measurement; the baseline is measured again beside it
            pool.sort(key=lambda c: c.mean_wall)
            pool = pool[:max(1, (len(pool) + 1) // 2)]
            rebase = runner(inputs, tx_count, extra_args, {}, budget)
            if rebase.ok and rebase.findings == baseline.findings:
                baseline_walls.append(rebase.wall_s)

    baseline_wall = sum(baseline_walls) / len(baseline_walls)
    # the winner must gain more than min_delta and more than the spread of
    # the baseline's own walls (mythril_tpu's bar is min_delta alone: on a
    # card a child's wall is mostly process start-up, whose spread passes
    # a knob the run never reads); one round measures no spread
    spread = max(baseline_walls) - min(baseline_walls)
    bar = min(baseline_wall * (1.0 - min_improvement),
              baseline_wall - spread)
    pool.sort(key=lambda c: c.mean_wall)
    winner = pool[0] if pool and pool[0].mean_wall < bar else None
    # every tried candidate has one outcome: candidates_tried ==
    # rejected_parity + rejected_regression + (1 if a winner). A
    # "regression" is anything measured but not persisted: no better than
    # the default within the margin, dropped by a halving round, or failed
    # or timed out under its budget
    rejected_regression = sum(
        1 for c in proposed if c.parity_ok and c is not winner)
    for _ in range(rejected_regression):
        stats.add_autotune_rejected(parity=False)

    summary = {
        "autotune": "tuned" if winner else "no_improvement",
        "platform": measured_platform,
        "probe_inputs": [os.path.basename(p) for p in inputs],
        "probe_digest": digest,
        "baseline_wall_s": round(baseline_wall, 3),
        "baseline_spread_s": round(spread, 3),
        "baseline_solver_wall_s": round(baseline.solver_wall_s, 3),
        "candidates_tried": len(proposed),
        "rejected_parity": rejected_parity,
        # of the parity rejects, those that were witness drift (an equally
        # valid model), not a change of findings
        "rejected_witness_drift": sum(
            1 for c in proposed if c.witness_drift),
        "rejected_regression": rejected_regression,
        "rounds": rounds,
        "budget_s": budget,
        "gap_stages": gap_stages,
        "candidates": [
            {"label": c.label, "stage": c.stage,
             "mean_wall_s": (round(c.mean_wall, 3)
                             if c.walls else None),
             "parity_ok": c.parity_ok,
             **({"witness_drift": True} if c.witness_drift else {}),
             **({"fail": c.fail} if c.fail else {})}
            for c in proposed],
    }
    if winner is None:
        return summary

    knob_deltas = {}
    from mythril_tpu_torch.support.env import resolve_source

    for name, value in winner.knobs.items():
        registered = space.knob(name)
        before, _source = resolve_source(
            name, registered.default if registered else None,
            registered.kind if registered else "float")
        knob_deltas[name] = {
            "before": before, "after": value,
            "stage": registered.stage if registered else ""}
    entry = {
        "knobs": dict(winner.knobs),
        "platform": measured_platform,
        "git_rev": metrics.git_revision(),
        "probe_digest": digest,
        "probe_inputs": [os.path.basename(p) for p in inputs],
        "tx_count": tx_count,
        "baseline_wall_s": round(baseline_wall, 3),
        "tuned_wall_s": round(winner.mean_wall, 3),
        "delta_frac": round(1.0 - winner.mean_wall / baseline_wall, 4),
        "objective": "probe analyze wall (end-to-end)",
        "knob_deltas": knob_deltas,
        "search": {"candidates_tried": len(proposed),
                   "rejected_parity": rejected_parity,
                   "rejected_regression": rejected_regression,
                   "rounds": rounds, "budget_s": budget},
    }
    persisted = save_tuned(measured_platform, entry)
    summary.update({
        "winner": winner.label,
        "tuned_wall_s": round(winner.mean_wall, 3),
        "delta_frac": entry["delta_frac"],
        "knobs": dict(winner.knobs),
        "persisted": persisted,
    })
    return summary


def _gap_rows(stats_payload: dict) -> List[dict]:
    roofline_section = (stats_payload or {}).get("roofline")
    if not isinstance(roofline_section, dict):
        return []
    from mythril_tpu_torch.observe.roofline import top_gaps

    return top_gaps(roofline_section, n=6)


def build_probe_kernels(solver_backend: str, torch_device) -> None:
    """Build the kernels the children launch on a card, here and before
    the baseline, so that no child's wall pays nvcc: K1 (the default
    pallas mode), K2 (the xla candidate, and K1's capacity fallback) and
    K6 (the frontier); the children load them. Nothing on the host
    backend or a CPU device; with no card and no device named the
    baseline child reports it (NoDeviceError, exit 2)."""
    if solver_backend != "gpu":
        return
    from mythril_tpu_torch.gpu.device import NoDeviceError, resolve_device

    try:
        device = resolve_device(torch_device)
    except NoDeviceError:
        return
    if device.type != "cuda":
        return
    from mythril_tpu_torch.gpu import frontier_kernel, ragged_kernel, xla_kernel

    ragged_kernel.build_kernel()
    xla_kernel.build_kernel()
    frontier_kernel.build_kernel()


def run_autotune(parsed) -> int:
    """`python -m mythril_tpu_torch autotune`: resolve the probe workload,
    build the children's kernels, run the search and print one JSON
    summary line. Exit 0 on a persisted or already-loaded profile (and on
    an honest no_improvement), 2 on a failed baseline or a missing
    probe."""
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support.args import args

    stats = SolverStatistics()
    stats.enabled = True
    solver_backend = getattr(parsed, "solver_backend", None) or "gpu"
    torch_device = getattr(parsed, "torch_device", None)
    # the parent's platform guess reads the same device rules
    args.solver_backend = solver_backend
    args.torch_device = torch_device
    inputs = list(getattr(parsed, "codefile", None) or [])
    extra_args: List[str] = []
    if getattr(parsed, "bin_runtime", False):
        extra_args.append("--bin-runtime")
    extra_args += ["--solver-backend", solver_backend]
    if torch_device is not None:
        extra_args += ["--torch-device", str(torch_device)]
    if not inputs:
        inputs = default_probe_inputs()
    missing = [path for path in inputs if not os.path.isfile(path)]
    if not inputs or missing:
        print(json.dumps({"autotune": "no_probe",
                          "missing": missing or "bench_inputs/corpus"}))
        return 2
    build_probe_kernels(solver_backend, torch_device)
    summary = run_search(
        inputs, getattr(parsed, "transaction_count", 1) or 1,
        extra_args=extra_args,
        candidates=getattr(parsed, "candidates", None),
        budget_s=getattr(parsed, "budget", None),
        rounds=getattr(parsed, "rounds", None) or DEFAULT_ROUNDS,
        min_delta=getattr(parsed, "min_delta", None),
        force=getattr(parsed, "force", False))
    from mythril_tpu_torch.core import MythrilAnalyzer

    MythrilAnalyzer._dump_stats_json(stats, completed=True)
    print(json.dumps(summary))
    return 2 if summary["autotune"] == "baseline_failed" else 0
