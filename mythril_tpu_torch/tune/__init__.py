"""The closed autotune loop: a measured schedule search and the tuned
profile's apply (mythril_tpu.tune).

  space.py   the knob space: every tunable registered with its kind,
             default, roofline stage and candidate values
  search.py  `python -m mythril_tpu_torch autotune`: gap-directed
             candidates, successive-halving measurement of `analyze`
             children on a bounded probe, a byte-identical findings guard,
             per-platform persistence (service/calibration.py, `tuned`)
  (here)     apply_tuned_profile(): load the persisted winner at process
             start and install it as support/env's tuned tier, so every
             knob consumer resolves it with the precedence explicit env >
             CLI flag > tuned > default

A profile is keyed by the port's platform stamp
(observe/metrics.torch_platform): the card's name, e.g. "NVIDIA H100 80GB
HBM3", or "cpu". A profile measured on the CPU never applies on the card,
nor the reverse. MYTHRIL_GPU_AUTOTUNE=0 disables the apply.
"""

import logging
import os

log = logging.getLogger(__name__)

AUTOTUNE_ENV = "MYTHRIL_GPU_AUTOTUNE"
BUDGET_ENV = "MYTHRIL_GPU_AUTOTUNE_BUDGET"
CANDIDATES_ENV = "MYTHRIL_GPU_AUTOTUNE_CANDIDATES"
MIN_DELTA_ENV = "MYTHRIL_GPU_AUTOTUNE_MIN_DELTA"

# the autotune counters (SolverStatistics fields; the stats-key lint,
# observe/stats_keys.py, holds them to the stats JSON)
TUNE_COUNTERS = (
    "autotune_candidates_tried",
    "autotune_rejected_parity",
    "autotune_rejected_regression",
    "tuned_knobs_applied",
    "tuned_profile_rejects",
)

_applied = False
_applied_count = 0   # knobs live from the applied profile (late count)
_counted = False     # tuned_knobs_applied reached an enabled statistics


def autotune_enabled() -> bool:
    return os.environ.get(AUTOTUNE_ENV, "") not in ("0", "off", "false")


def reset_applied() -> None:
    """Forget that a profile was applied in this process (tests)."""
    global _applied, _applied_count, _counted
    _applied = False
    _applied_count = 0
    _counted = False


def default_platform():
    """The platform this process runs its device path on, for keying a
    profile: the platform stamp once this process initialized CUDA or
    asked for the CPU (a CPU torch device or the host backend); else the
    device the run named (--torch-device, which stands where mythril_tpu's
    JAX_PLATFORMS pin stood); else the card the device backend will take.
    With none of these (no card and no device named) a guess must be
    grounded: exactly one platform ever tuned, and this machine's
    calibration measurements name no other. Anything else returns None,
    and no profile applies: a schedule measured on one platform never
    governs another."""
    from mythril_tpu_torch.observe.metrics import torch_platform
    from mythril_tpu_torch.support.args import args

    platform = torch_platform()
    if platform and platform != "uninitialized":
        return platform
    import torch

    named = getattr(args, "torch_device", None)
    if named is not None:
        try:
            device = torch.device(named)
        except (RuntimeError, ValueError):
            return None
        if device.type == "cpu":
            return "cpu"
        if device.type == "cuda" and torch.cuda.is_available():
            return torch.cuda.get_device_name(device)
        return None
    if args.solver_backend == "gpu" and torch.cuda.is_available():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    from mythril_tpu_torch.service.calibration import (
        measured_platforms,
        tuned_platforms,
    )

    tuned = tuned_platforms()
    if len(tuned) == 1:
        measured = measured_platforms()
        if not measured or measured == tuned:
            return tuned[0]
    return None


def _drop_resolved_consumers() -> None:
    """Drop what resolved its knobs before the tuned tier changed: the
    cached kernel mode, the router (its budgets and caps), the scheduler
    (its window) and the device backends (restart lanes and steps), so
    the next use reads the profile. The apply runs before any of them is
    used; this keeps that true in a process that touched one earlier."""
    from mythril_tpu_torch.gpu import backend, ragged_kernel, router
    from mythril_tpu_torch.service.scheduler import reset_scheduler

    ragged_kernel.reset_kernel_mode()
    router.reset_router()
    reset_scheduler()
    backend.reset_backends()


def apply_tuned_profile(platform=None, force: bool = False) -> int:
    """Install the persisted tuned profile of `platform` (default_platform()
    when None) as support/env's tuned tier. Once a process (repeated
    fire_lasers calls apply nothing new); `force` re-applies. Returns the
    number of knobs that took effect (0 when disabled, absent or
    rejected). A corrupt, stale-schema or unregistered-knob profile is
    ignored with a counted event (tuned_profile_rejects): a bad profile
    degrades to the built-in defaults, never to a crash or a half-applied
    configuration."""
    global _applied, _applied_count, _counted
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    stats = SolverStatistics()
    if _applied and not force:
        # serve applies before the daemon enables the statistics: the
        # repeat call, statistics now live, back-fills the count once, so
        # tuned_knobs_applied never reads 0 while the stamp says tuned
        if _applied_count and not _counted and stats.enabled:
            stats.add_tuned_knobs_applied(_applied_count)
            _counted = True
        return 0
    _applied = True
    if not autotune_enabled():
        return 0
    from mythril_tpu_torch.tune import space

    platform = platform or default_platform()
    if not platform:
        # an unknown or ungrounded platform: the built-in defaults, never
        # another platform's profile
        return 0
    from mythril_tpu_torch.service.calibration import load_tuned

    entry, reject = load_tuned(platform)
    if reject is not None:
        stats.add_tuned_profile_reject()
        log.warning("tuned profile for %s ignored (%s); built-in "
                    "defaults apply", platform, reject)
        return 0
    if entry is None:
        return 0
    knobs = entry.get("knobs") or {}
    if not space.validate_knobs(knobs):
        stats.add_tuned_profile_reject()
        log.warning("tuned profile for %s names unregistered or "
                    "malformed knobs; ignored", platform)
        return 0
    from mythril_tpu_torch.support import env as env_mod

    env_mod.set_tuned(dict(knobs))
    _drop_resolved_consumers()
    # an explicit env var shadows its tuned knob: count what took effect
    applied = sum(1 for name in knobs if os.environ.get(name) is None)
    _applied_count = applied
    _counted = stats.enabled
    stats.add_tuned_knobs_applied(applied)
    log.info("tuned profile applied for %s: %d knob(s) (%d shadowed by "
             "explicit env), tuned at rev %s",
             platform, applied, len(knobs) - applied,
             entry.get("git_rev", "unknown"))
    return applied
