"""Deterministic fault-injection harness (a copy of
mythril_tpu.resilience.faults with the knob prefix changed).

Armed by `MYTHRIL_GPU_FAULTS` (or `--inject-fault`), a comma-separated
list of plans:

    MYTHRIL_GPU_FAULTS=<site>:<kind>:<trigger>[,<site>:<kind>:<trigger>...]

  site     a registered fault site name (registry.FAULT_SITES)
  kind     raise | hang | delay | corrupt | exit (registry.KINDS)
  trigger  n<k>   fire exactly once, on the k-th crossing of the site
           r<p>   fire each crossing with probability p (seeded RNG:
                  MYTHRIL_GPU_FAULT_SEED, default 0, so a given seed
                  reproduces the same fault schedule bit for bit)
           *      fire on every crossing (the deterministic-fault shape)

Example: MYTHRIL_GPU_FAULTS=device.dispatch:raise:n1,disk.entry:corrupt:*

Disarmed, maybe_inject() is one module-global load and a None check.
Per-site crossing counters and a per-site seeded RNG make the same spec
and seed produce the same schedule in every run. Every injected fault
surfaces AT a registered site, inside that site's own degradation scope.
"""

import logging
import os
import random
import zlib
from typing import Dict, Optional

from mythril_tpu_torch.resilience import registry

log = logging.getLogger(__name__)

FAULTS_ENV = "MYTHRIL_GPU_FAULTS"
SEED_ENV = "MYTHRIL_GPU_FAULT_SEED"

# how long a "hang" blocks: far past any stage deadline, so the deadline
# runner (deadline.py) is what ends it, never the sleep itself
HANG_SECONDS = 600.0
DELAY_SECONDS = 0.05


class InjectedFault(RuntimeError):
    """Raised by an armed `raise` plan at its site."""


class _Plan:
    __slots__ = ("site", "kind", "mode", "value", "crossings", "fired")

    def __init__(self, site: str, kind: str, mode: str, value: float):
        self.site = site
        self.kind = kind
        self.mode = mode       # "nth" | "rate" | "always"
        self.value = value     # k for nth, p for rate
        self.crossings = 0
        self.fired = 0


# site -> _Plan; None = harness disarmed (THE hot-path check)
_plans: Optional[Dict[str, _Plan]] = None
_rngs: Dict[str, random.Random] = {}
_spec: str = ""


def parse_spec(spec: str) -> Dict[str, _Plan]:
    """Parse a fault spec; unknown sites, kinds and triggers raise
    ValueError (a mistyped spec silently injecting nothing would make every
    chaos assertion vacuous)."""
    plans: Dict[str, _Plan] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        pieces = part.split(":")
        if len(pieces) != 3:
            raise ValueError(f"fault plan {part!r}: want site:kind:trigger")
        site, kind, trigger = pieces
        if site not in registry.FAULT_SITES:
            raise ValueError(f"fault plan {part!r}: unknown site {site!r}")
        if site in plans:
            raise ValueError(
                f"fault plan {part!r}: site {site!r} already has a plan — "
                "a silently dropped duplicate would make its chaos "
                "assertions vacuous")
        if kind not in registry.FAULT_SITES[site].kinds:
            raise ValueError(
                f"fault plan {part!r}: kind {kind!r} not meaningful at "
                f"{site} (supported: {registry.FAULT_SITES[site].kinds})")
        if trigger == "*":
            plans[site] = _Plan(site, kind, "always", 0.0)
        elif trigger.startswith("n"):
            plans[site] = _Plan(site, kind, "nth", int(trigger[1:]))
        elif trigger.startswith("r"):
            plans[site] = _Plan(site, kind, "rate", float(trigger[1:]))
        else:
            raise ValueError(
                f"fault plan {part!r}: trigger must be n<k>, r<p> or *")
    return plans


def configure(spec: Optional[str]) -> None:
    """(Re)arm the harness from an explicit spec string, or disarm with
    None/empty. Resets every crossing counter and RNG: each configure
    starts a fresh, reproducible fault schedule."""
    global _plans, _spec
    _rngs.clear()
    if not spec:
        _plans = None
        _spec = ""
        return
    _plans = parse_spec(spec)
    _spec = spec
    seed = int(os.environ.get(SEED_ENV, "0") or "0")
    for site in _plans:
        _rngs[site] = random.Random(seed ^ zlib.crc32(site.encode()))
    log.warning("fault injection ARMED: %s (seed %d)", spec, seed)


def configure_from_env(cli_spec: Optional[str] = None) -> None:
    """Arm from MYTHRIL_GPU_FAULTS, falling back to the --inject-fault
    value; disarm when neither is set. Called at analyzer start
    (core.MythrilAnalyzer.fire_lasers)."""
    configure(os.environ.get(FAULTS_ENV) or cli_spec)


def active_spec() -> str:
    """The armed spec string ('' when disarmed): stats JSON provenance."""
    return _spec


def _should_fire(plan: _Plan) -> bool:
    plan.crossings += 1
    if plan.mode == "always":
        return True
    if plan.mode == "nth":
        return plan.crossings == plan.value
    return _rngs[plan.site].random() < plan.value


def _count_injected(site: str) -> None:
    # lazy import: this module is imported by the package __init__
    from mythril_tpu_torch.resilience import record_event

    record_event(site, "injected")


def maybe_inject(site: str) -> None:
    """Crossing hook placed at every registered fault site. No-op unless a
    plan for `site` is armed and its trigger fires; then raises
    InjectedFault, sleeps or exits per the plan's kind. `corrupt` plans do
    nothing here: they act through corrupt_text() on the site's data
    path, and consuming a crossing here would shift the n-th trigger that
    hook waits for."""
    if _plans is None:
        return
    plan = _plans.get(site)
    if plan is None or plan.kind == "corrupt" or not _should_fire(plan):
        return
    plan.fired += 1
    _count_injected(site)
    if plan.kind == "raise":
        raise InjectedFault(f"injected fault at {site} "
                            f"(crossing {plan.crossings})")
    if plan.kind == "hang":
        import time

        log.warning("injected hang at %s (the deadline runner must "
                    "rescue)", site)
        time.sleep(HANG_SECONDS)
        return
    if plan.kind == "delay":
        import time

        time.sleep(DELAY_SECONDS)
        return
    if plan.kind == "exit":
        log.warning("injected process exit at %s", site)
        os._exit(86)


def corrupt_text(site: str, text: str) -> str:
    """Data-path hook for `corrupt` plans: mangle `text` when the site's
    corrupt plan fires (a deterministic truncate-and-garbage, the shape of
    a torn write or a bad blob)."""
    if _plans is None:
        return text
    plan = _plans.get(site)
    if plan is None or plan.kind != "corrupt" or not _should_fire(plan):
        return text
    plan.fired += 1
    _count_injected(site)
    return text[: len(text) // 2] + "\x00CORRUPTED"
