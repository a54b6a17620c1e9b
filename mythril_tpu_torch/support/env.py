"""Shared environment-variable parsing and knob resolution
(mythril_tpu.support.env).

Every tunable knob of the port resolves through the readers here, with the
precedence

    explicit env var  >  CLI-provided value  >  tuned profile  >  default

The tuned tier is filled once per process by
mythril_tpu_torch.tune.apply_tuned_profile() from the persisted
per-platform profile (service/calibration.py, its `tuned` section); as
every consumer reads its knobs through the readers below, applying a
profile needs no change at any consumer. An explicit env var is always
absolute: a tuned profile never overrides an operator's hand-set value.
resolve_source() says which tier supplied a knob, so the stats JSON and
the heartbeat can stamp each run's resolved configuration.

The port's knobs carry the prefix MYTHRIL_GPU_*, so a process that
imports both this package and the JAX one (the parity tests do) never
lets one package's settings steer the other.
"""

import os
from typing import Dict, Optional, Tuple

# tuned-profile tier (mythril_tpu_torch/tune/): knob name -> value, set by
# apply_tuned_profile(); empty until a profile is applied
_TUNED: Dict[str, object] = {}
# CLI tier: a flag that maps 1:1 onto a knob records its value here
_CLI: Dict[str, object] = {}


def set_tuned(mapping: Dict[str, object]) -> None:
    """Install the tuned-profile tier (replaces any previous mapping)."""
    _TUNED.clear()
    _TUNED.update(mapping)


def tuned_values() -> Dict[str, object]:
    return dict(_TUNED)


def set_cli(name: str, value) -> None:
    """Record a CLI-flag-provided knob value (beats tuned, loses to env)."""
    _CLI[name] = value


def clear_overrides() -> None:
    """Drop the tuned and CLI tiers (tests)."""
    _TUNED.clear()
    _CLI.clear()


def _resolve(name: str, default, cast) -> Tuple[object, str]:
    """(value, source) through the precedence chain. A mistyped knob must
    never crash a run: a present-but-malformed env var pins the built-in
    default (an explicit env var, even a broken one, is absolute and is
    never replaced by a tuned value), while a malformed cli or tuned entry
    falls through to the next tier."""
    raw = os.environ.get(name)
    if raw is not None:
        try:
            return cast(raw), "env"
        except (TypeError, ValueError):
            return default, "default"
    for tier, source in ((_CLI, "cli"), (_TUNED, "tuned")):
        if name in tier:
            try:
                return cast(tier[name]), source
            except (TypeError, ValueError):
                pass
    return default, "default"


def resolve_source(name: str, default=None, kind: str = "float"
                   ) -> Tuple[object, str]:
    """(resolved value, source tier) for stamping a run's configuration."""
    cast = {"int": _cast_int, "str": str}.get(kind, float)
    return _resolve(name, default, cast)


def _cast_int(value) -> int:
    return int(float(value))


def env_float(name: str, default: float) -> float:
    """Resolved float knob: env > cli > tuned > `default`."""
    return _resolve(name, default, float)[0]


def env_int(name: str, default: int) -> int:
    """Resolved int knob: env > cli > tuned > `default` (lenient cast: a
    tuned profile may round-trip ints through JSON floats)."""
    return _resolve(name, default, _cast_int)[0]


def env_str(name: str, default: Optional[str]) -> Optional[str]:
    """Resolved string knob: env > cli > tuned > `default` (categorical
    knobs, e.g. MYTHRIL_GPU_KERNEL's kernel mode)."""
    return _resolve(name, default, str)[0]
