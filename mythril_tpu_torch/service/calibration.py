"""Persistent router micro-calibration cache and the tuned profiles
(mythril_tpu.service.calibration).

The router (gpu/router.py) measures its stage rates once per process —
the live ragged kernel's cells per second on a small two-cone stream (K1's
kernel_cells_s, or K2's xla_cells_s in the xla kernel mode), pack, stream
assembly + upload and host-CDCL settle rates; and, where the bucketed path
runs, K3's seconds per cell and step (per_cell_s) with the ship rate. Under solve_cache "disk" the measurement persists beside the
other service artifacts, keyed by (platform, restart lanes, round steps),
so a later process skips it; a save merges into the entry, so the two
kernels' measurements share it.

Entries carry a schema stamp and a measurement timestamp; a schema bump
or a malformed file degrades to re-measurement, never to a wrong rate.

The same file holds the autotune search's `tuned` section
(mythril_tpu_torch/tune/): one measured profile per platform, versioned
apart from the measurement entries (TUNED_SCHEMA_VERSION).
"""

import json
import logging
import os
import time
from typing import Optional

from mythril_tpu_torch.service.store import atomic_write_json
from mythril_tpu_torch.support.lock import LockFile

log = logging.getLogger(__name__)

CALIBRATION_SCHEMA_VERSION = 1
# schema of the per-platform `tuned` section, bumped apart from the
# calibration schema: a stale tuned layout is ignored (a counted event)
# without invalidating the measurements, and a calibration-schema bump
# never drops a platform's still-valid profile
TUNED_SCHEMA_VERSION = 1
_FILENAME = "calibration.json"

# kernel_cells_s (K1), xla_cells_s (K2) or per_cell_s (K3) gates an entry
# (a cost model runs off each); the others are best-effort stage rates
KERNEL_RATE_KEY = "kernel_cells_s"
XLA_RATE_KEY = "xla_cells_s"
STAGE_RATE_KEYS = ("pack_bytes_s", "ragged_bytes_s", "settle_clauses_s")
# K3's calibration: its latency and the ship rate measured beside it
CIRCUIT_KEYS = ("per_cell_s", "ship_bytes_s")
_GATES = (KERNEL_RATE_KEY, XLA_RATE_KEY, "per_cell_s")
_KEYS = (KERNEL_RATE_KEY, XLA_RATE_KEY) + STAGE_RATE_KEYS + CIRCUIT_KEYS


def _path() -> str:
    from mythril_tpu_torch.service import cache_dir

    return os.path.join(cache_dir(), _FILENAME)


def _key(platform: str, restarts: int, steps: int) -> str:
    return f"{platform}|r{restarts}|s{steps}"


def _enabled() -> bool:
    from mythril_tpu_torch.service import disk_tier_enabled

    return disk_tier_enabled()


def load_profile(platform: Optional[str], restarts: int,
                 steps: int) -> Optional[dict]:
    """The cached entry for this platform + cell profile — the positive
    numbers among kernel_cells_s, xla_cells_s, per_cell_s, ship_bytes_s
    and the stage rates, with one of the three kernel rates among them —
    or None (measure)."""
    if not platform or not _enabled():
        return None
    try:
        with open(_path()) as fd:
            payload = json.load(fd)
    except (OSError, ValueError):
        return None
    if payload.get("schema") != CALIBRATION_SCHEMA_VERSION:
        return None
    entry = payload.get("entries", {}).get(_key(platform, restarts, steps))
    if not isinstance(entry, dict):
        return None
    out = {key: float(entry[key]) for key in _KEYS
           if isinstance(entry.get(key), (int, float)) and entry[key] > 0}
    if not any(key in out for key in _GATES):
        return None
    return out


def save_profile(platform: Optional[str], restarts: int, steps: int,
                 profile: dict) -> None:
    """Merge a measurement into its entry (no-op unless solve_cache is
    "disk", or without a kernel rate in `profile`)."""
    if not platform or not _enabled() \
            or not any(profile.get(key) for key in _GATES):
        return
    path = _path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with LockFile(path + ".lock"):
            payload = _payload_for_write(path)
            key = _key(platform, restarts, steps)
            entry = payload["entries"].get(key)
            payload["entries"][key] = {
                **(entry if isinstance(entry, dict) else {}),
                **{name: value for name, value in profile.items()
                   if isinstance(value, (int, float)) and value > 0},
                "measured_at": int(time.time()),
            }
            atomic_write_json(path, payload)
    except OSError as error:
        log.info("could not persist calibration (%s)", error)


def _payload_for_write(path: str) -> dict:
    """The file's payload to merge a write into: the existing one when its
    calibration schema is current, else a fresh one that still keeps the
    existing `tuned` section (versioned on its own)."""
    payload = {"schema": CALIBRATION_SCHEMA_VERSION, "entries": {}}
    try:
        with open(path) as fd:
            existing = json.load(fd)
    except (OSError, ValueError):
        return payload
    if not isinstance(existing, dict):
        return payload
    if existing.get("schema") == CALIBRATION_SCHEMA_VERSION \
            and isinstance(existing.get("entries"), dict):
        return existing
    if isinstance(existing.get("tuned"), dict):
        payload["tuned"] = existing["tuned"]
    return payload


# -- tuned profiles (mythril_tpu_torch/tune/) ---------------------------------
#
# The autotune search persists its measured winner as a per-platform
# `tuned` section of the same file. Unlike the measurement entries it is an
# operator's artifact, not a cache tier: load and save are not gated on
# the disk tier, so a profile tuned once applies to every later run
# whatever its --solve-cache mode, and clear_caches() (in-process state
# only) never loses it. A platform is the port's platform stamp
# (observe/metrics.torch_platform): the card's name, or "cpu".


def _read_payload() -> dict:
    try:
        with open(_path()) as fd:
            payload = json.load(fd)
    except (OSError, ValueError):
        return {}
    return payload if isinstance(payload, dict) else {}


def tuned_platforms() -> list:
    """Platforms with a present (not necessarily valid) tuned entry: the
    grounded fallback of tune.default_platform."""
    section = _read_payload().get("tuned")
    if not isinstance(section, dict):
        return []
    return sorted(name for name in section if isinstance(name, str))


def measured_platforms() -> list:
    """Platforms this machine's calibration measurements were taken on,
    under the platform stamp's names: an entry key is "platform|rN|sM",
    and the router keys a card's entries "cuda:<card name>"."""
    entries = _read_payload().get("entries")
    if not isinstance(entries, dict):
        return []
    names = set()
    for key in entries:
        if isinstance(key, str) and "|" in key:
            name = key.split("|", 1)[0]
            names.add(name[len("cuda:"):] if name.startswith("cuda:")
                      else name)
    return sorted(names)


def load_tuned(platform: Optional[str]):
    """(tuned profile, None) for this platform; (None, reject reason) for a
    present but unusable section (an unreadable file, a stale schema,
    malformed knobs: the caller counts the event); (None, None) when
    nothing was tuned for it."""
    if not platform:
        return None, None
    path = _path()
    if not os.path.isfile(path):
        return None, None
    try:
        with open(path) as fd:
            payload = json.load(fd)
    except (OSError, ValueError):
        return None, "unreadable"
    section = payload.get("tuned") if isinstance(payload, dict) else None
    if not isinstance(section, dict):
        return None, None if section is None else "malformed"
    entry = section.get(platform)
    if entry is None:
        return None, None
    if not isinstance(entry, dict):
        return None, "malformed"
    if entry.get("schema") != TUNED_SCHEMA_VERSION:
        return None, "stale-schema"
    knobs = entry.get("knobs")
    if not isinstance(knobs, dict) or not knobs or not all(
            isinstance(name, str) and isinstance(value, (int, float, str))
            and not isinstance(value, bool)
            for name, value in knobs.items()):
        return None, "malformed"
    return entry, None


def save_tuned(platform: Optional[str], entry: dict) -> bool:
    """Persist one platform's tuned profile (the schema stamp and the time
    added here), read-modify-write under the measurement entries' lock so
    a concurrent calibration save cannot tear the section."""
    if not platform or not isinstance(entry.get("knobs"), dict):
        return False
    path = _path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with LockFile(path + ".lock"):
            payload = _payload_for_write(path)
            tuned = payload.get("tuned")
            if not isinstance(tuned, dict):
                tuned = {}
            tuned[platform] = {**entry, "schema": TUNED_SCHEMA_VERSION,
                               "tuned_at": int(time.time())}
            payload["tuned"] = tuned
            return atomic_write_json(path, payload)
    except OSError as error:
        log.info("could not persist tuned profile (%s)", error)
        return False
