"""Persistent router micro-calibration cache (mythril_tpu.service.calibration,
measurement entries only).

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
The JAX package's tuned-profile section waits for the autotune slice.
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
            payload = {"schema": CALIBRATION_SCHEMA_VERSION, "entries": {}}
            try:
                with open(path) as fd:
                    existing = json.load(fd)
                if existing.get("schema") == CALIBRATION_SCHEMA_VERSION:
                    payload = existing
                    payload.setdefault("entries", {})
            except (OSError, ValueError):
                pass
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
