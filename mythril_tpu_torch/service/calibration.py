"""Persistent router micro-calibration cache (mythril_tpu.service.calibration,
measurement entries only).

The router (gpu/router.py) measures its stage rates once per process —
the kernel's cells per second on a small two-cone stream, pack, stream
assembly + upload and host-CDCL settle rates. Under solve_cache "disk"
the measurement persists beside the other service artifacts, keyed by
(platform, restart lanes, round steps), so a later process skips it.

Entries carry a schema stamp and a measurement timestamp; a schema bump
or a malformed file degrades to re-measurement, never to a wrong rate.
The JAX package's tuned-profile section waits for the autotune slice.
"""

import json
import logging
import os
import tempfile
import time
from typing import Optional

from mythril_tpu_torch.support.lock import LockFile

log = logging.getLogger(__name__)

CALIBRATION_SCHEMA_VERSION = 1
_FILENAME = "calibration.json"

# kernel_cells_s gates an entry (the chunker's cost model runs off it);
# the others are best-effort stage rates
KERNEL_RATE_KEY = "kernel_cells_s"
STAGE_RATE_KEYS = ("pack_bytes_s", "ragged_bytes_s", "settle_clauses_s")


def _path() -> str:
    from mythril_tpu_torch.service import cache_dir

    return os.path.join(cache_dir(), _FILENAME)


def _key(platform: str, restarts: int, steps: int) -> str:
    return f"{platform}|r{restarts}|s{steps}"


def _enabled() -> bool:
    from mythril_tpu_torch.service import disk_tier_enabled

    return disk_tier_enabled()


def atomic_write_json(path: str, payload: dict) -> bool:
    """Temp-file + atomic-rename JSON write in `path`'s directory (the
    caller holds whatever lock the destination needs)."""
    fd, tmp_path = tempfile.mkstemp(dir=os.path.dirname(path),
                                    suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as handle:
            json.dump(payload, handle)
        os.replace(tmp_path, path)
        return True
    except OSError:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return False


def load_profile(platform: Optional[str], restarts: int,
                 steps: int) -> Optional[dict]:
    """The cached entry for this platform + cell profile — {kernel_cells_s,
    optional stage rates} — or None (measure)."""
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
    rate = entry.get(KERNEL_RATE_KEY)
    if not isinstance(rate, (int, float)) or rate <= 0:
        return None
    out = {KERNEL_RATE_KEY: float(rate)}
    for key in STAGE_RATE_KEYS:
        value = entry.get(key)
        if isinstance(value, (int, float)) and value > 0:
            out[key] = float(value)
    return out


def save_profile(platform: Optional[str], restarts: int, steps: int,
                 profile: dict) -> None:
    """Persist a measurement entry (no-op unless solve_cache is "disk")."""
    if not platform or not _enabled() or not profile.get(KERNEL_RATE_KEY):
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
            payload["entries"][_key(platform, restarts, steps)] = {
                **{key: value for key, value in profile.items()
                   if isinstance(value, (int, float)) and value > 0},
                "measured_at": int(time.time()),
            }
            atomic_write_json(path, payload)
    except OSError as error:
        log.info("could not persist calibration (%s)", error)
