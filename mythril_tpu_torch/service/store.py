"""Persistent on-disk solve-result tier (a copy of
mythril_tpu.service.store with the knob prefix changed; the network tier
that subclasses it in the JAX package comes with the fleet).

One JSON file per entry under <MYTHRIL_GPU_CACHE_DIR>/solve-cache, named
by the instance fingerprint (fingerprint.py). The store is shared across
repeated CLI invocations:

  writes    temp-file + atomic rename under a file lock (support/lock.py),
            so concurrent writers never observe a torn entry; the
            registered fault site disk.write retries a failed write once
            with jittered backoff, then the verdict is not persisted
  reads     lock-free (rename is atomic); a hit touches the entry's mtime,
            which is the LRU recency signal
  eviction  LRU by mtime under the lock after every write, by entry count
            (MYTHRIL_GPU_CACHE_MAX_ENTRIES, default 4096) and by total
            bytes (MYTHRIL_GPU_CACHE_MAX_BYTES, default unlimited)
  schema    a VERSION stamp file; a mismatch wipes every entry instead of
            trusting stale formats

Entry trust model:
  corrupt  a malformed entry (truncated write, garbage bytes, wrong schema
           stamp, undecodable blob; the registered fault site disk.entry)
           is QUARANTINED on lookup: moved to a `.quarantined` sibling,
           counted as a persistent_verify_reject and a quarantine event,
           and the lookup is a safe miss
  SAT      stores the satisfying assignment bits (packed, base64). A hit
           is never trusted as-is: the caller replays the bits through
           Solver._reconstruct against the ORIGINAL constraints, so a
           collision or a corrupted file is a safe miss, not a wrong
           verdict (support/model.py)
  UNSAT    stores crosscheck provenance. Detection-path lookups only trust
           provenance-carrying entries; engine-path lookups trust either
"""

import base64
import json
import logging
import os
import tempfile
from typing import List, Optional

from mythril_tpu_torch.support.lock import LockFile

log = logging.getLogger(__name__)

STORE_SCHEMA_VERSION = 1
DEFAULT_MAX_ENTRIES = 4096
# assignments for cones past this many CNF vars are not worth the disk
# traffic (125 KB+ per entry); the memory tier still serves them in-process
STORE_VAR_CAP = 1 << 20


def _default_root() -> str:
    from mythril_tpu_torch.service import cache_dir

    return os.path.join(cache_dir(), "solve-cache")


def atomic_write_json(path: str, payload: dict) -> bool:
    """Temp-file + atomic-rename JSON write in `path`'s directory (the
    caller holds whatever lock the destination needs). Shared by the
    result store and the calibration cache."""
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


class StoreEntry:
    __slots__ = ("verdict", "bits", "num_vars", "crosschecked")

    def __init__(self, verdict: str, bits=None, num_vars: int = 0,
                 crosschecked: bool = False):
        self.verdict = verdict
        self.bits = bits
        self.num_vars = num_vars
        self.crosschecked = crosschecked


def _pack_bits(bits: List[bool]) -> str:
    import numpy as np

    packed = np.packbits(np.asarray(bits, dtype=bool))
    return base64.b64encode(packed.tobytes()).decode("ascii")


def _unpack_bits(blob: str, num_vars: int) -> Optional[List[bool]]:
    import numpy as np

    try:
        raw = base64.b64decode(blob.encode("ascii"), validate=True)
    except (ValueError, AttributeError):
        return None
    unpacked = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    if len(unpacked) < num_vars + 1:
        return None
    return unpacked[: num_vars + 1].astype(bool).tolist()


class PersistentResultStore:
    """File-per-entry result store; every method is total (I/O failures
    degrade to miss/no-op — the store must never break a solve)."""

    # the fleet's shared network tier (fleet/netstore.py) subclasses this
    # with is_network=True and its own fault site; model.py mirrors its
    # events into the net_tier_* counters off the flag
    is_network = False
    entry_site = "disk.entry"

    def __init__(self, root: Optional[str] = None,
                 max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.root = root or _default_root()
        if max_entries is None:
            try:
                max_entries = int(
                    os.environ.get("MYTHRIL_GPU_CACHE_MAX_ENTRIES", ""))
            except ValueError:
                max_entries = 0
        self.max_entries = max_entries if max_entries and max_entries > 0 \
            else DEFAULT_MAX_ENTRIES
        if max_bytes is None:
            try:
                max_bytes = int(
                    os.environ.get("MYTHRIL_GPU_CACHE_MAX_BYTES", ""))
            except ValueError:
                max_bytes = 0
        # 0 = no byte cap (the entry-count cap still applies)
        self.max_bytes = max_bytes if max_bytes and max_bytes > 0 else 0
        # approximate local entry count/bytes: full directory scans per
        # write would serialize writers behind O(entries) stats under the
        # store lock; both are re-synced periodically to bound drift from
        # other processes' writes
        self._approx_count: Optional[int] = None
        self._approx_bytes: Optional[int] = None
        self._writes_since_sync = 0
        self._ok = self._bootstrap()

    # -- lifecycle ----------------------------------------------------------

    def _lock(self) -> LockFile:
        return LockFile(os.path.join(self.root, ".lock"))

    def _bootstrap(self) -> bool:
        try:
            os.makedirs(self.root, exist_ok=True)
            stamp = os.path.join(self.root, "VERSION")
            want = str(STORE_SCHEMA_VERSION)
            current = None
            try:
                with open(stamp) as fd:
                    current = fd.read().strip()
            except OSError:
                pass
            if current == want:
                return True
            with self._lock():
                # re-read under the lock: another process may have
                # restamped while this one waited
                try:
                    with open(stamp) as fd:
                        if fd.read().strip() == want:
                            return True
                except OSError:
                    pass
                for name in os.listdir(self.root):
                    if name.endswith(".json") \
                            or name.endswith(".quarantined"):
                        try:
                            os.unlink(os.path.join(self.root, name))
                        except OSError:
                            pass
                with open(stamp, "w") as fd:
                    fd.write(want)
            return True
        except OSError as error:
            log.warning("persistent solve store unavailable at %s (%s); "
                        "running memory-only", self.root, error)
            return False

    @property
    def available(self) -> bool:
        return self._ok

    def _path(self, fingerprint: str) -> str:
        return os.path.join(self.root, fingerprint + ".json")

    # -- reads --------------------------------------------------------------

    def lookup(self, fingerprint: str) -> Optional[StoreEntry]:
        """Read one entry; every malformed entry (truncated write,
        garbage bytes, wrong schema stamp, undecodable assignment blob)
        is QUARANTINED — moved aside so it is never re-read — counted as
        a persistent_verify_reject, and the lookup proceeds as a safe
        miss. A missing file is a plain miss (nothing to quarantine)."""
        if not self._ok or not fingerprint:
            return None
        path = self._path(fingerprint)
        try:
            with open(path) as fd:
                text = fd.read()
        except OSError:
            return None  # no entry: plain miss
        from mythril_tpu_torch.resilience import InjectedFault

        try:
            payload = json.loads(self._entry_guard(text))
        except (InjectedFault, ValueError):
            return self._quarantine(path, "unparseable entry")
        if not isinstance(payload, dict) \
                or payload.get("schema") != STORE_SCHEMA_VERSION:
            return self._quarantine(path, "wrong schema stamp")
        verdict = payload.get("verdict")
        if verdict == "sat":
            num_vars = payload.get("num_vars")
            blob = payload.get("bits")
            if not isinstance(num_vars, int) or not isinstance(blob, str):
                return self._quarantine(path, "malformed sat payload")
            bits = _unpack_bits(blob, num_vars)
            if bits is None:
                return self._quarantine(path, "undecodable assignment")
            entry = StoreEntry("sat", bits=bits, num_vars=num_vars)
        elif verdict == "unsat":
            entry = StoreEntry(
                "unsat", crosschecked=bool(payload.get("crosschecked")))
        else:
            return self._quarantine(path, "unknown verdict")
        try:
            os.utime(path, None)  # LRU recency
        except OSError:
            pass
        return entry

    @staticmethod
    def _entry_guard(text: str) -> str:
        """Fault-harness crossing on the entry read path (the site name
        stays a literal: the fault-site lint matches literal strings)."""
        from mythril_tpu_torch.resilience import corrupt_text, maybe_inject

        maybe_inject("disk.entry")
        return corrupt_text("disk.entry", text)

    # quarantined corpses kept for forensics; beyond this the oldest are
    # dropped — a recurring corruption source (flaky disk, mixed-version
    # writers) must not grow the cache dir past its caps through files
    # the eviction sweep does not see
    _QUARANTINE_KEEP = 32

    def _quarantine(self, path: str, reason: str) -> None:
        """Move a corrupt/unverifiable entry aside (never re-read; the
        newest _QUARANTINE_KEEP are kept for forensics — the
        `.quarantined` suffix excludes them from lookups, counts and
        eviction) and degrade to a safe miss. The oracle recomputes the
        verdict; a corrupt entry can cost a solve, never a finding."""
        from mythril_tpu_torch.resilience import record_event
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        log.warning("quarantining corrupt solve-cache entry %s (%s)",
                    os.path.basename(path), reason)
        stats = SolverStatistics()
        stats.add_persistent_verify_reject()
        if self.is_network:
            stats.add_net_tier_verify_reject()
        record_event(self.entry_site, "quarantine")
        try:
            os.replace(path, path + ".quarantined")
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self._prune_quarantined()
        return None

    def _prune_quarantined(self) -> None:
        """Drop the oldest quarantined corpses beyond the forensics cap
        (unlink races with other processes are benign: someone pruned)."""
        try:
            corpses = []
            for name in os.listdir(self.root):
                if not name.endswith(".quarantined"):
                    continue
                corpse = os.path.join(self.root, name)
                try:
                    corpses.append((os.path.getmtime(corpse), corpse))
                except OSError:
                    continue
            corpses.sort()
            for _mtime, corpse in corpses[:-self._QUARANTINE_KEEP]:
                try:
                    os.unlink(corpse)
                except OSError:
                    pass
        except OSError:
            pass

    # -- writes -------------------------------------------------------------

    def store_sat(self, fingerprint: str, num_vars: int,
                  bits: List[bool]) -> bool:
        if bits is None or num_vars > STORE_VAR_CAP:
            return False
        return self._write(fingerprint, {
            "schema": STORE_SCHEMA_VERSION,
            "verdict": "sat",
            "num_vars": num_vars,
            "bits": _pack_bits(bits),
        })

    def store_unsat(self, fingerprint: str, crosschecked: bool) -> bool:
        return self._write(fingerprint, {
            "schema": STORE_SCHEMA_VERSION,
            "verdict": "unsat",
            "crosschecked": bool(crosschecked),
        })

    _COUNT_SYNC_INTERVAL = 256

    def _write(self, fingerprint: str, payload: dict) -> bool:
        """Write one entry, retrying a transient IO failure once with
        jittered backoff (resilience registry: the disk.write fault
        site); a persistent failure degrades to not-persisted — reads
        simply re-solve, never a wrong verdict."""
        if not self._ok or not fingerprint:
            return False
        from mythril_tpu_torch.resilience import record_event, with_retries

        try:
            return with_retries(
                "disk.write",
                lambda: self._write_locked(fingerprint, payload))
        except Exception:
            record_event("disk.write", "degraded")
            return False

    def _write_locked(self, fingerprint: str, payload: dict) -> bool:
        """One locked write attempt; RAISES on IO failure so the retry
        wrapper in _write sees it (the pre-resilience silent False made
        every transient failure permanent)."""
        from mythril_tpu_torch.resilience import maybe_inject

        with self._lock():
            maybe_inject("disk.write")
            path = self._path(fingerprint)
            # overwrite of an existing fingerprint (e.g. a provenance
            # upgrade of an UNSAT entry) replaces, not adds: count the
            # old file out first or the approximations inflate and
            # trigger spurious O(entries) eviction scans under the lock
            old_size = None
            try:
                old_size = os.path.getsize(path)
            except OSError:
                pass
            if not atomic_write_json(path, payload):
                raise OSError("atomic entry write failed")
            if self._approx_count is None:
                self._approx_count = self.entry_count()
            elif old_size is None:
                self._approx_count += 1
            if self.max_bytes:
                if self._approx_bytes is None:
                    self._approx_bytes = self.total_bytes()
                else:
                    try:
                        self._approx_bytes += (
                            os.path.getsize(path) - (old_size or 0))
                    except OSError:
                        pass
            self._writes_since_sync += 1
            if self._writes_since_sync >= self._COUNT_SYNC_INTERVAL:
                # re-sync against other processes' writes
                self._approx_count = self.entry_count()
                if self.max_bytes:
                    self._approx_bytes = self.total_bytes()
                self._writes_since_sync = 0
            if self._approx_count > self.max_entries or (
                    self.max_bytes
                    and (self._approx_bytes or 0) > self.max_bytes):
                # eviction walks the directory once and returns the
                # exact post-eviction figures — re-scanning here would
                # triple the O(entries) stat sweeps under the lock
                self._approx_count, self._approx_bytes = \
                    self._evict_locked()
        return True

    def _evict_locked(self):
        """LRU eviction by mtime until BOTH caps hold (entry count, and —
        when configured — total bytes); caller holds the store lock. The
        most recent entry is never evicted: a byte cap smaller than one
        entry is a misconfiguration, and deleting the entry that was just
        written would make every write a no-op. Returns the exact
        post-eviction (entry count, total bytes) so the caller can refresh
        its approximations without another directory sweep."""
        try:
            stamped = []  # (mtime, size, path), oldest first
            total_size = 0
            for name in os.listdir(self.root):
                if not name.endswith(".json"):
                    continue
                path = os.path.join(self.root, name)
                try:
                    stat = os.stat(path)
                except OSError:
                    continue
                stamped.append((stat.st_mtime, stat.st_size, path))
                total_size += stat.st_size
            stamped.sort()
            count = len(stamped)
            for _mtime, size, path in stamped[:-1]:
                over_count = count > self.max_entries
                over_bytes = self.max_bytes and total_size > self.max_bytes
                if not over_count and not over_bytes:
                    break
                try:
                    os.unlink(path)
                except OSError:
                    continue
                count -= 1
                total_size -= size
            return count, total_size
        except OSError:
            return self._approx_count, self._approx_bytes

    def entry_count(self) -> int:
        if not self._ok:
            return 0
        try:
            return sum(1 for name in os.listdir(self.root)
                       if name.endswith(".json"))
        except OSError:
            return 0

    def total_bytes(self) -> int:
        """Sum of entry file sizes (the quantity MYTHRIL_GPU_CACHE_MAX_BYTES
        caps)."""
        if not self._ok:
            return 0
        total = 0
        try:
            for name in os.listdir(self.root):
                if not name.endswith(".json"):
                    continue
                try:
                    total += os.path.getsize(os.path.join(self.root, name))
                except OSError:
                    pass
        except OSError:
            return 0
        return total


_store: Optional[PersistentResultStore] = None


def get_result_store() -> PersistentResultStore:
    """Process-wide store handle (re-reads MYTHRIL_GPU_CACHE_DIR and
    MYTHRIL_GPU_NET_TIER_DIR on first access after reset_result_store).
    With a network-tier directory mounted, every shard of the fleet
    shares that one tier instead of a private disk tier: safe, because
    every hit is replay-verified (mythril_tpu/service/store.py:473)."""
    global _store
    if _store is None:
        net_root = os.environ.get("MYTHRIL_GPU_NET_TIER_DIR")
        if net_root:
            # imported here: fleet/ imports service/, not the reverse
            from mythril_tpu_torch.fleet.netstore import NetworkResultStore

            _store = NetworkResultStore(net_root)
        else:
            _store = PersistentResultStore()
    return _store


def reset_result_store() -> None:
    global _store
    _store = None
