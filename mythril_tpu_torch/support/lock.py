"""Inter-process file lock around the calibration cache's writes (a copy
of mythril_tpu.support.lock with the knob prefix changed; the JAX
package's fault-injection crossing is not ported).

POSIX-only flock. The lock file records its owner (`pid ts`) on acquire.
A contended acquire checks whether the recorded owner is still alive
(pid liveness probe) and whether the lock has exceeded its max age
(DEFAULT_MAX_AGE_S) — critical sections under it hold the lock for
milliseconds, so a minutes-old lock is a crashed or wedged holder, not a
slow one. A stale lock is BROKEN once (the path is unlinked and re-taken
on a fresh inode; counted as a `stale_break` resilience event) instead of
deadlocking every later access. If the lock still cannot be acquired by
the timeout, acquire proceeds unlocked (counted `degraded`) — every write
under these locks is an atomic rename, so an unlocked writer can lose a
race, never corrupt the target."""

import contextlib
import logging
import os
import time

log = logging.getLogger(__name__)

DEFAULT_MAX_AGE_S = 300.0


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        # EPERM etc.: the pid exists but belongs to someone else
        return True
    return True


class LockFile:
    def __init__(self, path: str, timeout_seconds: float = 10.0,
                 stale_age_seconds: float = 0.0):
        self.path = path
        self.timeout_seconds = timeout_seconds
        self.stale_age_seconds = stale_age_seconds or DEFAULT_MAX_AGE_S
        self._handle = None

    def acquire(self) -> None:
        import fcntl

        from mythril_tpu_torch import resilience

        deadline = time.monotonic() + self.timeout_seconds
        self._handle = open(self.path, "a+")
        broke_stale = False
        while True:
            try:
                fcntl.flock(self._handle, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                if not broke_stale and self._is_stale():
                    # break at most once per acquire: a second contention
                    # after the break is a LIVE holder on the new inode
                    broke_stale = True
                    self._break_stale()
                    continue
                if time.monotonic() > deadline:
                    # could not get the lock and it is not provably
                    # stale: proceed unlocked rather than deadlock the
                    # analysis on a cache lock
                    resilience.record_event("store.lock", "degraded")
                    log.warning(
                        "could not acquire %s within %.1fs (live holder?);"
                        " proceeding unlocked", self.path,
                        self.timeout_seconds)
                    return
                time.sleep(0.05)
            else:
                if not self._holds_current_inode():
                    # a contender broke the (stale) lock between our
                    # open and our flock: we hold the ORPHANED inode, so
                    # the flock means nothing — re-contend on the path's
                    # current inode instead of entering the critical
                    # section alongside the breaker
                    with contextlib.suppress(OSError):
                        self._handle.close()
                    self._handle = open(self.path, "a+")
                    continue
                self._write_owner()
                return

    def _holds_current_inode(self) -> bool:
        """A successful flock only excludes contenders of the SAME inode;
        after a stale-lock break the path may point to a fresh one."""
        try:
            return (os.fstat(self._handle.fileno()).st_ino
                    == os.stat(self.path).st_ino)
        except OSError:
            return False

    # -- stale detection ----------------------------------------------------

    def _read_owner(self):
        """(pid, stamp_mtime) recorded by the current holder, or None when
        the lock file carries no readable owner record."""
        try:
            with open(self.path) as fd:
                first = fd.readline().split()
            return int(first[0]) if first else None
        except (OSError, ValueError, IndexError):
            return None

    def _is_stale(self) -> bool:
        """A contended lock is stale when its recorded owner pid is dead,
        or when it is older than the max age (critical sections under
        these locks run for milliseconds)."""
        owner = self._read_owner()
        if owner is not None and owner != os.getpid() \
                and not _pid_alive(owner):
            log.warning("lock %s owner pid %d is dead", self.path, owner)
            return True
        try:
            age = time.time() - os.path.getmtime(self.path)
        except OSError:
            return False
        if age > self.stale_age_seconds:
            log.warning("lock %s is %.0fs old (max age %.0fs)",
                        self.path, age, self.stale_age_seconds)
            return True
        return False

    def _break_stale(self) -> None:
        """Unlink the stale lock path and re-open a fresh inode: the dead
        (or wedged) holder keeps its flock on the ORPHANED inode, and
        every future LockFile contends on the new one."""
        from mythril_tpu_torch import resilience

        resilience.record_event("store.lock", "stale_break")
        log.warning("breaking stale lock %s", self.path)
        with contextlib.suppress(OSError):
            os.unlink(self.path)
        with contextlib.suppress(OSError):
            self._handle.close()
        self._handle = open(self.path, "a+")

    def _write_owner(self) -> None:
        """Record this process as the holder (pid liveness is what a
        contending process probes to detect a crashed holder)."""
        try:
            self._handle.seek(0)
            self._handle.truncate()
            self._handle.write(f"{os.getpid()} {int(time.time())}\n")
            self._handle.flush()
        except (OSError, ValueError):
            pass

    def release(self) -> None:
        if self._handle is None:
            return
        import fcntl

        with contextlib.suppress(OSError):
            fcntl.flock(self._handle, fcntl.LOCK_UN)
        with contextlib.suppress(OSError):
            self._handle.close()
        self._handle = None

    def __enter__(self) -> "LockFile":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
