"""Typed fault-domain registry (a copy of mythril_tpu.resilience.registry:
the same 17 sites, names, actions and kinds).

Every optional stage of the pipeline registers exactly one fault site here
with a declared degradation action. The registry is static data: the lint
(python -m mythril_tpu_torch.resilience.lint) walks it and fails tier-1
when a site lacks an action, is never crossed in the code, or is named by
no chaos test.

Degradation actions:

  retry       transient faults: retry with seeded jittered backoff, then
              degrade (disk writes, lock acquisition, coalesced flushes)
  breaker     per-stage circuit breaker (breaker.py)
  quarantine  a corrupt cache entry is moved aside and the lookup is a
              safe miss
  disable     a fault in a pure-optimization layer degrades the query to
              the full pipeline; repeated faults turn the layer off for
              the session (the fuses in __init__.py)

The device sites differ on the port: a fault at device.dispatch,
device.calibrate, or frontier.step on the cuda step, stops the analysis
with a recorded DeviceFault (gpu/device.py) instead of handing the work to
the host. Their `degrades_to` says so; the host sites degrade as the JAX
package declares. Sites whose surface the port has not ported yet are
named in NOT_PORTED with the ROADMAP item that brings them; the lint
exempts those, and only those, from "wired" and "exercised".
"""

from typing import Dict, NamedTuple, Tuple

ACTIONS = ("retry", "breaker", "quarantine", "disable")

# injection kinds the harness understands (faults.py):
#   raise    raise InjectedFault at the site
#   hang     block at the site (the deadline runner must rescue)
#   delay    short sleep (transient-fault shape for retry sites)
#   corrupt  mangle bytes flowing through the site (cache entries)
#   exit     kill the process (worker-death shape; --jobs workers only)
KINDS = ("raise", "hang", "delay", "corrupt", "exit")

# the device sites' degradation on the port
DEVICE_FAULT_STOPS = ("the analysis stops with a recorded DeviceFault; "
                      "the CLI exits 2")


class FaultSite(NamedTuple):
    name: str
    layer: str            # subsystem the site lives in
    action: str           # declared degradation action (ACTIONS)
    kinds: Tuple[str, ...]  # injection kinds meaningful at this site
    degrades_to: str      # the path a failure lands on


FAULT_SITES: Dict[str, FaultSite] = {
    site.name: site
    for site in (
        FaultSite(
            "device.dispatch", "gpu/router", "breaker",
            ("raise", "hang"),
            DEVICE_FAULT_STOPS + " (a hang is abandoned at the dispatch "
            "budget plus MYTHRIL_GPU_STAGE_GRACE by the deadline runner); "
            "the breaker opens on zero-hit waste"),
        FaultSite(
            "device.calibrate", "gpu/router", "disable",
            ("raise",),
            DEVICE_FAULT_STOPS),
        FaultSite(
            "disk.entry", "service/store", "quarantine",
            ("corrupt", "raise"),
            "entry quarantined, lookup degrades to a safe miss "
            "(counted persistent_verify_rejects)"),
        FaultSite(
            "disk.write", "service/store", "retry",
            ("raise", "delay"),
            "one jittered-backoff retry, then the verdict simply is not "
            "persisted (reads re-solve)"),
        FaultSite(
            "store.lock", "support/lock", "retry",
            ("raise",),
            "stale locks broken (owner-pid liveness + max-age); a broken "
            "lock layer degrades to unlocked atomic-rename writes"),
        FaultSite(
            "scheduler.flush", "service/scheduler", "retry",
            ("raise",),
            "failed window flush retries each buffered query "
            "individually; only a query that fails alone degrades to "
            "unknown (possibly-feasible); a DeviceFault is not retried"),
        FaultSite(
            "prepare.incremental", "smt/solver/incremental", "disable",
            ("raise",),
            "full (non-resumed) prepare pipeline; repeated faults blow "
            "the session fuse"),
        FaultSite(
            "aig.session", "preanalysis/aig_opt", "disable",
            ("raise",),
            "identity rewrite (un-optimized cone); repeated faults blow "
            "the session fuse"),
        FaultSite(
            "frontier.step", "laser/frontier", "disable",
            ("raise",),
            "numpy and torch steps: the per-state interpreter steps the "
            "states, repeated faults blow the session fuse; cuda step: "
            + DEVICE_FAULT_STOPS),
        FaultSite(
            "preanalysis.summary", "preanalysis", "disable",
            ("raise",),
            "no static summary: nothing is gated, every module attaches "
            "(always findings-sound)"),
        FaultSite(
            "jobs.worker", "core", "retry",
            ("raise", "exit"),
            "dead worker's pending contracts requeued into a fresh pool "
            "once, then analyzed in-process; a DeviceFault raised in a "
            "worker stops the run instead"),
        FaultSite(
            "serve.request", "serve/daemon", "quarantine",
            ("raise",),
            "the poisoned request alone answers `error`; sibling "
            "tenants' requests in the same batch complete with findings "
            "untouched"),
        FaultSite(
            "serve.admission", "serve/daemon", "disable",
            ("raise",),
            "fair tenant round-robin admission degrades to plain FIFO "
            "ordering (session fuse after repeated faults); nothing is "
            "dropped, only ordered"),
        FaultSite(
            "serve.worker", "serve/daemon", "retry",
            ("raise", "hang"),
            "wedged worker batch deadline-killed on a dedicated runner "
            "thread (the abandoned body cancels at its next check); its "
            "requests requeue into a fresh batch once, then answer "
            "`incomplete` — never hung, siblings' results kept"),
        FaultSite(
            "fleet.shard", "fleet/supervisor", "retry",
            ("raise",),
            "a dead or faulted shard's in-flight request re-routes once "
            "to a surviving shard, then answers `incomplete`; the "
            "supervisor crash-only restarts the shard, which re-warms "
            "from the shared network tier"),
        FaultSite(
            "fleet.route", "fleet/router", "disable",
            ("raise",),
            "digest-keyed rendezvous routing degrades to round-robin "
            "shard placement for the session (fuse after repeated "
            "faults); requests still land on a live shard, only warm-"
            "tier affinity is lost"),
        FaultSite(
            "netstore.entry", "fleet/netstore", "quarantine",
            ("corrupt", "raise"),
            "corrupt shared-tier entry quarantined on the READING "
            "shard, whose lookup degrades to a safe miss and re-solves; "
            "the writing shard is untouched (counted "
            "net_tier_verify_rejects)"),
    )
}

# sites whose surface is not ported yet, with the ROADMAP.md §1 item that
# brings it: serve and fleet (9)
NOT_PORTED = {
    "serve.request": 9, "serve.admission": 9, "serve.worker": 9,
    "fleet.shard": 9, "fleet.route": 9, "netstore.entry": 9,
}


def validate() -> None:
    """Structural sanity of the registry itself (called by the lint)."""
    for name, site in FAULT_SITES.items():
        assert name == site.name, f"registry key {name!r} != {site.name!r}"
        assert site.action in ACTIONS, \
            f"fault site {name}: unknown action {site.action!r}"
        assert site.kinds, f"fault site {name}: no injection kinds"
        for kind in site.kinds:
            assert kind in KINDS, \
                f"fault site {name}: unknown injection kind {kind!r}"
        assert site.degrades_to, \
            f"fault site {name}: no degradation description"
    for name in NOT_PORTED:
        assert name in FAULT_SITES, f"NOT_PORTED names no site {name!r}"
