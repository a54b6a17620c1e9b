"""Sharded serve fleet: several engine processes behind one front door
(mythril_tpu.fleet on the port's sources).

  router      (router.py) a rendezvous-hash shard router keyed on the
              request's bytecode digest, domain-separated with the
              FINGERPRINT_SCHEMA version, so identical bytecode from
              different tenants lands on one shard's warm memory tier.
              Fault site fleet.route (disable): round-robin placement.
  netstore    (netstore.py) the disk result tier as a directory every
              shard mounts (MYTHRIL_GPU_NET_TIER_DIR). Every SAT hit is
              replay-verified against the original constraints, so an
              entry any shard wrote is safe to serve; a corrupt one is
              quarantined on the reading shard (fault site
              netstore.entry).
  supervisor  (supervisor.py + worker.py) each shard is a process running
              the serve daemon on the same card (its own CUDA context);
              the supervisor builds the kernels once before spawning,
              probes the shards, restarts a dead one crash-only,
              re-routes a failed shard's request once (fault site
              fleet.shard), broadcasts evictions, and merges every
              shard's metrics into one /metrics.

Knobs (see README "Serve and the fleet"):
  MYTHRIL_GPU_FLEET_SHARDS          shards for `serve` (--shards wins;
                                    1 = one process)
  MYTHRIL_GPU_NET_TIER_DIR          the shared network-tier directory;
                                    unset = each process keeps a private
                                    disk tier under MYTHRIL_GPU_CACHE_DIR
  MYTHRIL_GPU_FLEET_PROBE_INTERVAL  health-probe cadence, seconds (2.0)
  MYTHRIL_GPU_FLEET_START_TIMEOUT   a shard's start and announce wait,
                                    seconds (120)
"""

import os

from mythril_tpu_torch.support.env import env_float

FLEET_SHARDS_ENV = "MYTHRIL_GPU_FLEET_SHARDS"
NET_TIER_DIR_ENV = "MYTHRIL_GPU_NET_TIER_DIR"
PROBE_INTERVAL_ENV = "MYTHRIL_GPU_FLEET_PROBE_INTERVAL"
START_TIMEOUT_ENV = "MYTHRIL_GPU_FLEET_START_TIMEOUT"

DEFAULT_PROBE_INTERVAL_S = 2.0
DEFAULT_START_TIMEOUT_S = 120.0


def fleet_shards(cli_value=None) -> int:
    """Shard count: the CLI flag, else the env, else 1 (one process)."""
    if cli_value:
        return max(1, int(cli_value))
    return max(1, int(env_float(FLEET_SHARDS_ENV, 1)))


def net_tier_dir() -> str:
    """The shared network-tier root ('' when none is mounted)."""
    return os.environ.get(NET_TIER_DIR_ENV) or ""


def probe_interval_s() -> float:
    return max(0.05, env_float(PROBE_INTERVAL_ENV,
                               DEFAULT_PROBE_INTERVAL_S))


def start_timeout_s() -> float:
    return max(1.0, env_float(START_TIMEOUT_ENV, DEFAULT_START_TIMEOUT_S))
