"""Digest-keyed shard router: rendezvous (highest-random-weight) hashing
over the live shards (mythril_tpu.fleet.router on the port).

The key is the request's bytecode digest, domain-separated with the
FINGERPRINT_SCHEMA version that keys the result tiers, so identical
bytecode from different tenants lands on one shard's warm memory tier and
a schema bump re-shards along with the tier wipe. The domain string and
the schema are the JAX package's, so equal inputs pick equal shards in
both packages. When a shard dies only the keys that scored it highest
move.

Fault site fleet.route (disable): a fault in the scoring degrades to
round-robin placement for the session (a fuse after repeated faults);
requests still land on a live shard. Every decision counts
fleet_shard_routes."""

import hashlib
from typing import List, Optional, Sequence

from mythril_tpu_torch.service.fingerprint import FINGERPRINT_SCHEMA


def request_digest(code: str) -> str:
    """Content digest of a request's bytecode: the routing key (the sha256
    the daemon folds into its tenant-qualified origins)."""
    return hashlib.sha256(code.encode()).hexdigest()


def _score(digest: str, shard_id: int) -> int:
    raw = hashlib.sha256(
        b"mythril-tpu-fleet-route-v%d:%s:%d"
        % (FINGERPRINT_SCHEMA, digest.encode(), shard_id)).digest()
    return int.from_bytes(raw[:8], "big")


class ShardRouter:
    def __init__(self, shard_ids: Sequence[int]):
        self.shard_ids: List[int] = list(shard_ids)
        self._rr = 0

    def route(self, digest: str,
              live: Optional[Sequence[int]] = None) -> Optional[int]:
        """The shard for `digest` among `live` (default: every registered
        shard); None only when no shard is live."""
        from mythril_tpu_torch import resilience
        from mythril_tpu_torch.resilience import maybe_inject
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        candidates = list(live) if live is not None else self.shard_ids
        if not candidates:
            return None
        shard = None
        if not resilience.fuse_blown("fleet.route"):
            try:
                maybe_inject("fleet.route")
                shard = max(candidates,
                            key=lambda sid: _score(digest, sid))
            except Exception:
                resilience.note_stage_failure("fleet.route")
                shard = None
        if shard is None:
            # round-robin degradation: a live shard, without affinity
            shard = candidates[self._rr % len(candidates)]
            self._rr += 1
        SolverStatistics().add_fleet_route()
        return shard
