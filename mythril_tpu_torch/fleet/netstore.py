"""The shared network result tier: the content-addressed disk tier
(service/store.py) as a directory every shard of the fleet mounts
(MYTHRIL_GPU_NET_TIER_DIR; mythril_tpu.fleet.netstore on the port).

The entry format is the disk tier's, byte for byte. Its trust model never
depended on who wrote an entry: a SAT hit is replayed through
Solver._reconstruct against the original constraints, an UNSAT hit is
trusted on the detection path only with crosscheck provenance. What
changes is the failure domain: a corrupt entry may have been written by
another shard, so this store carries its own fault site (netstore.entry,
quarantine): the reading shard quarantines the entry and misses, counted
net_tier_verify_rejects, and the writer runs on untouched. Writes take the
disk tier's stale-lock discipline (support/lock.py) on the shared
directory, so a shard that dies mid-write cannot wedge the others."""

import logging
from typing import Optional

from mythril_tpu_torch.fleet import net_tier_dir
from mythril_tpu_torch.service.store import PersistentResultStore

log = logging.getLogger(__name__)


class NetworkResultStore(PersistentResultStore):
    """PersistentResultStore on the fleet-shared directory, with the
    netstore.entry fault site on its read path."""

    is_network = True
    entry_site = "netstore.entry"

    def __init__(self, root: Optional[str] = None,
                 max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        super().__init__(root=root or net_tier_dir() or None,
                         max_entries=max_entries, max_bytes=max_bytes)

    def _entry_guard(self, text: str) -> str:
        from mythril_tpu_torch.resilience import corrupt_text, maybe_inject

        maybe_inject("netstore.entry")
        return corrupt_text("netstore.entry", text)
