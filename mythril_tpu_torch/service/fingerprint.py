"""Canonical content fingerprint of a blasted solver instance (a copy of
mythril_tpu.service.fingerprint: the recipe and its domain strings are the
JAX package's, so both packages key the same prepared query to the same
digest, byte for byte).

The persistent result tier (store.py) is keyed by the *blasted* form of a
query — the dense-renumbered CNF plus the AIG root literals mapped into
the same dense numbering — not by constraint-term identity: term objects
do not survive a process boundary, while the dense cone is a canonical
per-problem artifact (the blaster renumbers every problem's cone compactly
regardless of where it sits in the shared global AIG).

Normalization: literals are sorted within each clause (the Tseitin
exporters emit deterministic but representation-specific literal orders),
clause order is kept as emitted (deterministic for a given cone). A
fingerprint collision can never alias a verdict — SAT entries are
replay-verified against the ORIGINAL constraints on every hit
(support/model._probe_persistent_store) and a failed replay is a safe miss.

Partitioned instances (preanalysis/aig_partition.py) additionally
fingerprint each variable-disjoint component as its OWN sub-instance
(component_fingerprint): a sub-cone shared by different parent queries
hashes identically in both, so the disk tier hits across parents even
when the monolithic fingerprints differ.
"""

import hashlib
import struct
from typing import Optional

# bump on ANY change to the fingerprint recipe or the blasting pipeline's
# canonical form — stale entries must miss, never alias
# v2: instances are fingerprinted AFTER static CNF preprocessing
# (preanalysis/cnf_prep.py) — the same query now hashes its simplified
# clause form, so v1 entries (keyed by the raw Tseitin form) must miss,
# never alias.
# v3: instances are fingerprinted AFTER the AIG structural rewrite
# (preanalysis/aig_opt.py): the canonical form is now the swept/strashed
# cone's dense CNF + rewritten roots, so v2 entries (keyed by the raw
# blasted form) must miss, never alias. Per-component sub-instance
# fingerprints share this version stamp (they flow into the same store).
FINGERPRINT_SCHEMA = 3


def _digest_cnf(digest, num_vars: int, clauses) -> None:
    """Feed (num_vars, canonicalized clauses) into `digest`."""
    digest.update(struct.pack("<q", num_vars))
    if hasattr(clauses, "lits"):
        import numpy as np

        lits = np.asarray(clauses.lits, dtype=np.int64)
        offsets = np.asarray(clauses.offsets, dtype=np.int64)
        lengths = offsets[1:] - offsets[:-1]
        clause_ids = np.repeat(
            np.arange(len(lengths), dtype=np.int64), lengths)
        # within-clause literal sort, clause order preserved: one lexsort
        # over (clause id, literal) — no per-clause Python loop
        order = np.lexsort((lits, clause_ids))
        digest.update(
            np.ascontiguousarray(lits[order].astype(np.int32)).tobytes())
        digest.update(np.ascontiguousarray(offsets).tobytes())
    else:
        for clause in clauses:
            for lit in sorted(clause):
                digest.update(struct.pack("<i", lit))
            digest.update(b";")


def _digest_roots(digest, roots, dense) -> None:
    """AIG roots, mapped global var -> dense var (the cone's canonical
    numbering); constant/outside-cone roots hash as 0."""
    for lit in roots:
        dense_var = dense.get(lit >> 1) or 0
        digest.update(struct.pack("<q", (dense_var << 1) | (lit & 1)))


def instance_fingerprint(prep) -> Optional[str]:
    """sha256 hex digest of `prep`'s blasted instance in canonical form,
    or None when the instance has no blasted CNF (trivial verdicts)."""
    clauses = getattr(prep, "clauses", None)
    if clauses is None or getattr(prep, "blaster", None) is None:
        return None
    digest = hashlib.sha256()
    digest.update(b"mythril-tpu-solve-v%d:" % FINGERPRINT_SCHEMA)
    _digest_cnf(digest, prep.num_vars, clauses)
    if prep.aig_roots is not None:
        _aig, roots, dense = prep.aig_roots
        _digest_roots(digest, roots, dense)
    return digest.hexdigest()


def component_fingerprint(num_vars: int, clauses, roots, dense) -> str:
    """sha256 hex digest of ONE partitioned component's sub-instance
    (its dense-renumbered CNF + projected roots in the same numbering).
    Domain-separated from whole-instance fingerprints so a monolithic
    entry can never alias a component of the same shape."""
    digest = hashlib.sha256()
    digest.update(b"mythril-tpu-component-v%d:" % FINGERPRINT_SCHEMA)
    _digest_cnf(digest, num_vars, clauses)
    _digest_roots(digest, roots, dense)
    return digest.hexdigest()
