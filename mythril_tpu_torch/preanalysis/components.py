"""Shared native connectivity pass for the static partitioning passes.

Both variable-disjointness splits in the preanalysis layer — the CNF
connected-component split at the host-CDCL settle (cnf_prep.py) and the
AIG-level partition with per-component root projection (aig_partition.py)
— reduce to connected components of a sparse incidence graph. scipy's
csgraph pass is native and runs in ~1 ms at the split caps, where a
Python union-find measured 150+ ms — too expensive for a decision that
usually answers "one component, no split". This module is the single
implementation both callers share (a copy of
mythril_tpu.preanalysis.components).
"""

from typing import Optional

import numpy as np


def connected_labels(num_nodes: int, edges_u, edges_v) -> Optional[np.ndarray]:
    """Component label per node of an undirected graph given as parallel
    edge-endpoint arrays. Returns None when scipy is unavailable (callers
    degrade to "no split") or the graph is empty."""
    if num_nodes <= 0:
        return None
    try:
        import scipy.sparse as sparse
        from scipy.sparse.csgraph import connected_components
    except ImportError:
        return None  # no native connectivity pass: splitting not worth it
    edges_u = np.asarray(edges_u, dtype=np.int64)
    edges_v = np.asarray(edges_v, dtype=np.int64)
    graph = sparse.coo_matrix(
        (np.ones(len(edges_u), dtype=np.int8), (edges_u, edges_v)),
        shape=(num_nodes, num_nodes))
    _count, labels = connected_components(graph, directed=False)
    return labels
