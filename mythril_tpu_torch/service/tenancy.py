"""Per-origin blaster registry (the part of mythril_tpu.service.tenancy the
solve path calls).

An origin tag is one analysis's identity in an interleaved corpus run.
The shared strashed AIG assigns node ids in first-use order and the dense
CNF sorts by id, so a process-wide blaster would make the CDCL's
branching — and hence which valid model it returns — depend on which
sibling analysis blasted a common subterm first. Per-origin blasters keep
each analysis's id space its own. The engine-context switch and the
per-session eviction of the JAX package wait for the engine slice.
"""

from typing import Dict, Tuple

# origin -> (Blaster or None, term generation): each analysis's private
# blaster/AIG (None = lazily recreated on first use).
_blasters: Dict[str, Tuple[object, int]] = {}


def install_blaster(origin) -> None:
    """Install `origin`'s private blaster over the process globals."""
    from mythril_tpu_torch.smt.solver import frontend

    (frontend._global_blaster,
     frontend._global_blaster_generation) = _blasters.get(origin,
                                                          (None, -1))


def stash_blaster(origin) -> None:
    """Capture the live process-global blaster as `origin`'s."""
    from mythril_tpu_torch.smt.solver import frontend

    _blasters[origin] = (frontend._global_blaster,
                         frontend._global_blaster_generation)


def clear_blasters() -> None:
    _blasters.clear()
