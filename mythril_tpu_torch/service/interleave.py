"""The origin half of mythril_tpu.service.interleave.

In the JAX package a coordinator runs N contracts' analyses in one
process, one at a time on a baton, so their sibling queries share one
coalescing window and one device stream. The solve path reads two things
from it: the origin (contract identity) of the analysis holding the baton,
and a per-query blaster scope for mixed windows. The coordinator itself
waits for the corpus slice; until then no analysis holds a baton and the
origin is None.
"""

from contextlib import contextmanager
from typing import Optional

from mythril_tpu_torch.service import tenancy

# the live coordinator's origin (None: no interleaved run)
_current: Optional[str] = None


def current_origin() -> Optional[str]:
    """Origin tag of the analysis holding the baton; None outside an
    interleaved run."""
    return _current


@contextmanager
def blaster_scope(origin):
    """Temporarily install `origin`'s blaster over the ambient one — the
    per-QUERY seam get_models_batch uses during a mixed window flush,
    where one baton holder prepares several origins' queries. No-op for
    untagged queries and when `origin` already holds the baton."""
    if origin is None or origin == current_origin():
        yield
        return
    from mythril_tpu_torch.smt.solver import frontend

    saved = (frontend._global_blaster, frontend._global_blaster_generation)
    tenancy.install_blaster(origin)
    try:
        yield
    finally:
        tenancy.stash_blaster(origin)
        (frontend._global_blaster,
         frontend._global_blaster_generation) = saved
