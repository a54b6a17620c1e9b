"""A report against the upstream pinned findings: the multiset of (SWC
id, function, PC address) must equal the pinned one, the function named
by its redrawn selector."""

from collections import Counter


def judge(expected, found, errors: int = 0):
    """None when the report holds exactly the pinned findings and the
    analysis raised nothing, else what differs."""
    if errors:
        return f"the analysis raised {errors} exception(s)"
    missing = Counter(expected) - Counter(found)
    extra = Counter(found) - Counter(expected)
    if not missing and not extra:
        return None
    return (f"missing {sorted(missing.elements())}, "
            f"unexpected {sorted(extra.elements())}")
