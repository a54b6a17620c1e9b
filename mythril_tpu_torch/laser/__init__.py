"""LASER: the symbolic EVM engine (worklist interpreter over SMT state)."""
