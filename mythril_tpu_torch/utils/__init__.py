"""Cross-cutting utilities: keccak-256, u256 helpers, global flags, clocks."""
