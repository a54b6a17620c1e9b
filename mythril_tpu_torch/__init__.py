"""mythril_tpu_torch — the EVM bytecode security analyzer mythril_tpu on
PyTorch and CUDA (NVIDIA Hopper).

`python -m mythril_tpu_torch analyze` runs the symbolic EVM and the
detection modules on the host; every batched solve window goes through
the adaptive router to the hand-written circuit-SLS kernel on the card
(csrc/ragged_round.cu), and the host CDCL settles the misses.
"""

from mythril_tpu_torch.version import __version__  # noqa: F401
