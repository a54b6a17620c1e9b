"""Version of the mythril_tpu_torch framework.

Reference parity target: mythril v0.24.8 (reference mythril/__version__.py:7).
"""

__version__ = "0.1.0"
