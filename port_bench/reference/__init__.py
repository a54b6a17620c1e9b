"""The plain reference: Python and NumPy only. It imports neither jax, nor
mythril_tpu, nor anything of mythril_tpu_torch, and takes nothing the
program made: it works the answers out again from the benchmark's own
inputs and only reads the program's outputs to judge them."""
