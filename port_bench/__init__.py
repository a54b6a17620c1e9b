"""The benchmark of the PyTorch and CUDA port (mythril_tpu_torch): one cell
of BENCHMARK.json a run (`python3 -m port_bench.run`). It never imports the
JAX package (mythril_tpu) nor JAX, and takes from the port only the system
under test, its spans, its counters and its kernels' names."""
