"""The least time a K1 launch could take: a frozen copy of chip_smoke.py's
`_bound` with the published peaks of one H100 SXM (NVIDIA's data sheet):
3.35 TB/s of HBM and 67 TFLOP/s of non-tensor float32, used for K1's
32-bit integer logic, for which the data sheet gives no separate rate.

Each input is counted read once and each output written once, whatever
the kernel reads again; the gate stream's and the root checks' 32-bit
logic over the CUDA-core rate; the walks, whose length depends on the
data, are not counted, so this is a lower bound. It takes only the
launch's shapes: gates, levels, variables, live roots, lanes, steps and
the kernel's capacities."""

HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def k1_bound(num_gates: int, num_levels: int, v1: int, live_roots: int,
             lanes: int, steps: int, var_cap: int, cone_cap: int):
    """(seconds, "bytes" or "operations", bytes moved, operations)."""
    needed = (5 * num_gates + (num_levels + 1) + 5 * v1 + var_cap
              + 3 * live_roots) * 4
    moved = needed + lanes * var_cap * 4 * 2 + lanes * cone_cap
    ops = lanes * (steps + 1) * (3 * num_gates + 2 * live_roots)
    byte_s, op_s = moved / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations",
            moved, ops)
