"""Observability of the port (mythril_tpu.observe on the port's sources).

  tracer.py     the span tracer (Chrome trace / Perfetto export with
                MYTHRIL_GPU_TRACE or --trace), which also feeds the flight
                recorder's ring with tracing unarmed.
  roofline.py   per-stage attained against attainable rate, the ceilings
                from the router's calibration, and the reconciled
                solver-wall decomposition: the stats JSON's "roofline".
  metrics.py    the live plane: a typed registry over SolverStatistics,
                the heartbeat JSONL stream (MYTHRIL_GPU_HEARTBEAT or
                --heartbeat), the Prometheus text file (MYTHRIL_GPU_PROM)
                and the run stamp.
  flightrec.py  the always-on flight recorder: the ring of recent spans,
                dumped on a breaker trip or an incomplete run.
  stats_keys.py the lint that every counter reaches the stats JSON and
                the heartbeat snapshot.
  transfers.py  the ledger of the copies back from the card: every read
                of a CUDA tensor on the solve and frontier paths, counted
                by site (d2h_copies, d2h_bytes, the d2h_sites section).
"""

from mythril_tpu_torch.observe.tracer import (  # noqa: F401 (public API)
    TRACE_ENV,
    Tracer,
    get_tracer,
    span,
    traced,
)
