"""`mythril_tpu_torch serve`: the multi-tenant analyzer daemon
(mythril_tpu.serve on the port's sources).

Every warm asset of the stack (K1's calibration, the memory and disk
tiers, the session strash table, the prefix snapshots) lives in one
process; a CLI run builds them anew each time. This package is the
long-lived loop that keeps them across requests:

  daemon.py   the request queue in front of MythrilAnalyzer: bounded
              admission with per-tenant budgets, tenants' requests
              batched onto one interleave coordinator (so their windows
              ride mixed-origin K1 streams on the card), per-request
              hard deadlines on a dedicated runner, graceful drain, the
              fault sites serve.request, serve.admission and
              serve.worker, and the port's device-fault rule.
  httpd.py    the localhost HTTP listener: POST /analyze, POST /evict,
              GET /healthz, GET /metrics, GET /snapshot.

Restarts are crash-only: the daemon keeps nothing of its own on disk, and
a restarted process re-warms from the durable tiers under
MYTHRIL_GPU_CACHE_DIR (or the fleet's MYTHRIL_GPU_NET_TIER_DIR).
"""

from mythril_tpu_torch.serve.daemon import ServeDaemon, ServeRequest  # noqa: F401
