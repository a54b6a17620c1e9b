"""One fleet shard: a process running the serve daemon, launched by the
supervisor as

    python -m mythril_tpu_torch.fleet.worker --shard-id N --announce PATH \
        [--solver-backend gpu|cpu] [--torch-device DEVICE]

(mythril_tpu.fleet.worker on the port's sources). It applies the tuned
profile (tune/) before its daemon is built, as `serve` does. The worker
owns what the one-process daemon owns and adds nothing: being a shard is the supervisor's routing
and the shared network tier it mounts through MYTHRIL_GPU_NET_TIER_DIR
(inherited env). With that tier mounted the worker takes the disk cache
mode, so every verdict it settles is published where the fleet can serve
it, and a crash-only restart re-warms from it.

The announce file ({"pid", "port", "shard_id"}, an atomic rename) is the
start handshake: the worker resolves its device and loads the kernels
(ServeDaemon.start), binds an ephemeral port, writes the announcement
and blocks until drained. Without a card and without --torch-device, or
with a kernel that does not load, it exits 2 before announcing. It exits
2 as well once its daemon stopped serving on a device fault, and 0 after
a SIGTERM drain.
"""

import argparse
import logging
import os
import sys

log = logging.getLogger(__name__)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mythril_tpu_torch.fleet.worker")
    parser.add_argument("--shard-id", type=int, required=True)
    parser.add_argument("--announce", required=True)
    parser.add_argument("--tx-count", type=int, default=1)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--modules", default=None)
    parser.add_argument("--solver-backend", default="gpu",
                        choices=["gpu", "cpu"])
    parser.add_argument("--torch-device", default=None)
    parsed = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s shard-{parsed.shard_id} %(levelname)s "
               "%(name)s: %(message)s")
    from mythril_tpu_torch.fleet import net_tier_dir
    from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError
    from mythril_tpu_torch.serve.daemon import (
        ServeDaemon,
        install_signal_handlers,
        wait_until_stopped,
    )
    from mythril_tpu_torch.service.store import atomic_write_json
    from mythril_tpu_torch.support.args import args as global_args
    from mythril_tpu_torch.tune import apply_tuned_profile

    global_args.solver_backend = parsed.solver_backend
    global_args.torch_device = parsed.torch_device
    # the daemon reads its batch width and the device path its knobs at
    # construction: the profile is installed first (keyed by the device
    # just set)
    apply_tuned_profile()
    if net_tier_dir():
        # publish every settled verdict into the fleet-shared tier
        global_args.solve_cache = "disk"
    daemon = ServeDaemon(
        tx_count=parsed.tx_count,
        modules=parsed.modules.split(",") if parsed.modules else None,
        http_port=parsed.port)
    try:
        daemon.start()
    except (NoDeviceError, DeviceFault) as error:
        log.error("shard %d cannot start: %s", parsed.shard_id, error)
        return 2
    install_signal_handlers(daemon)
    if not atomic_write_json(parsed.announce, {
            "pid": os.getpid(),
            "port": daemon.port,
            "shard_id": parsed.shard_id}):
        log.error("could not write announce file %s", parsed.announce)
        daemon.drain(timeout=0.0)
        return 1
    log.info("shard %d serving on port %d (announce %s)",
             parsed.shard_id, daemon.port, parsed.announce)
    return wait_until_stopped(daemon)


if __name__ == "__main__":
    sys.exit(main())
