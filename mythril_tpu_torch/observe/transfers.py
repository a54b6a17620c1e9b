"""The ledger of the port's copies back from the card.

Every device-to-host read on the solve and frontier paths goes through
one of these helpers under a fixed site name (SITES). Each reads exactly
as the bare call it replaces (`.cpu()`, `.cpu().numpy()`, `.tolist()`,
`.item()`) and adds no synchronisation. When the source tensor lives on a
CUDA device it also counts one copy and the tensor's bytes into
SolverStatistics: `d2h_copies`, `d2h_bytes`, and `d2h_sites`, the
{site: [copies, bytes]} section of the stats JSON and the heartbeat's
histograms. A read of a CPU tensor counts nothing. K6's packed step
downloads from C++, so its caller counts the layout's download size with
`downloaded`.

Copies that torch makes inside an operation (the size a `nonzero` or a
boolean mask reads back) are not counted: the device trace sees them,
and no call site owns them.
"""

from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

# site -> what it reads back
SITES = {
    "ragged.found": "a K1/K2 stream round's found flags of its live cones",
    "ragged.x": "a stream round's whole x, when a cone is newly solved",
    "ragged.levels": "the plain K1 round's level starts",
    "bucketed.solved": "a sharded K4 round's solved flag of each slot",
    "bucketed.found": "a K3/K4 round's found flags of its query slots",
    "bucketed.x": "a K3 round's whole x, or a K4 slot's lanes, when a slot "
                  "is newly solved",
    "mesh.row": "one query slot's lanes of a sharded array",
    "frontier.step": "K6's packed step: the outputs in one download",
    "frontier.outputs": "the plain frontier step's ten outputs",
    "circuit.check": "circuit_layout's checks of a batch's tables",
    "circuit.stride": "circuit_layout's stream stride (the most steps)",
    "circuit.rows": "the plain K3 round's live rows a level",
    "xla.shape": "xla_layout's steps and last live root of each cone",
    "xla.rows": "the plain K2 round's live rows a level",
}


def on_card(tensor) -> bool:
    """Whether a read of `tensor` copies from a CUDA device."""
    return tensor.is_cuda


def _count(tensor, site: str) -> None:
    if on_card(tensor):
        SolverStatistics().add_d2h(site, tensor.nbytes)


def to_host(tensor, site: str):
    """tensor.cpu(), counted under `site`."""
    _count(tensor, site)
    return tensor.cpu()


def to_numpy(tensor, site: str):
    """tensor.cpu().numpy(), counted under `site`."""
    _count(tensor, site)
    return tensor.cpu().numpy()


def to_list(tensor, site: str):
    """tensor.tolist(), counted under `site`."""
    _count(tensor, site)
    return tensor.tolist()


def to_int(tensor, site: str) -> int:
    """int(tensor.item()) of a one-element tensor, counted under `site`."""
    _count(tensor, site)
    return int(tensor.item())


def downloaded(site: str, nbytes: int) -> None:
    """Count a download made outside torch (K6's C++ step) of `nbytes`."""
    SolverStatistics().add_d2h(site, nbytes)
