"""amgx_tpu_torch.fleet: a multi-process solve fleet over RPC (the JAX
package's ``fleet/``).

Worker processes, each over the port's whole serving stack in one
process (:class:`~amgx_tpu_torch.serve.gateway.SolveGateway`) on its
device, several of them sharing one card if need be, are wired together
by a stdlib-only length-prefixed protocol (:mod:`~amgx_tpu_torch.fleet.
wire`, the JAX package's frames byte for byte), discovered through a
file-based registry (:mod:`~amgx_tpu_torch.fleet.registry`), and
fronted by a client that routes on fingerprint affinity across
processes with a circuit breaker per worker
(:mod:`~amgx_tpu_torch.fleet.frontend`, :mod:`~amgx_tpu_torch.fleet.
router`).  Rolling restarts drain through the shared
:class:`~amgx_tpu_torch.store.store.ArtifactStore`, so that a
replacement worker's first repeat fingerprint is a cache hit
(:mod:`~amgx_tpu_torch.fleet.lifecycle`).

Importing this package does not import the serve stack: the frontend,
the worker and the lifecycle load on first use, so the C API can read
``AMGX_TPU_FLEET`` cheaply.
"""

from amgx_tpu_torch.fleet.wire import (  # noqa: F401
    WireClosed,
    WireError,
    marshal_error,
    pack_frame,
    read_frame,
    read_frame_async,
    unmarshal_error,
)
from amgx_tpu_torch.fleet.registry import (  # noqa: F401
    WorkerRecord,
    WorkerRegistry,
)
from amgx_tpu_torch.fleet.router import FleetRouter  # noqa: F401

__all__ = [
    "WireClosed", "WireError", "marshal_error", "pack_frame",
    "read_frame", "read_frame_async", "unmarshal_error",
    "WorkerRecord", "WorkerRegistry", "FleetRouter",
    "FleetFrontend", "FleetTicket", "FleetWorker",
    "FleetSupervisor", "launch_fleet",
]


def __getattr__(name):
    # lazy: the frontend, the worker and the lifecycle pull in the
    # serve stack
    if name in ("FleetFrontend", "FleetTicket"):
        from amgx_tpu_torch.fleet import frontend

        return getattr(frontend, name)
    if name == "FleetWorker":
        from amgx_tpu_torch.fleet.worker import FleetWorker

        return FleetWorker
    if name in ("FleetSupervisor", "launch_fleet"):
        from amgx_tpu_torch.fleet import lifecycle

        return getattr(lifecycle, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
