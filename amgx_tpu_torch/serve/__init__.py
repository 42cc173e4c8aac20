"""Batched solve service (the JAX package's ``amgx_tpu.serve``, its
core): many independent sparse solves that share sparsity patterns run
as a few batched groups on one device.

  * :func:`~amgx_tpu_torch.serve.bucketing.pad_pattern` pads each
    request to a (n, nnz, batch) bucket;
  * :class:`~amgx_tpu_torch.serve.cache.HierarchyCache` keeps one setup
    per (padded fingerprint, config, dtype) for every later coefficient
    set;
  * :func:`~amgx_tpu_torch.serve.batched.make_batched_solve` runs a
    group's masked-convergence solve on the batched DIA and ELL kernels
    (converged instances freeze);
  * :class:`~amgx_tpu_torch.serve.metrics.ServeMetrics` holds the
    counters.

Entry point::

    from amgx_tpu_torch.serve import BatchedSolveService
    svc = BatchedSolveService(device="cuda")   # PCG + BLOCK_JACOBI
    results = svc.solve_many([(A0, b0), (A1, b1), ...])

Streaming solve sessions over a service are
:mod:`amgx_tpu_torch.sessions`; warm boot from a setup store is
``BatchedSolveService(store=...)`` and :meth:`warm_boot`
(``amgx_tpu_torch.store.warmboot``).  The admission-controlled door is
:class:`~amgx_tpu_torch.serve.gateway.SolveGateway` (tenant quotas,
priority lanes, the concurrency budget, deadline shedding, drain), on
:mod:`~amgx_tpu_torch.serve.admission`; the client's back-off is
:class:`~amgx_tpu_torch.serve.retry.RetryPolicy`; placement, the device
breakers, device-loss failover and the fetch watchdog are
:mod:`~amgx_tpu_torch.serve.placement` and the service's.  The JAX
package's multi-device placements (``MeshPlacement``,
``AffinityPlacement``, ``AffinityRouter``, ``DistributedPlacement``)
wait for the multi-GPU port (ROADMAP.md, queue A.9).
"""

from amgx_tpu_torch.serve.admission import (
    AdmissionController,
    TenantQuota,
    TokenBucket,
)
from amgx_tpu_torch.serve.batched import make_batched_solve
from amgx_tpu_torch.serve.bucketing import bucket_batch, pad_pattern
from amgx_tpu_torch.serve.cache import HierarchyCache, config_hash
from amgx_tpu_torch.serve.metrics import ServeMetrics
from amgx_tpu_torch.serve.service import (
    CHEAP_PRECONDITIONER_CONFIG,
    COMM_AVOIDING_CONFIG,
    DEFAULT_CONFIG,
    BatchedSolveService,
    SolveTicket,
)
from amgx_tpu_torch.serve.gateway import GatewayTicket, SolveGateway
from amgx_tpu_torch.serve.placement import (
    DeviceHealthBoard,
    PlacementPolicy,
    SingleDevicePolicy,
    breaker_probe_every,
    placement_from_env,
)
from amgx_tpu_torch.serve.retry import DEFAULT_RETRYABLE, RetryPolicy

# the serving stack's name for the service
SolveService = BatchedSolveService

__all__ = [
    "BatchedSolveService",
    "SolveService",
    "DEFAULT_CONFIG",
    "COMM_AVOIDING_CONFIG",
    "CHEAP_PRECONDITIONER_CONFIG",
    "SolveTicket",
    "SolveGateway",
    "GatewayTicket",
    "AdmissionController",
    "TenantQuota",
    "TokenBucket",
    "PlacementPolicy",
    "SingleDevicePolicy",
    "DeviceHealthBoard",
    "breaker_probe_every",
    "RetryPolicy",
    "DEFAULT_RETRYABLE",
    "placement_from_env",
    "HierarchyCache",
    "ServeMetrics",
    "make_batched_solve",
    "pad_pattern",
    "bucket_batch",
    "config_hash",
]
