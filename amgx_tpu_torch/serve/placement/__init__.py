"""Device placement of the serve layer (the JAX package's
``serve/placement``): :class:`SingleDevicePolicy`, the default and the
port's one policy, and :class:`DeviceHealthBoard`, the per-device
breakers with the probe cadence they share with the fingerprint
breaker (:func:`breaker_probe_every`).  Select with the service's
``placement=`` or ``AMGX_TPU_PLACEMENT``.  :class:`AffinityRouter`
(``router.py``) is the host-pure affinity state the fleet routes worker
processes with.  The JAX package's ``MeshPlacement``,
``AffinityPlacement`` and ``DistributedPlacement`` wait for the
multi-GPU port (ROADMAP.md, queue A.9): their specs parse and raise
``NotImplementedError``.
"""

from amgx_tpu_torch.serve.placement.health import (
    DeviceHealthBoard,
    breaker_probe_every,
)
from amgx_tpu_torch.serve.placement.policy import (
    ENV_VAR,
    GroupPlan,
    PlacementPolicy,
    SingleDevicePolicy,
    parse_placement,
    placement_from_env,
    resolve_placement,
)
from amgx_tpu_torch.serve.placement.router import (
    DEFAULT_ROW_THRESHOLD,
    ENV_ROW_THRESHOLD,
    AffinityRouter,
)

__all__ = [
    "AffinityRouter",
    "DEFAULT_ROW_THRESHOLD",
    "ENV_ROW_THRESHOLD",
    "ENV_VAR",
    "DeviceHealthBoard",
    "breaker_probe_every",
    "GroupPlan",
    "PlacementPolicy",
    "SingleDevicePolicy",
    "parse_placement",
    "placement_from_env",
    "resolve_placement",
]
