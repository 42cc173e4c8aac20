"""Placement policies: where a flushed serve group runs (the JAX
package's ``serve/placement/policy.py``).

  the flush resolves the group's hierarchy entry
        |
        v
  policy.plan(service, entry, Bb) --> GroupPlan (device, built batched
        |                              solve, host -> device transfer,
        |                              fetch accounting)
        v
  dispatch stage: plan.put(staged rows) -> plan.fn(...) -> one fetch

The port has one policy, :class:`SingleDevicePolicy` (the JAX package's
default): every group on the service's device, through the shared
:class:`~amgx_tpu_torch.serve.cache.CompileCache` callable.  Select it
with the service's ``placement=`` or ``AMGX_TPU_PLACEMENT``
(``single``, or unset).  The JAX package's multi-device specs
(``mesh[:N]``, ``affinity``, ``distributed[:N]``) parse as there, and
a malformed one raises the same ``ValueError``; a well-formed one raises
``NotImplementedError``: its policies wait for the multi-GPU port
(ROADMAP.md, queue A.9).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

ENV_VAR = "AMGX_TPU_PLACEMENT"
_A9 = "ROADMAP.md, queue A.9 (multi-GPU)"


class GroupPlan:
    """One flushed group's placement, resolved by
    :meth:`PlacementPolicy.plan` on the flush's host stage.

    ``fn(template, vals_B, b_B, x0_B)`` is the group's built batched
    solve, ``put`` the host -> device copy of a batched staging array,
    ``zeros(Bb, nb, dtype)`` a zero x0 block, ``device_label`` the
    device's name for failure attribution (None on a single device).
    The JAX package's ``zeros_key`` and ``donate`` have no use here (the
    port caches no zero block and donates nothing).  Hooks, each called
    by the service under a degrade-never-raise guard:
    ``on_fetch(res, device_s)`` after the group's one fetch,
    ``abandon()`` when the group fails before it, and
    ``device_failure(exc)`` when a device loss is attributed to the
    plan's device; each runs once a plan."""

    __slots__ = (
        "fn", "put", "zeros", "device_label", "_on_fetch", "_on_abandon",
        "_on_device_failure", "_settled", "_failed",
    )

    def __init__(self, fn: Callable, put: Callable, zeros: Callable,
                 device_label: Optional[str] = None,
                 on_fetch: Optional[Callable] = None,
                 on_abandon: Optional[Callable] = None,
                 on_device_failure: Optional[Callable] = None):
        self.fn = fn
        self.put = put
        self.zeros = zeros
        self.device_label = device_label
        self._on_fetch = on_fetch
        self._on_abandon = on_abandon
        self._on_device_failure = on_device_failure
        self._settled = False
        self._failed = False

    def on_fetch(self, res, device_s: float) -> None:
        """The group's one fetch completed (accounted once)."""
        if self._settled:
            return
        self._settled = True
        if self._on_fetch is not None:
            self._on_fetch(res, device_s)

    def abandon(self) -> None:
        """The group failed before its fetch: release any reservation."""
        if self._settled:
            return
        self._settled = True
        if self._on_abandon is not None:
            self._on_abandon()

    def device_failure(self, exc: BaseException) -> None:
        """A device loss attributed to this plan's device (once a plan,
        apart from :meth:`abandon`)."""
        if self._failed:
            return
        self._failed = True
        if self._on_device_failure is not None:
            self._on_device_failure(exc)


class PlacementPolicy:
    """Base of the policies.  ``health`` None: the policy keeps no
    per-device breakers (:class:`~amgx_tpu_torch.serve.placement.health.
    DeviceHealthBoard`; the gateway's ``health()`` reports a policy's
    board).  The JAX package's hooks for multi-device state
    (``entry_for``, ``evicted``, ``evict_signature``, a telemetry
    source) come with its multi-device policies (queue A.9)."""

    name = "single"
    health = None

    def plan(self, service, entry, Bb: int) -> GroupPlan:
        raise NotImplementedError

    def warm(self, service, entry, Bb: int) -> None:
        """Build ahead what a later ``plan`` of (entry, bucket) takes."""

    def device_for(self, fingerprint) -> Optional[str]:
        """The device a routing policy holds ``fingerprint`` on; None
        for a policy that does not route (a streaming session's
        ``placement_device``)."""
        return None

    def describe(self) -> dict:
        return {"policy": self.name}


class SingleDevicePolicy(PlacementPolicy):
    """The default: every group on the service's device, through the
    shared CompileCache callable, host arrays copied to the device."""

    name = "single"

    def plan(self, service, entry, Bb: int) -> GroupPlan:
        import torch

        from amgx_tpu_torch.core.types import torch_dtype

        dev = service.device

        def put(a):
            return torch.from_numpy(a).to(dev, copy=True)

        def zeros(bb, nb, dtype):
            return torch.zeros((bb, nb), dtype=torch_dtype(dtype),
                               device=dev)

        return GroupPlan(fn=service.compile_cache.get(entry, Bb), put=put,
                         zeros=zeros, device_label=None)

    def warm(self, service, entry, Bb: int) -> None:
        service.compile_cache.warm(entry, Bb)


def _multi_device(spec: str, what: str):
    raise NotImplementedError(
        f"{ENV_VAR}={spec!r}: {what} is not ported ({_A9})")


def parse_placement(spec: str) -> PlacementPolicy:
    """The policy of a spec string: ``""`` / ``single`` ->
    :class:`SingleDevicePolicy`.  ``mesh[:N][:local|shared]``,
    ``affinity`` and ``distributed[:N][:pcg|sstep]`` parse as in the JAX
    package and raise ``NotImplementedError`` (queue A.9); anything else
    raises ``ValueError`` (the C API's RC_BAD_CONFIGURATION)."""
    spec = (spec or "").strip()
    if spec in ("", "single"):
        return SingleDevicePolicy()
    if spec == "mesh" or spec.startswith("mesh:"):
        for arg in spec.split(":")[1:]:
            if arg in ("local", "shared"):
                continue
            try:
                shards = int(arg)
            except ValueError:
                raise ValueError(
                    f"{ENV_VAR}: mesh option must be a shard count or "
                    f"local|shared, got {arg!r}") from None
            if shards <= 0:
                raise ValueError(
                    f"{ENV_VAR}: mesh shard count must be positive, got "
                    f"{shards}")
        _multi_device(spec, "MeshPlacement")
    if spec == "affinity":
        _multi_device(spec, "AffinityPlacement")
    if spec == "distributed" or spec.startswith("distributed:"):
        for arg in spec.split(":")[1:]:
            if arg in ("pcg", "sstep"):
                continue
            try:
                shards = int(arg)
            except ValueError:
                raise ValueError(
                    f"{ENV_VAR}: distributed option must be a shard "
                    f"count or pcg|sstep, got {arg!r}") from None
            if shards <= 0:
                raise ValueError(
                    f"{ENV_VAR}: distributed shard count must be "
                    f"positive, got {shards}")
        _multi_device(spec, "DistributedPlacement")
    raise ValueError(
        f"{ENV_VAR}: unknown placement policy {spec!r} "
        "(expected single | mesh[:N] | affinity | distributed[:N])")


def placement_from_env() -> PlacementPolicy:
    """The policy ``AMGX_TPU_PLACEMENT`` names (unset: single)."""
    return parse_placement(os.environ.get(ENV_VAR, ""))


def resolve_placement(placement) -> PlacementPolicy:
    """The service's ``placement=``: None -> the environment, a string
    -> parsed, a policy -> itself."""
    if placement is None:
        return placement_from_env()
    if isinstance(placement, str):
        return parse_placement(placement)
    if isinstance(placement, PlacementPolicy):
        return placement
    raise TypeError(
        "placement must be None, a spec string, or a PlacementPolicy; "
        f"got {type(placement).__name__}")
