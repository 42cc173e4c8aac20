"""Cross-process affinity routing: the AffinityRouter lifted one tier
(the JAX package's ``fleet/router.py``).

The fleet routes with :class:`~amgx_tpu_torch.serve.placement.router.
AffinityRouter`'s host-pure state: slots are worker processes, warmth is
a worker's hierarchy cache (and its warm-booted store entries), and a
:class:`~amgx_tpu_torch.serve.placement.health.DeviceHealthBoard` is the
per-worker breaker.  A dead process is a lost device one tier up, with
the same trip -> half-open probe -> close chain and the same
``AMGX_TPU_BREAKER_PROBE_EVERY`` cadence.

Oversized patterns (``n_rows`` at or above ``AMGX_TPU_DIST_ROWS``,
default 65,536) are restricted to workers that announced
``dist_capable``, where there are any.  The port's workers run
``SingleDevicePolicy`` and are never ``dist_capable``, so an oversized
pattern routes over every worker.
"""

from __future__ import annotations

import os
import threading
from typing import Optional


def dist_row_threshold(value: Optional[int] = None) -> int:
    """Row count at which routing prefers a distributed-capable worker:
    ``value``, else ``AMGX_TPU_DIST_ROWS``, else 65,536."""
    if value is not None:
        return int(value)
    # the serve package loads on first use, not when the fleet's is
    # imported
    from amgx_tpu_torch.serve.placement.router import (
        DEFAULT_ROW_THRESHOLD,
        ENV_ROW_THRESHOLD,
    )

    try:
        return int(os.environ.get(ENV_ROW_THRESHOLD,
                                  str(DEFAULT_ROW_THRESHOLD)))
    except ValueError:
        return DEFAULT_ROW_THRESHOLD


class FleetRouter:
    """Routing + health for a bounded pool of worker slots.

    Slots (0..capacity-1) are stable identities across restarts: a
    replacement worker attaches at its predecessor's slot and inherits
    its breaker (the half-open probe against the NEW process is what
    closes it — the probe that proves the replacement serves).  The
    router is pure host state; the frontend owns sockets.
    """

    def __init__(self, capacity: int = 16, dist_rows: Optional[int] = None,
                 trip_threshold: int = 1, probe_every: Optional[int] = None):
        if capacity < 1:
            raise ValueError("FleetRouter needs capacity >= 1")
        from amgx_tpu_torch.serve.placement.health import DeviceHealthBoard
        from amgx_tpu_torch.serve.placement.router import AffinityRouter

        self.capacity = int(capacity)
        self.router = AffinityRouter(self.capacity)
        self.board = DeviceHealthBoard(
            self.capacity, trip_threshold=trip_threshold,
            probe_every=probe_every,
        )
        self.dist_rows = dist_row_threshold(dist_rows)
        self._lock = threading.Lock()
        self._active: set = set()       # attached slots
        self._dist: set = set()         # dist-capable subset
        self.dist_routed = 0
        self.fallbacks = 0              # routed with every pool slot tripped

    # -- membership ----------------------------------------------------

    def add_worker(self, slot: int, dist_capable: bool = False) -> None:
        if not 0 <= slot < self.capacity:
            raise ValueError(
                f"slot {slot} outside router capacity {self.capacity}"
            )
        with self._lock:
            self._active.add(slot)
            if dist_capable:
                self._dist.add(slot)
            else:
                self._dist.discard(slot)

    def remove_worker(self, slot: int) -> None:
        """Detach a slot (orderly restart): its warm set is forgotten
        — the REPLACEMENT re-warms from the shared store — but its
        breaker state is left alone (an orderly drain is not a
        failure)."""
        with self._lock:
            self._active.discard(slot)
            self._dist.discard(slot)
        self.router.forget_device(slot)

    def active_slots(self) -> list:
        with self._lock:
            return sorted(self._active)

    # -- routing -------------------------------------------------------

    def _pool(self, n_rows: Optional[int]) -> set:
        with self._lock:
            pool = set(self._active)
            if (
                n_rows is not None
                and n_rows >= self.dist_rows
                and self._dist & pool
            ):
                pool = self._dist & pool
                self.dist_routed += 1
            return pool

    def route(self, fingerprint, n_rows: Optional[int] = None) -> tuple:
        """(slot, was_warm) for one request; reserves one load unit
        until :meth:`settle`/:meth:`release`.

        The degrade chain, over worker breakers: a tripped slot whose
        probe is due takes the request as its half-open probe; otherwise
        route among healthy pool slots; with the whole pool tripped,
        route anyway (counted ``fallbacks``: the fleet keeps serving, and
        the request doubles as a probe)."""
        pool = self._pool(n_rows)
        if not pool:
            raise RuntimeError("no workers attached")
        tripped = [
            i for i in self.board.tripped_indices() if i in pool
        ]
        for i in tripped:
            if self.board.probe_due(i):
                return self.router.route_to(fingerprint, i)
        healthy = pool - set(tripped)
        if healthy:
            return self.router.route(fingerprint, allowed=healthy)
        with self._lock:
            self.fallbacks += 1
        return self.router.route(fingerprint, allowed=pool)

    def peek(self, fingerprint) -> Optional[int]:
        return self.router.peek(fingerprint)

    # -- settlement / health -------------------------------------------

    def settle(self, slot: int, wire_s: float) -> None:
        """Request completed (success OR typed application error —
        the worker is fine either way): release load, charge wire
        time, close/reset the slot's breaker."""
        self.router.settle(slot, wire_s)
        self.board.ok(slot)

    def release(self, slot: int) -> None:
        self.router.release(slot)

    def failure(self, slot: int) -> bool:
        """A worker-attributed failure (connection loss, mid-frame
        disconnect): trip the breaker and forget the slot's warm set —
        its process state is gone.  True when this call tripped."""
        tripped = self.board.failure(slot)
        self.router.forget_device(slot)
        return tripped

    def snapshot(self) -> dict:
        r = self.router.snapshot()
        with self._lock:
            r.update({
                "active": sorted(self._active),
                "dist_capable": sorted(self._dist),
                "dist_routed": self.dist_routed,
                "fallbacks": self.fallbacks,
                "dist_rows": self.dist_rows,
            })
        r["health"] = self.board.snapshot()
        return r
