"""Per-device failure breakers under the placement policies (the JAX
package's ``serve/placement/health.py``).

A device that loses a dispatch or a fetch (a typed
:class:`~amgx_tpu_torch.core.errors.DeviceLostError`, or the fetch
watchdog expiring) trips its breaker:

  healthy --failure x threshold--> tripped --every Nth plan--> half-open
     ^                                                           probe
     +----------------- the probe group succeeds ------------------+

A tripped device gets no new group, except every Nth placement that
would have used it, the half-open probe whose successful fetch closes
the breaker.  The cadence is the knob of the fingerprint breaker too
(:func:`breaker_probe_every`: ``AMGX_TPU_BREAKER_PROBE_EVERY``, default
8).  Host state only.  Counters go to the owning service's
``ServeMetrics`` as ``resilience_*`` (``amgx_resilience_*`` families).

The port's one placement policy, :class:`~amgx_tpu_torch.serve.placement.
policy.SingleDevicePolicy`, keeps no board (its one degrade target is
itself); the board is here for the multi-device policies (ROADMAP.md,
queue A.9) and for the service's probe cadence.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

_PROBE_DEFAULT = 8
ENV_PROBE = "AMGX_TPU_BREAKER_PROBE_EVERY"


def breaker_probe_every(value: Optional[int] = None) -> int:
    """The half-open probe cadence of the fingerprint and device
    breakers: ``value`` where given, else ``AMGX_TPU_BREAKER_PROBE_EVERY``,
    else 8.  A value below 1, or a malformed one, falls back to 8, so a
    typo never strands a breaker open."""
    if value is None:
        raw = os.environ.get(ENV_PROBE, "")
        try:
            value = int(raw) if raw else _PROBE_DEFAULT
        except ValueError:
            value = _PROBE_DEFAULT
    value = int(value)
    return value if value >= 1 else _PROBE_DEFAULT


class DeviceHealthBoard:
    """Failure breakers of ``n`` placement devices.  ``failure(i)``
    counts a device-attributed failure and trips at ``trip_threshold``
    (default 1); ``ok(i)`` closes (a successful fetch, the probe's in
    particular); ``probe_due(i)``: for a tripped device, True on every
    ``probe_every``-th call.  Thread-safe; ``metrics`` (a
    ServeMetrics) receives ``resilience_device_trips`` / ``_probes`` /
    ``_closes`` and the ``resilience_devices_unhealthy`` gauge."""

    def __init__(self, n_devices: int, trip_threshold: int = 1,
                 probe_every: Optional[int] = None, metrics=None):
        if n_devices < 1:
            raise ValueError("DeviceHealthBoard needs >= 1 device")
        self.n = int(n_devices)
        self.trip_threshold = max(int(trip_threshold), 1)
        self.probe_every = breaker_probe_every(probe_every)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._fails = [0] * self.n
        self._tripped = [False] * self.n
        self._probe_counts = [0] * self.n
        self.trips = 0
        self.probes = 0
        self.closes = 0

    # -- metrics (degrade, never raise) --------------------------------

    def _inc(self, name: str):
        if self.metrics is not None:
            try:
                self.metrics.inc(name)
            except Exception:  # noqa: BLE001 — never fails a placement
                pass

    def _gauge_unhealthy(self):
        if self.metrics is not None:
            try:
                self.metrics.set_gauge("resilience_devices_unhealthy",
                                       sum(self._tripped))
            except Exception:  # noqa: BLE001
                pass

    # -- state transitions ---------------------------------------------

    def failure(self, index: int) -> bool:
        """One device-attributed failure; True when this call tripped
        the breaker (an open one counts nothing)."""
        if not 0 <= index < self.n:
            return False
        with self._lock:
            if self._tripped[index]:
                return False
            self._fails[index] += 1
            if self._fails[index] < self.trip_threshold:
                return False
            self._tripped[index] = True
            self._probe_counts[index] = 0
            self.trips += 1
            self._inc("resilience_device_trips")
            self._gauge_unhealthy()
            return True

    def ok(self, index: int) -> None:
        """A fetch succeeded on the device: reset its count, and close
        its breaker if tripped (the half-open probe)."""
        if not 0 <= index < self.n:
            return
        with self._lock:
            self._fails[index] = 0
            if self._tripped[index]:
                self._tripped[index] = False
                self.closes += 1
                self._inc("resilience_device_closes")
                self._gauge_unhealthy()

    def probe_due(self, index: int) -> bool:
        """For a tripped device, one tick of the probe cadence: True on
        its multiple.  A healthy device never probes."""
        if not 0 <= index < self.n:
            return False
        with self._lock:
            if not self._tripped[index]:
                return False
            self._probe_counts[index] += 1
            if self._probe_counts[index] % self.probe_every:
                return False
            self.probes += 1
            self._inc("resilience_device_probes")
            return True

    # -- views ---------------------------------------------------------

    def healthy(self, index: int) -> bool:
        with self._lock:
            return 0 <= index < self.n and not self._tripped[index]

    def healthy_indices(self) -> list:
        with self._lock:
            return [i for i in range(self.n) if not self._tripped[i]]

    def tripped_indices(self) -> list:
        with self._lock:
            return [i for i in range(self.n) if self._tripped[i]]

    def healthy_prefix(self) -> int:
        """The length of the longest all-healthy prefix of the devices
        (a mesh is a prefix: a tripped device caps it)."""
        with self._lock:
            for i in range(self.n):
                if self._tripped[i]:
                    return i
            return self.n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "devices": self.n,
                "unhealthy": sum(self._tripped),
                "tripped": [i for i in range(self.n) if self._tripped[i]],
                "trips": self.trips,
                "probes": self.probes,
                "closes": self.closes,
                "probe_every": self.probe_every,
            }
