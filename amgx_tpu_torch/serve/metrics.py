"""Serve-layer metrics: the counters, gauges, per-bucket occupancy, phase
profile and latency reservoirs of one batched solve service (the JAX
package's ``serve/metrics.py``).

Counter names are the JAX package's: ``submitted``, ``batches``,
``solved``, ``setups``, ``cache_hits`` / ``cache_misses`` /
``cache_evictions``, ``compiles`` / ``bucket_hits`` (the built batched
solves, ``serve/cache.py``), ``fallback_solves``, ``host_syncs``, the
guardrails (``validation_rejects``, ``quarantines``,
``quarantined_solves``, ``poisoned_requests``,
``quarantine_entry_reuses``, ``breaker_trips`` / ``breaker_bypasses`` /
``breaker_closes`` and the ``breakers_open`` gauge, ``failed_groups``,
``deadline_expired`` / ``deadline_expired_fetch``), ``staging_reuses``,
``prewarms``, ``entry_resetups``, ``telemetry_errors`` and the
``queue_depth`` gauge.  The phase profile holds ``pad``, ``setup`` (and
the solver's ``setup:<phase>`` seconds), ``dispatch``, ``fallback`` and
``quarantine``.  ``host_syncs`` counts the port's real device-to-host
reads of a batched group: the residual norms once an iteration and the
fetch (the JAX package reads once a group; ROADMAP.md, queue C).

Latency: every ticket that rides a batched group records its
queue -> pad -> dispatch -> device -> fetch stages and its end-to-end
``total`` into bounded reservoirs (:meth:`record_ticket`), and its
total into its lane's (:meth:`record_lane`); ``snapshot()`` exports
per-stage p50 / p99 and ``ticket_p50_s`` / ``ticket_p99_s``.  Each
ticket's even share of its group's device seconds accumulates per
(tenant, lane) (:meth:`record_tenant_device`); a gateway charges each
share to its tenant's device-seconds budget through
``on_tenant_device``.  A ticket's lane is ``interactive`` or ``batch``
and its tenant ``default`` unless the submit names one.  The gateway
(``gateway_*``, ``shed_<reason>``), the lanes (``batch_deferrals``,
``batch_promotions``) and the failure domains (``resilience_*``) count
here too.

The fetch watchdog reads its own reservoir (:meth:`record_watchdog`,
:meth:`watchdog_p99`): the batched loop's own seconds (its timing
events on the card; off it, its wall seconds bounded by the process's
CPU seconds), not the ``device`` window, which runs to the
fetch, and of every group but the first of each batched solve, whose
one-off first-call cost would lift the watchdog's 25 x p99 floor above
a real hang on a cold service.  The ``device`` stage keeps every group
and its whole window.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import defaultdict

from amgx_tpu_torch.core.profiling import LatencyReservoir, LevelProfile

# per-ticket pipeline stages, in order
TICKET_STAGES = ("queue", "pad", "dispatch", "device", "fetch", "total")


@dataclasses.dataclass
class BucketStat:
    """Time and occupancy of one (n, nnz, batch) bucket."""

    calls: int = 0
    total_s: float = 0.0
    instances: int = 0  # real (non-padding) instances executed
    pad_instances: int = 0  # batch-padding dummies executed


class ServeMetrics:
    """Thread-safe counters of one BatchedSolveService: every mutation
    and every read that iterates goes through the lock (the phase
    profile has its own); readers use :meth:`snapshot`, :meth:`get` and
    the locked percentile readers, never the raw reservoirs."""

    # bound on distinct (tenant, lane) device-seconds keys; overflow
    # traffic aggregates under the "_other" tenant
    _TENANT_DEVICE_CAP = 256

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = defaultdict(int)
        self.buckets: dict = defaultdict(BucketStat)
        self.profile = LevelProfile()
        # float accumulators (device_busy_s, host_busy_s)
        self.times = defaultdict(float)
        self.latency = {s: LatencyReservoir() for s in TICKET_STAGES}
        self.lane_latency = defaultdict(LatencyReservoir)
        # the watchdog's loop seconds (warm groups only)
        self.watchdog_latency = LatencyReservoir()
        self.tenant_device: dict = defaultdict(float)
        # a gateway's device-seconds charge (tenant, lane, seconds),
        # called outside the lock; a failure counts telemetry_errors
        self.on_tenant_device = None

    def inc(self, name: str, by: int = 1):
        with self._lock:
            self.counters[name] += by

    def add_time(self, name: str, seconds: float):
        with self._lock:
            self.times[name] += float(seconds)

    def set_gauge(self, name: str, value: int):
        with self._lock:
            self.counters[name] = value

    def get(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def record_batch(self, bucket_key, seconds: float, n_real: int,
                     n_pad: int):
        with self._lock:
            st = self.buckets[bucket_key]
            st.calls += 1
            st.total_s += seconds
            st.instances += n_real
            st.pad_instances += n_pad

    # -- latency -------------------------------------------------------

    def record_ticket(self, stages: dict):
        """One ticket's stage seconds (names from TICKET_STAGES; others
        are skipped)."""
        with self._lock:
            for name, s in stages.items():
                res = self.latency.get(name)
                if res is not None:
                    res.add(s)

    def record_lane(self, lane: str, seconds: float):
        """One ticket's end-to-end seconds into its lane's reservoir."""
        with self._lock:
            self.lane_latency[lane].add(seconds)

    def record_tenant_device(self, tenant: str, lane: str,
                             seconds: float):
        """One ticket's share of its group's device seconds, against
        its tenant and lane, then the ``on_tenant_device`` charge."""
        with self._lock:
            key = (tenant, lane)
            if (key not in self.tenant_device
                    and len(self.tenant_device) >= self._TENANT_DEVICE_CAP):
                key = ("_other", lane)
            self.tenant_device[key] += float(seconds)
        hook = self.on_tenant_device
        if hook is not None:
            try:
                hook(tenant, lane, seconds)
            except Exception:  # noqa: BLE001 — never fails the fetch
                with self._lock:
                    self.counters["telemetry_errors"] += 1

    def latency_percentile(self, stage: str, q: float):
        """A stage's percentile under the lock; None without samples."""
        with self._lock:
            res = self.latency.get(stage)
            return None if res is None else res.percentile(q)

    def record_watchdog(self, seconds: float):
        """One warm group's loop seconds into the watchdog's
        reservoir."""
        with self._lock:
            self.watchdog_latency.add(seconds)

    def watchdog_p99(self):
        """The p99 of the warm groups' loop seconds; None without
        samples."""
        with self._lock:
            return self.watchdog_latency.percentile(99.0)

    def lane_percentile(self, lane: str, q: float):
        """A lane's percentile under the lock; None without samples."""
        with self._lock:
            res = self.lane_latency.get(lane)
            return None if res is None else res.percentile(q)

    def reset_latency(self):
        """Drop the latency samples and the busy-time accumulators (a
        steady-state window without the warm-up tickets)."""
        with self._lock:
            for res in self.latency.values():
                res.clear()
            for res in self.lane_latency.values():
                res.clear()
            self.watchdog_latency.clear()
            self.times.clear()

    def tenant_device_snapshot(self) -> dict:
        """``{tenant: {lane: device_seconds}}``."""
        with self._lock:
            return _pivot(self.tenant_device.items())

    # -- export --------------------------------------------------------

    def snapshot(self) -> dict:
        """Point-in-time copy of every counter plus derived rates."""
        with self._lock:
            out = dict(self.counters)
            out["buckets"] = {
                str(k): dataclasses.asdict(v)
                for k, v in self.buckets.items()
            }
            out.update(self.times)
            out["latency"] = {name: res.summary()
                              for name, res in self.latency.items()}
            out["lanes"] = {name: res.summary()
                            for name, res in self.lane_latency.items()}
            out["tenant_device_s"] = _pivot(self.tenant_device.items())
        out["profile"] = self.profile.snapshot()
        tot = out["latency"]["total"]
        out["ticket_p50_s"] = tot["p50_s"]
        out["ticket_p99_s"] = tot["p99_s"]
        hits = out.get("bucket_hits", 0)
        total = hits + out.get("compiles", 0)
        out["bucket_hit_rate"] = hits / total if total else 0.0
        padded = out.get("padded_elems", 0)
        if padded:
            out["pad_waste_frac"] = 1.0 - out.get("real_elems", 0) / padded
        return out


def _pivot(items) -> dict:
    """(tenant, lane) -> seconds pairs as ``{tenant: {lane: seconds}}``."""
    out: dict = {}
    for (tenant, lane), s in items:
        out.setdefault(tenant, {})[lane] = s
    return out
