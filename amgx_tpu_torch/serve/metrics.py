"""Serve-layer metrics: the counters, gauges, per-bucket occupancy and
phase profile of one batched solve service (the JAX package's
``serve/metrics.py`` without its telemetry: no latency reservoirs, lanes
or tenant accounting, which come with the rest of the serving tier,
ROADMAP.md queue A).

Counter names are the JAX package's: ``submitted``, ``batches``,
``solved``, ``setups``, ``cache_hits`` / ``cache_misses`` /
``cache_evictions``, ``compiles`` / ``bucket_hits`` (the built batched
solves, ``serve/cache.py``), ``fallback_solves``, ``host_syncs``, the
guardrails (``validation_rejects``, ``quarantines``,
``quarantined_solves``, ``poisoned_requests``,
``quarantine_entry_reuses``, ``breaker_trips`` / ``breaker_bypasses`` /
``breaker_closes`` and the ``breakers_open`` gauge, ``failed_groups``,
``deadline_expired`` / ``deadline_expired_fetch``), ``staging_reuses``,
``prewarms``, ``entry_resetups``, and the ``queue_depth`` gauge.  The
phase profile holds ``pad``, ``setup`` (and the solver's ``setup:<phase>``
seconds), ``dispatch``, ``fallback`` and ``quarantine``.  ``host_syncs``
counts the port's real device-to-host reads of a batched group: the
residual norms once an iteration and the fetch (the JAX package reads
once a group; ROADMAP.md, queue C).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict


@dataclasses.dataclass
class BucketStat:
    """Time and occupancy of one (n, nnz, batch) bucket."""

    calls: int = 0
    total_s: float = 0.0
    instances: int = 0  # real (non-padding) instances executed
    pad_instances: int = 0  # batch-padding dummies executed


class PhaseProfile:
    """Locked accumulate of seconds and calls per named phase (the JAX
    package's ``LevelProfile``)."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float, count: int = 1):
        with self._lock:
            self.times[name] += float(seconds)
            self.counts[name] += count

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"times": dict(self.times), "counts": dict(self.counts)}


class ServeMetrics:
    """Thread-safe counters of one BatchedSolveService: every mutation
    and every read that iterates goes through the lock (the phase
    profile has its own); readers use :meth:`snapshot` or
    :meth:`get`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = defaultdict(int)
        self.buckets: dict = defaultdict(BucketStat)
        self.profile = PhaseProfile()
        # float accumulators (device_busy_s, host_busy_s)
        self.times = defaultdict(float)

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

    def snapshot(self) -> dict:
        """Point-in-time copy of every counter plus derived rates."""
        with self._lock:
            out = dict(self.counters)
            out["buckets"] = {
                str(k): dataclasses.asdict(v)
                for k, v in self.buckets.items()
            }
            out.update(self.times)
        out["profile"] = self.profile.snapshot()
        hits = out.get("bucket_hits", 0)
        total = hits + out.get("compiles", 0)
        out["bucket_hit_rate"] = hits / total if total else 0.0
        padded = out.get("padded_elems", 0)
        if padded:
            out["pad_waste_frac"] = 1.0 - out.get("real_elems", 0) / padded
        return out
