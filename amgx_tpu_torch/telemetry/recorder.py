"""Solve flight recorder: a bounded ring of per-solve records plus a
last-N incident log (the JAX package's ``telemetry/recorder.py``).

The reference's ``print_solve_stats``/``convergence_analysis`` answer
"how did THIS solve go" for one interactively-watched solve; a serving
fleet needs the same answer *retroactively* — what was the recent
solve population doing, and what exactly was in flight when something
tripped.  Two bounded rings:

* **records** — one :class:`SolveRecord` per completed solve
  (fingerprint, config hash, lane, tenant, iterations, final
  residual, status, per-stage timings, trace id), capacity
  ``AMGX_TPU_FLIGHT_RECORDS`` (default 256);
* **incidents** — whenever a quarantine, breaker trip or deadline
  expiry fires (a typed shed too, once the gateway is ported), the
  triggering detail plus a metrics snapshot is appended (capacity
  ``AMGX_TPU_INCIDENT_LOG``, default 64).  Snapshot capture is
  throttled (one per ``snapshot_min_interval_s``) so an overload's
  incident storm cannot turn the observer into load; throttled
  incidents still log, just without the snapshot.

Failure stance: the ``telemetry_export`` fault site fires inside
:meth:`record`/:meth:`incident`, and every serve call site swallows
the raise into a counted ``telemetry_errors`` — telemetry must never
fail a solve (``tests/test_torch_telemetry.py``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Optional

from amgx_tpu_torch.core import faults


def _env_cap(name: str, default: int) -> int:
    try:
        return max(int(os.environ.get(name, "") or default), 1)
    except ValueError:
        return default


@dataclasses.dataclass(slots=True)
class SolveRecord:
    """One completed solve, as the flight recorder remembers it."""

    ts: float  # wall-clock unix time at record
    fingerprint: str
    config: str  # AMGConfig content hash
    lane: str
    tenant: str
    iterations: int
    final_residual: float
    status: int
    stages: dict  # stage name -> seconds
    path: str = "batched"  # batched | quarantine | fallback | direct
    trace_id: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FlightRecorder:
    """Bounded solve-record ring + incident log (thread-safe)."""

    def __init__(
        self,
        cap: Optional[int] = None,
        incident_cap: Optional[int] = None,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        snapshot_min_interval_s: float = 0.25,
    ):
        self.cap = (
            int(cap) if cap is not None
            else _env_cap("AMGX_TPU_FLIGHT_RECORDS", 256)
        )
        self.incident_cap = (
            int(incident_cap) if incident_cap is not None
            else _env_cap("AMGX_TPU_INCIDENT_LOG", 64)
        )
        self.snapshot_fn = snapshot_fn
        self.snapshot_min_interval_s = float(snapshot_min_interval_s)
        self._lock = threading.Lock()
        self._records: list = []
        self._next = 0
        self._incidents: list = []
        self._inext = 0
        self._last_snap = 0.0
        self.records_total = 0
        self.incidents_total = 0
        self.incidents_by_kind: dict = {}

    # -- records -------------------------------------------------------

    def record(self, **fields) -> SolveRecord:
        """Append one solve record.  Raises when the
        ``telemetry_export`` fault site is armed — call sites MUST
        swallow into a counted degrade (the fault contract)."""
        if faults.should_fire("telemetry_export"):
            raise RuntimeError(
                "injected flight-record failure (fault site "
                "telemetry_export)"
            )
        rec = SolveRecord(ts=time.time(), **fields)
        with self._lock:
            if len(self._records) < self.cap:
                self._records.append(rec)
            else:
                self._records[self._next] = rec
                self._next = (self._next + 1) % self.cap
            self.records_total += 1
        return rec

    def extend(self, recs: list) -> None:
        """Append pre-built :class:`SolveRecord`\\ s in ONE fault check
        and ONE lock acquisition — the serve fetch loop records a whole
        batch group this way, so the per-ticket hot-path cost is just
        the record construction."""
        if faults.should_fire("telemetry_export"):
            raise RuntimeError(
                "injected flight-record failure (fault site "
                "telemetry_export)"
            )
        with self._lock:
            for rec in recs:
                if len(self._records) < self.cap:
                    self._records.append(rec)
                else:
                    self._records[self._next] = rec
                    self._next = (self._next + 1) % self.cap
            self.records_total += len(recs)

    def records(self) -> list:
        """Chronological copy of the record ring."""
        with self._lock:
            return self._records[self._next:] + self._records[: self._next]

    # -- incidents -----------------------------------------------------

    def incident(self, kind: str, detail: str = "",
                 record: Optional[SolveRecord] = None) -> dict:
        """Append one incident: the trigger (kind/detail/record) plus
        a throttled metrics snapshot.  Raises under the
        ``telemetry_export`` fault site (call sites swallow)."""
        if faults.should_fire("telemetry_export"):
            raise RuntimeError(
                "injected incident-capture failure (fault site "
                "telemetry_export)"
            )
        snap = None
        now = time.monotonic()
        take_snap = False
        with self._lock:
            if (
                self.snapshot_fn is not None
                and now - self._last_snap >= self.snapshot_min_interval_s
            ):
                self._last_snap = now
                take_snap = True
        if take_snap:
            try:
                snap = self.snapshot_fn()
            except Exception:  # noqa: BLE001 — the snapshot is garnish;
                # the incident itself must still land
                snap = None
        inc = {
            "ts": time.time(),
            "kind": kind,
            "detail": detail,
            "record": record.to_dict() if record is not None else None,
            "snapshot": snap,
        }
        with self._lock:
            if len(self._incidents) < self.incident_cap:
                self._incidents.append(inc)
            else:
                self._incidents[self._inext] = inc
                self._inext = (self._inext + 1) % self.incident_cap
            self.incidents_total += 1
            self.incidents_by_kind[kind] = (
                self.incidents_by_kind.get(kind, 0) + 1
            )
        return inc

    def incidents(self) -> list:
        """Chronological copy of the incident ring."""
        with self._lock:
            return (
                self._incidents[self._inext:]
                + self._incidents[: self._inext]
            )

    # -- export --------------------------------------------------------

    def summary(self) -> dict:
        """Bounded counts view (the Prometheus export)."""
        with self._lock:
            return {
                "records_total": self.records_total,
                "record_ring_size": len(self._records),
                "incidents_total": self.incidents_total,
                "incident_log_size": len(self._incidents),
                "incidents_by_kind": dict(self.incidents_by_kind),
            }

    def to_dict(self) -> dict:
        """Full dump (the C API's telemetry JSON)."""
        return {
            "summary": self.summary(),
            "records": [r.to_dict() for r in self.records()],
            "incidents": self.incidents(),
        }
