"""Unified telemetry (the JAX package's ``telemetry/``): metrics
exposition, request tracing and the solve flight recorder (reference
analogues: amgx_timer / nvtx ranges, print_solve_stats,
convergence_analysis, generalized to a serving process).

Three cooperating pieces, all bounded, all fail-degradable:

* :mod:`amgx_tpu_torch.telemetry.registry` — the process-wide
  :class:`TelemetryRegistry` every service, session manager, store and
  the solver-timing aggregate register into, with ``snapshot()``
  (structured), ``render_prometheus()`` (text exposition) and
  ``dump()`` (JSON; ``AMGX_TPU_TELEMETRY_DUMP=<path>`` dumps at exit);
* :mod:`amgx_tpu_torch.telemetry.tracing` — per-request trace contexts
  threaded submit -> pad -> queue -> dispatch -> device -> fetch,
  recorded into a bounded span ring and exportable as Chrome
  trace-event JSON (``AMGX_TPU_TRACE_SAMPLE`` sampling, off by default
  with a no-op hot path);
* :mod:`amgx_tpu_torch.telemetry.recorder` — the
  :class:`FlightRecorder`: a ring of per-solve records plus an incident
  log capturing what was in flight when a quarantine, breaker trip or
  deadline expiry fired.

Env knobs (the JAX package's): ``AMGX_TPU_TELEMETRY=0`` (master off),
``AMGX_TPU_TRACE_SAMPLE`` (0..1), ``AMGX_TPU_TRACE_BUFFER``,
``AMGX_TPU_FLIGHT_RECORDS``, ``AMGX_TPU_INCIDENT_LOG``,
``AMGX_TPU_TELEMETRY_DUMP``.

Differences from the JAX package (ROADMAP.md, queue C): the solve is
synchronous, so a group's ``device`` span runs from its dispatch to the
synchronisation at its fetch; ``amgx_solver_compile_seconds_total``
reads the seconds building the solve function (nothing is compiled).
"""

from amgx_tpu_torch.telemetry import tracing  # noqa: F401
from amgx_tpu_torch.telemetry.recorder import FlightRecorder, SolveRecord
from amgx_tpu_torch.telemetry.registry import (
    TelemetryRegistry,
    get_registry,
    set_telemetry_enabled,
    telemetry_enabled,
)

__all__ = [
    "TelemetryRegistry",
    "get_registry",
    "telemetry_enabled",
    "set_telemetry_enabled",
    "FlightRecorder",
    "SolveRecord",
    "tracing",
]
