"""Process-wide telemetry registry (the JAX package's
``telemetry/registry.py``): every observable component — serve
services, session managers, artifact stores, the solver-timing
aggregate, the trace buffer — registers a snapshot source here, and
one object answers "what is this process doing" in three shapes:

* :meth:`TelemetryRegistry.snapshot` — structured dict, per
  component;
* :meth:`TelemetryRegistry.render_prometheus` — text exposition
  (a ``/metrics`` payload);
* :meth:`TelemetryRegistry.dump` — JSON to a path
  (``AMGX_TPU_TELEMETRY_DUMP=<path>`` dumps at interpreter exit; an
  operator can also call ``dump()`` on demand — the SIGUSR1 hook of a
  wire server).

Registration is weak: the registry holds ``weakref``s to sources, so
registering never extends a service's lifetime and dead components
silently drop out of the next snapshot (test suites create hundreds
of short-lived services).  Collection is *defensive*: one broken
source — including the ``telemetry_export`` injected fault — is
counted into ``telemetry_errors`` and skipped; telemetry can degrade
but can never fail a solve or take down the exposition page.

``telemetry_enabled()`` (``AMGX_TPU_TELEMETRY=0`` kills it) gates the
per-solve hot-path hooks (flight records, incident capture); the
registry itself always works when called explicitly.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
from typing import Callable, Optional

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.telemetry import promtext, tracing

_enabled_override: Optional[bool] = None


def set_telemetry_enabled(on: Optional[bool]) -> None:
    """Override the ``AMGX_TPU_TELEMETRY`` master switch (tests and
    the CI overhead A/B); ``None`` restores the environment value."""
    global _enabled_override
    _enabled_override = on if on is None else bool(on)


def telemetry_enabled() -> bool:
    """Master switch for the hot-path telemetry hooks (flight
    records, incident capture, solver-timing re-emission).  Read per
    call so tests/benches can toggle mid-process."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("AMGX_TPU_TELEMETRY", "1") != "0"


class TelemetryRegistry:
    """Weak component registry + the three export faces."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict = {}  # name -> (kind, weak/strong getter)
        self._seq = itertools.count()
        self.telemetry_errors = 0
        # built-in sources: the trace buffer and the solver-timing
        # aggregate are process-wide, not per-object
        self._solver_lock = threading.Lock()
        self._solver_stats: dict = {}
        self.register("tracing", tracing.telemetry_snapshot,
                      name="tracing")
        self.register("solvers", self._solver_snapshot, name="solvers")

    # -- registration --------------------------------------------------

    def register(self, kind: str, source, name: Optional[str] = None
                 ) -> str:
        """Register a snapshot source and return its component name.

        ``source`` is an object exposing ``telemetry_snapshot()`` (held
        by ``weakref.ref``), a bound method (``weakref.WeakMethod``),
        or a plain callable returning a dict (held strongly).  A
        repeated name replaces the previous source."""
        if name is None:
            name = f"{kind}{next(self._seq)}"
        if hasattr(source, "telemetry_snapshot"):
            ref = weakref.ref(source)

            def getter(_ref=ref):
                obj = _ref()
                return None if obj is None else obj.telemetry_snapshot()

        elif hasattr(source, "__self__"):
            wm = weakref.WeakMethod(source)

            def getter(_wm=wm):
                fn = _wm()
                return None if fn is None else fn()

        elif callable(source):
            getter = source
        else:
            raise TypeError(
                "telemetry source must expose telemetry_snapshot() "
                "or be callable"
            )
        with self._lock:
            self._sources[name] = (kind, getter)
        return name

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def components(self) -> list:
        with self._lock:
            return list(self._sources)

    # -- solver-timing aggregate (obtain_timings re-emission) ----------

    def record_solver(self, solver: str, setup_s: float = 0.0,
                      compile_s: float = 0.0, solve_s: float = 0.0,
                      iterations: int = 0, reductions: int = 0,
                      cycle_passes: int = 0,
                      setup_phases: Optional[dict] = None) -> None:
        """Fold one timed solve's ``obtain_timings`` lines into the
        per-solver-class aggregate (the registry's ``solvers``
        component).  ``reductions`` counts the solve's global
        dot/norm reductions (``amgx_solver_reductions_total``);
        ``cycle_passes`` counts fine-grid operator passes
        (``amgx_solver_cycle_passes_total``: the fused matrix-free
        cycle legs, ops/stencil.py; 0 for solvers without a cycle);
        ``iterations`` additionally feeds a per-solver iteration
        histogram (``promtext.ITERATION_BUCKETS``).  ``compile_s`` is
        the seconds building the solve function (this package
        compiles nothing)."""
        with self._solver_lock:
            st = self._solver_stats.setdefault(solver, {
                "solves": 0, "iterations": 0, "reductions": 0,
                "cycle_passes": 0,
                "setup_s": 0.0, "compile_s": 0.0, "solve_s": 0.0,
                "setup_phases": {}, "iter_hist": {},
            })
            st["solves"] += 1
            st["iterations"] += int(iterations)
            st["reductions"] += int(reductions)
            st["cycle_passes"] += int(cycle_passes)
            hist = st["iter_hist"]
            for le in promtext.ITERATION_BUCKETS:
                if iterations <= le:
                    hist[le] = hist.get(le, 0) + 1
                    break
            else:
                hist["+Inf"] = hist.get("+Inf", 0) + 1
            st["setup_s"] += float(setup_s)
            st["compile_s"] += float(compile_s)
            st["solve_s"] += float(solve_s)
            if setup_phases:
                ph = st["setup_phases"]
                for k, v in setup_phases.items():
                    if isinstance(v, float):
                        ph[k] = ph.get(k, 0.0) + v

    def _solver_snapshot(self) -> dict:
        with self._solver_lock:
            return {
                name: {**st,
                       "setup_phases": dict(st["setup_phases"]),
                       "iter_hist": dict(st["iter_hist"])}
                for name, st in self._solver_stats.items()
            }

    # -- collection ----------------------------------------------------

    def _collect_one(self, getter: Callable):
        if faults.should_fire("telemetry_export"):
            raise RuntimeError(
                "injected telemetry export failure (fault site "
                "telemetry_export)"
            )
        return getter()

    def snapshot(self) -> dict:
        """``{component: {"kind": ..., "data": {...}}}`` across every
        live source.  Dead weakrefs are dropped; a source that raises
        is counted (``telemetry_errors``) and skipped — a snapshot
        never raises."""
        with self._lock:
            items = list(self._sources.items())
        out = {}
        dead = []
        errors = 0
        for name, (kind, getter) in items:
            try:
                data = self._collect_one(getter)
            except Exception:  # noqa: BLE001 — degrade, never fail
                errors += 1
                continue
            if data is None:
                dead.append(name)
                continue
            out[name] = {"kind": kind, "data": data}
        if dead:
            with self._lock:
                for name in dead:
                    self._sources.pop(name, None)
        if errors:
            with self._lock:
                self.telemetry_errors += errors
        return out

    # -- export faces --------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition of everything registered.
        Collection and rendering errors degrade to the
        ``amgx_telemetry_errors_total`` counter on the page itself."""
        snap = self.snapshot()
        with self._lock:
            errors = self.telemetry_errors
        return promtext.render(snap, telemetry_errors=errors)

    def dump(self, path: Optional[str] = None) -> bool:
        """Write the JSON telemetry dump to ``path`` (default:
        ``AMGX_TPU_TELEMETRY_DUMP``).  Returns False — counted, never
        raising — on any failure; True on success."""
        try:
            if path is None:
                path = os.environ.get("AMGX_TPU_TELEMETRY_DUMP")
            if not path:
                return False
            if faults.should_fire("telemetry_export"):
                raise RuntimeError(
                    "injected telemetry dump failure (fault site "
                    "telemetry_export)"
                )
            payload = {
                "ts": time.time(),
                "pid": os.getpid(),
                "snapshot": self.snapshot(),
                "trace_spans": len(tracing.span_buffer()),
            }
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
            return True
        except Exception:  # noqa: BLE001 — export must never propagate
            with self._lock:
                self.telemetry_errors += 1
            return False


# ----------------------------------------------------------------------
# process-wide default flight recorder (direct-API solves; serve
# services own their own recorder)

_DEFAULT_RECORDER = None


def default_recorder():
    """Flight recorder for solves outside any serve service (the
    direct ``Solver.solve`` path); registered into the process
    registry on first use."""
    global _DEFAULT_RECORDER
    with _REGISTRY_LOCK:
        created = _DEFAULT_RECORDER is None
        if created:
            from amgx_tpu_torch.telemetry.recorder import FlightRecorder

            _DEFAULT_RECORDER = FlightRecorder()
    if created:
        get_registry().register(
            "recorder", _DEFAULT_RECORDER.summary, name="flight"
        )
    return _DEFAULT_RECORDER


# ----------------------------------------------------------------------
# process-wide default registry

_REGISTRY: Optional[TelemetryRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> TelemetryRegistry:
    """The process-wide registry (created on first use; installs the
    ``AMGX_TPU_TELEMETRY_DUMP`` exit hook once)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = TelemetryRegistry()
            import atexit

            def _exit_dump():
                if os.environ.get("AMGX_TPU_TELEMETRY_DUMP"):
                    _REGISTRY.dump()

            atexit.register(_exit_dump)
        return _REGISTRY
