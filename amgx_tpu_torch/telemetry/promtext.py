"""Prometheus text-exposition rendering for registry snapshots (the JAX
package's ``telemetry/promtext.py``).

One module owns the mapping from the package's internal snapshot
shapes (serve :class:`~amgx_tpu_torch.serve.metrics.ServeMetrics`
dicts, the gateway's admission and tenant view,
:class:`~amgx_tpu_torch.store.store.ArtifactStore` counters, the
aggregated solver timings, the session manager, the flight recorder,
the trace buffer) to the Prometheus text-exposition format, so
components never need to know metric grammar.  Family names and labels
are those of the JAX package's catalog (doc/OBSERVABILITY.md): the
``amgx_gateway_*``, ``amgx_admission_*`` and ``amgx_resilience_*``
families among them, and the fleet frontend's ``amgx_fleet_*``
(:func:`fleet_families`).  The mesh and distributed families wait for
their sources (ROADMAP.md, queue A.9); a component of another kind
renders through the generic numeric walk.

The model is a *family* table: ``name -> {"type", "help", "samples"}``
where samples are ``(labels_dict, value)`` pairs.  ``render()`` emits
``# HELP`` / ``# TYPE`` headers once per family and one sample line
per (labels, value), with label values escaped per the exposition
grammar.  Families merge across components: every registered serve
service contributes samples to the same ``amgx_serve_*`` families,
distinguished by the ``component`` label.
"""

from __future__ import annotations

import re

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")

# per-config iteration histogram bucket upper bounds (inner-step
# equivalents; the registry's record_solver sorts each timed solve
# into the first bucket that covers it, "+Inf" past the last)
ITERATION_BUCKETS = (1, 2, 5, 10, 20, 50, 100, 200, 500)


def sanitize_name(name: str) -> str:
    """Coerce an internal counter key into a legal metric name."""
    name = _NAME_SANITIZE.sub("_", str(name))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def escape_label_value(v) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    return repr(f)


class FamilyTable:
    """Accumulator for metric families; insertion-ordered."""

    def __init__(self):
        self._fams: dict = {}

    def add(self, name: str, mtype: str, help_text: str,
            labels: dict, value) -> None:
        if value is None:
            return
        name = sanitize_name(name)
        fam = self._fams.get(name)
        if fam is None:
            fam = self._fams[name] = {
                "type": mtype,
                "help": help_text,
                "samples": [],
            }
        fam["samples"].append((dict(labels), value))

    def names(self):
        return list(self._fams)

    def render(self) -> str:
        lines = []
        for name, fam in self._fams.items():
            lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for labels, value in fam["samples"]:
                if labels:
                    lab = ",".join(
                        f'{sanitize_name(k)}="{escape_label_value(v)}"'
                        for k, v in sorted(labels.items())
                    )
                    lines.append(f"{name}{{{lab}}} {_fmt_value(value)}")
                else:
                    lines.append(f"{name} {_fmt_value(value)}")
        return "\n".join(lines) + "\n" if lines else ""


# ----------------------------------------------------------------------
# serve metrics (ServeMetrics.snapshot() shape)

# counters that are point-in-time levels, not monotone totals
_SERVE_GAUGES = {
    "queue_depth",
    "breakers_open",
    "gateway_draining",
}

# resilience_* keys that are levels, not totals
_RESILIENCE_GAUGES = {
    "resilience_devices_unhealthy",
}

# hierarchy/compile-cache counters get their own amgx_cache_* namespace
# (the catalog's "cache source"), the rest of the int counters land in
# amgx_serve_*
_CACHE_RENAME = {
    "cache_hits": "amgx_cache_hierarchy_hits_total",
    "cache_misses": "amgx_cache_hierarchy_misses_total",
    "cache_evictions": "amgx_cache_hierarchy_evictions_total",
    "setups": "amgx_cache_hierarchy_setups_total",
    "bucket_hits": "amgx_cache_compile_hits_total",
    "compiles": "amgx_cache_compiles_total",
    "compile_warmups": "amgx_cache_compile_warmups_total",
    "compile_evictions": "amgx_cache_compile_evictions_total",
    "aot_fallbacks": "amgx_cache_aot_fallbacks_total",
    "prewarms": "amgx_cache_prewarms_total",
    "prewarm_failures": "amgx_cache_prewarm_failures_total",
}

# snapshot keys that are derived/structured, rendered specially or not
# rendered as plain counters
_SERVE_SKIP = {
    "buckets", "latency", "lanes", "profile",
    "ticket_p50_s", "ticket_p99_s", "tenant_device_s",
    "hierarchy_bytes", "hierarchy_format_bytes",
}


def _quantile_samples(fams, name, help_text, comp, extra, summ):
    base = {"component": comp}
    base.update(extra)
    for q, key in (("0.5", "p50_s"), ("0.99", "p99_s")):
        fams.add(name, "gauge", help_text,
                 {**base, "quantile": q}, summ.get(key, 0.0))
    fams.add(name + "_count", "counter",
             help_text + " (lifetime sample count)", base,
             summ.get("count", 0))
    fams.add(name + "_max", "gauge",
             help_text + " (window max)", base, summ.get("max_s", 0.0))


def serve_families(fams: FamilyTable, comp: str, snap: dict) -> None:
    """ServeMetrics.snapshot() -> amgx_serve_* / amgx_gateway_* /
    amgx_resilience_* / amgx_cache_* / amgx_setup_phase_* families."""
    labels = {"component": comp}
    for k, v in snap.items():
        if k in _SERVE_SKIP or not isinstance(v, (int, float)):
            continue
        if isinstance(v, int) and not isinstance(v, bool):
            if k in _CACHE_RENAME:
                fams.add(_CACHE_RENAME[k], "counter",
                         f"serve cache counter {k}", labels, v)
            elif k in _SERVE_GAUGES:
                fams.add(f"amgx_serve_{k}", "gauge",
                         f"serve gauge {k}", labels, v)
            elif k.startswith("resilience_"):
                # failure-domain counters (failover, watchdog fires,
                # session checkpoints and restores) get their own
                # amgx_resilience_* namespace
                if k in _RESILIENCE_GAUGES:
                    fams.add(f"amgx_{k}", "gauge",
                             f"resilience gauge {k}", labels, v)
                else:
                    fams.add(f"amgx_{k}_total", "counter",
                             f"resilience counter {k}", labels, v)
            elif k.startswith("shed_"):
                fams.add("amgx_gateway_sheds_by_reason_total", "counter",
                         "typed gateway sheds by reason",
                         {**labels, "reason": k[len("shed_"):]}, v)
            elif k.startswith("gateway_"):
                fams.add(f"amgx_{k}_total", "counter",
                         f"gateway counter {k}", labels, v)
            elif k.startswith("tenant_"):
                continue  # structured separately by the gateway source
            else:
                fams.add(f"amgx_serve_{k}_total", "counter",
                         f"serve counter {k}", labels, v)
        else:
            # float accumulators / derived rates
            if k.endswith("_s"):
                fams.add(f"amgx_serve_{k[:-2]}_seconds_total", "counter",
                         f"serve seconds accumulator {k}", labels, v)
            else:
                fams.add(f"amgx_serve_{k}", "gauge",
                         f"serve derived gauge {k}", labels, v)
    for dt, nb in (snap.get("hierarchy_bytes") or {}).items():
        fams.add("amgx_cache_hierarchy_bytes", "gauge",
                 "resident hierarchy-cache bytes by array dtype "
                 "(mixed-precision policy observability: a "
                 "hierarchy_dtype=FLOAT32 hierarchy moves value "
                 "bytes from the float64 to the float32 family)",
                 {**labels, "dtype": dt}, nb)
    for fmt, nb in (snap.get("hierarchy_format_bytes") or {}).items():
        fams.add("amgx_cache_hierarchy_bytes", "gauge",
                 "resident hierarchy-cache bytes by accel format "
                 "(MATRIX_FREE levels hold O(1) coefficient state "
                 "where DIA holds O(nnz) value planes — this split "
                 "shows the compression landing)",
                 {**labels, "format": fmt}, nb)
    for stage, summ in (snap.get("latency") or {}).items():
        _quantile_samples(
            fams, "amgx_serve_ticket_latency_seconds",
            "per-ticket pipeline stage latency", comp,
            {"stage": stage}, summ,
        )
    for lane, summ in (snap.get("lanes") or {}).items():
        _quantile_samples(
            fams, "amgx_serve_lane_latency_seconds",
            "per-priority-lane end-to-end latency", comp,
            {"lane": lane}, summ,
        )
    for bk, st in (snap.get("buckets") or {}).items():
        bl = {**labels, "bucket": bk}
        fams.add("amgx_serve_bucket_calls_total", "counter",
                 "batched executions per (n, nnz, batch) bucket", bl,
                 st.get("calls", 0))
        fams.add("amgx_serve_bucket_seconds_total", "counter",
                 "device seconds per bucket", bl, st.get("total_s", 0.0))
        fams.add("amgx_serve_bucket_instances_total", "counter",
                 "real instances executed per bucket", bl,
                 st.get("instances", 0))
        fams.add("amgx_serve_bucket_pad_instances_total", "counter",
                 "padding instances executed per bucket", bl,
                 st.get("pad_instances", 0))
    prof = snap.get("profile") or {}
    for phase, secs in (prof.get("times") or {}).items():
        if phase.startswith("setup:"):
            fams.add("amgx_setup_phase_seconds_total", "counter",
                     "hierarchy-setup phase seconds "
                     "(cold-setup anatomy)",
                     {**labels, "phase": phase[len("setup:"):]}, secs)
        else:
            fams.add("amgx_serve_phase_seconds_total", "counter",
                     "serve pipeline phase seconds",
                     {**labels, "phase": phase}, secs)
    for phase, calls in (prof.get("counts") or {}).items():
        if phase.startswith("setup:"):
            continue
        fams.add("amgx_serve_phase_calls_total", "counter",
                 "serve pipeline phase call counts",
                 {**labels, "phase": phase}, calls)


def store_families(fams: FamilyTable, comp: str, snap: dict) -> None:
    """ArtifactStore stats -> amgx_store_* families."""
    labels = {"component": comp}
    for k, v in (snap.get("counters") or {}).items():
        fams.add(f"amgx_store_{k}_total", "counter",
                 f"artifact-store counter {k}", labels, v)
    if "entries" in snap:
        fams.add("amgx_store_entries", "gauge",
                 "entries currently on disk", labels, snap["entries"])
    if "max_bytes" in snap:
        fams.add("amgx_store_budget_bytes", "gauge",
                 "configured store size budget", labels,
                 snap["max_bytes"])


def solver_families(fams: FamilyTable, comp: str, snap: dict) -> None:
    """Aggregated solver timings (obtain_timings re-emission) ->
    amgx_solver_* families, labeled by solver registry name."""
    for solver, st in snap.items():
        labels = {"component": comp, "solver": solver}
        fams.add("amgx_solver_solves_total", "counter",
                 "timed solves observed", labels, st.get("solves", 0))
        fams.add("amgx_solver_iterations_total", "counter",
                 "iterations across timed solves (inner-step "
                 "equivalents: one s-step outer = s CG steps)", labels,
                 st.get("iterations", 0))
        fams.add("amgx_solver_reductions_total", "counter",
                 "global dot/norm reductions across timed solves (the "
                 "cross-chip psum sync points; ~3/iter for monitored "
                 "PCG, ~2/s per iter for SSTEP_PCG)", labels,
                 st.get("reductions", 0))
        fams.add("amgx_solver_cycle_passes_total", "counter",
                 "fine-grid operator passes across timed solves "
                 "(trace-time op_pass counter; fused matrix-free "
                 "cycle legs drop this from 3(L-1)+1 to 2(L-1)+1 "
                 "per V-cycle)", labels,
                 st.get("cycle_passes", 0))
        hist = st.get("iter_hist") or {}
        if hist:
            # histogram-shaped per-config iteration distribution:
            # cumulative le-labelled buckets + _sum/_count
            cum = 0
            for le in ITERATION_BUCKETS:
                cum += hist.get(le, 0)
                fams.add("amgx_solver_iterations_bucket", "counter",
                         "timed solves by iteration count "
                         "(cumulative buckets)",
                         {**labels, "le": str(le)}, cum)
            fams.add("amgx_solver_iterations_bucket", "counter",
                     "timed solves by iteration count "
                     "(cumulative buckets)",
                     {**labels, "le": "+Inf"}, st.get("solves", 0))
            fams.add("amgx_solver_iterations_sum", "counter",
                     "iteration histogram sum", labels,
                     st.get("iterations", 0))
            fams.add("amgx_solver_iterations_count", "counter",
                     "iteration histogram count", labels,
                     st.get("solves", 0))
        fams.add("amgx_solver_setup_seconds_total", "counter",
                 "setup seconds across timed solves", labels,
                 st.get("setup_s", 0.0))
        fams.add("amgx_solver_compile_seconds_total", "counter",
                 "compile seconds across timed solves (this package: "
                 "the seconds building the solve function)", labels,
                 st.get("compile_s", 0.0))
        fams.add("amgx_solver_solve_seconds_total", "counter",
                 "solve seconds across timed solves", labels,
                 st.get("solve_s", 0.0))
        for phase, secs in (st.get("setup_phases") or {}).items():
            fams.add("amgx_setup_phase_seconds_total", "counter",
                     "hierarchy-setup phase seconds "
                     "(cold-setup anatomy)",
                     {"component": comp, "solver": solver,
                      "phase": phase}, secs)


def recorder_families(fams: FamilyTable, comp: str, snap: dict) -> None:
    """The direct-API default FlightRecorder's summary ->
    the same amgx_flight_* / amgx_incidents_* families the gateway
    source renders a service's recorder into."""
    labels = {"component": comp}
    fams.add("amgx_flight_records_total", "counter",
             "per-solve flight-recorder records", labels,
             snap.get("records_total"))
    fams.add("amgx_incident_log_size", "gauge",
             "incidents currently held in the ring", labels,
             snap.get("incident_log_size"))
    for kind, n in (snap.get("incidents_by_kind") or {}).items():
        fams.add("amgx_incidents_total", "counter",
                 "flight-recorder incidents by kind",
                 {**labels, "kind": kind}, n)


def session_families(fams: FamilyTable, comp: str, snap: dict) -> None:
    """SessionManager.telemetry_snapshot() -> amgx_session_* families
    (the streaming transient-PDE workload: step/warm-start counts,
    resetup-under-solve overlap seconds, persistence outcomes)."""
    labels = {"component": comp}
    for k, v in snap.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if k == "open":
            fams.add("amgx_session_open", "gauge",
                     "streaming sessions currently open", labels, v)
        elif isinstance(v, float):
            # float accumulators are seconds totals (resetup /
            # resetup-overlap)
            name = k if k.endswith("_seconds_total") \
                else f"{k}_seconds_total"
            fams.add(f"amgx_session_{name}", "counter",
                     f"session seconds accumulator {k}", labels, v)
        else:
            name = k if k.endswith("_total") else f"{k}_total"
            fams.add(f"amgx_session_{name}", "counter",
                     f"session counter {k}", labels, v)


def gateway_families(fams: FamilyTable, comp: str, snap: dict) -> None:
    """Gateway telemetry_snapshot() -> amgx_gateway_* families (the
    admission/tenant view; the shared counter set is exported by the
    serve component)."""
    labels = {"component": comp}
    fams.add("amgx_gateway_inflight", "gauge",
             "admitted-but-unsettled tickets", labels,
             snap.get("inflight", 0))
    fams.add("amgx_gateway_max_inflight", "gauge",
             "global concurrency budget", labels,
             snap.get("max_inflight", 0))
    fams.add("amgx_gateway_up", "gauge",
             "1 while the gateway state is 'serving'",
             {**labels, "state": snap.get("state", "?")},
             1 if snap.get("state") == "serving" else 0)
    for tenant, counts in (snap.get("tenants") or {}).items():
        tl = {**labels, "tenant": tenant}
        fams.add("amgx_gateway_tenant_admitted_total", "counter",
                 "admitted submits per tenant", tl,
                 counts.get("admitted", 0))
        fams.add("amgx_gateway_tenant_sheds_total", "counter",
                 "typed sheds per tenant", tl, counts.get("sheds", 0))
        fams.add("amgx_gateway_tenant_completed_total", "counter",
                 "settled-success tickets per tenant", tl,
                 counts.get("completed", 0))
        if "tokens" in counts:
            fams.add("amgx_admission_tenant_tokens", "gauge",
                     "remaining token-bucket quota per tenant", tl,
                     counts["tokens"])
    for tenant, lanes in (snap.get("tenant_device_s") or {}).items():
        for lane, secs in lanes.items():
            fams.add("amgx_gateway_tenant_device_seconds_total",
                     "counter",
                     "device-execution seconds attributed per "
                     "tenant/lane (each ticket's even share of its "
                     "group's device time — fleet cost accounting)",
                     {**labels, "tenant": tenant, "lane": lane}, secs)
    for tenant, tokens in (snap.get("tenant_device_tokens") or {}
                           ).items():
        fams.add("amgx_admission_tenant_device_seconds", "gauge",
                 "remaining device-seconds budget per tenant "
                 "(negative = debt being refilled; admits shed typed "
                 "reason=device_budget while negative)",
                 {**labels, "tenant": tenant}, tokens)
    rec = snap.get("recorder") or {}
    fams.add("amgx_flight_records_total", "counter",
             "per-solve flight-recorder records", labels,
             rec.get("records_total"))
    fams.add("amgx_incident_log_size", "gauge",
             "incidents currently held in the ring", labels,
             rec.get("incident_log_size"))
    for kind, n in (rec.get("incidents_by_kind") or {}).items():
        fams.add("amgx_incidents_total", "counter",
                 "flight-recorder incidents by kind",
                 {**labels, "kind": kind}, n)


def fleet_families(fams: FamilyTable, comp: str, snap: dict) -> None:
    """FleetFrontend.telemetry_snapshot() (multi-process fleet tier)
    -> amgx_fleet_* families: submission/settlement counters,
    cross-process affinity routing, per-worker breaker state, and the
    wire round-trip latency summary."""
    labels = {"component": comp}
    counters = snap.get("counters") or {}
    fams.add("amgx_fleet_submitted_total", "counter",
             "solves submitted to fleet workers", labels,
             counters.get("submitted"))
    fams.add("amgx_fleet_completed_total", "counter",
             "solves settled successfully over the wire", labels,
             counters.get("completed"))
    fams.add("amgx_fleet_typed_errors_total", "counter",
             "tickets settled with a typed taxonomy error", labels,
             counters.get("typed_errors"))
    fams.add("amgx_fleet_retries_total", "counter",
             "retryable typed errors re-submitted through routing",
             labels, counters.get("retries"))
    fams.add("amgx_fleet_requeued_total", "counter",
             "in-flight tickets requeued to a healthy worker after a "
             "connection loss", labels, counters.get("requeued"))
    fams.add("amgx_fleet_requeue_failures_total", "counter",
             "tickets settled typed after losing their requeue too",
             labels, counters.get("requeue_failures"))
    fams.add("amgx_fleet_conn_losses_total", "counter",
             "worker connections lost unexpectedly", labels,
             counters.get("conn_losses"))
    routing = snap.get("routing") or {}
    hits = routing.get("hits")
    misses = routing.get("misses")
    fams.add("amgx_fleet_affinity_hits_total", "counter",
             "submits routed to a worker already warm for their "
             "fingerprint", labels, hits)
    fams.add("amgx_fleet_affinity_misses_total", "counter",
             "submits routed cold (least-loaded fallback)", labels,
             misses)
    if hits is not None and misses is not None and (hits + misses):
        fams.add("amgx_fleet_affinity_hit_ratio", "gauge",
                 "warm-routing fraction of fleet submits", labels,
                 hits / (hits + misses))
    fams.add("amgx_fleet_workers", "gauge",
             "workers currently attached and routable", labels,
             len(routing.get("active") or ()))
    fams.add("amgx_fleet_dist_routed_total", "counter",
             "oversized patterns restricted to distributed-capable "
             "workers", labels, routing.get("dist_routed"))
    fams.add("amgx_fleet_route_fallbacks_total", "counter",
             "submits routed with every pool worker's breaker open",
             labels, routing.get("fallbacks"))
    health = routing.get("health") or {}
    fams.add("amgx_fleet_workers_unhealthy", "gauge",
             "workers with an open breaker", labels,
             health.get("unhealthy"))
    fams.add("amgx_fleet_worker_trips_total", "counter",
             "worker breaker trips (dead process = lost device one "
             "tier up)", labels, health.get("trips"))
    fams.add("amgx_fleet_worker_probes_total", "counter",
             "half-open probes routed to tripped workers", labels,
             health.get("probes"))
    fams.add("amgx_fleet_worker_closes_total", "counter",
             "worker breakers closed by a successful probe", labels,
             health.get("closes"))
    retry = snap.get("retry") or {}
    fams.add("amgx_fleet_retry_giveups_total", "counter",
             "retryable errors surfaced after exhausting attempts",
             labels, retry.get("giveups"))
    lat = snap.get("wire_latency") or {}
    for stat in ("mean_s", "p50_s", "p99_s"):
        fams.add(f"amgx_fleet_wire_latency_{stat}", "gauge",
                 f"wire round-trip latency {stat.replace('_s', '')} "
                 "(submit to settle)", labels, lat.get(stat))
    fams.add("amgx_fleet_wire_requests", "gauge",
             "wire round-trips in the latency reservoir", labels,
             lat.get("count"))


def tracing_families(fams: FamilyTable, comp: str, snap: dict) -> None:
    labels = {"component": comp}
    fams.add("amgx_trace_spans_total", "counter",
             "spans recorded since process start", labels,
             snap.get("spans_total", 0))
    fams.add("amgx_trace_buffer_spans", "gauge",
             "spans currently held in the ring", labels,
             snap.get("buffer_len", 0))
    fams.add("amgx_trace_sample_rate", "gauge",
             "effective trace sampling rate", labels,
             snap.get("sample_rate", 0.0))


def generic_families(fams: FamilyTable, kind: str, comp: str,
                     snap: dict) -> None:
    """Fallback: flat numeric walk for unknown component kinds."""
    labels = {"component": comp}
    for k, v in snap.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        fams.add(f"amgx_{kind}_{k}", "gauge",
                 f"{kind} value {k}", labels, v)


_RENDERERS = {
    "serve": serve_families,
    "gateway": gateway_families,
    "fleet": fleet_families,
    "store": store_families,
    "solvers": solver_families,
    "sessions": session_families,
    "tracing": tracing_families,
    "recorder": recorder_families,
}


def render(components: dict, telemetry_errors: int = 0) -> str:
    """Registry snapshot ({name: {"kind", "data"}}) -> exposition
    text.  Unknown kinds degrade to a generic numeric walk; rendering
    of one component never fails the whole page (errors are counted
    into ``amgx_telemetry_errors_total`` by the caller)."""
    fams = FamilyTable()
    errors = telemetry_errors
    for comp, ent in components.items():
        kind = ent.get("kind", "component")
        data = ent.get("data")
        if not isinstance(data, dict):
            continue
        fn = _RENDERERS.get(kind, None)
        try:
            if fn is None:
                generic_families(fams, kind, comp, data)
            else:
                fn(fams, comp, data)
        except Exception:  # noqa: BLE001 — one bad component must not
            # take down the whole exposition page
            errors += 1
    fams.add("amgx_telemetry_errors_total", "counter",
             "telemetry collection/export failures (degraded, "
             "never propagated to a solve)", {}, errors)
    return fams.render()
