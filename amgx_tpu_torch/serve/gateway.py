"""The gateway: the admission-controlled door in front of a
:class:`~amgx_tpu_torch.serve.service.BatchedSolveService` (the JAX
package's ``serve/gateway.py``).  A bare service accepts every submit;
the gateway makes overload a typed, recoverable condition:

  submit(tenant, lane, deadline_s)
      | 1. drain gate      - draining or drained: typed Overloaded
      | 2. breaker shed    - the pattern's circuit breaker is open: shed
      |                      before it queues; every Nth submit is
      |                      admitted as the half-open probe
      | 3. admission       - the tenant's token bucket and device-seconds
      |                      budget, the concurrency budget (the batch
      |                      lane sheds first: interactive keeps a
      |                      reserve), the deadline predictor on the p99
      |                      reservoirs (no p99 yet: admit)
      v
  BatchedSolveService.submit(lane=, tenant=)   priority lanes at flush,
      |                                       deadlines at submit,
      v                                       flush and fetch
  GatewayTicket.result()  - settles the in-flight reservation

Every shed goes through ``_shed`` and raises :class:`~amgx_tpu_torch.
core.errors.AdmissionRejected` or :class:`~amgx_tpu_torch.core.errors.
Overloaded` with an AMGX_RC code and ``retry_after_s``, counted by
reason and tenant and logged as a ``shed`` incident.  ``drain()`` is the
hand-off: stop admitting, flush and settle every admitted ticket (done
or typed: none is lost), export the hierarchy cache to the store and
save the sessions, so that a replacement worker warm-boots the hot
patterns.  ``await gateway.solve(...)`` runs admission inline and waits
for the group's fetch on the event loop's default executor.  The fault
sites ``gateway_shed`` (a shed at the door), ``admission_quota`` (in
:class:`~amgx_tpu_torch.serve.admission.AdmissionController`) and
``drain_timeout`` (a drain with no settle budget) meet their failures
here.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from amgx_tpu_torch.core.errors import (
    AdmissionRejected,
    DeadlineExceededError,
    Overloaded,
)
from amgx_tpu_torch.serve.admission import AdmissionController, TenantQuota
from amgx_tpu_torch.serve.service import BatchedSolveService, _host_csr
from amgx_tpu_torch.telemetry import get_registry, tracing

LANES = ("interactive", "batch")

# bound on distinct tenants tracked per gateway: an adversarial (or
# buggy) client minting tenant ids must not grow the telemetry dict
# unboundedly — overflow traffic aggregates under one bucket
_TENANT_CAP = 256
_TENANT_OVERFLOW = "_other"


class GatewayTicket:
    """Admitted-request handle: wraps the service's SolveTicket and
    settles the gateway's in-flight reservation exactly once, on the
    first ``result()`` that completes (either way).  ``drain()`` may
    force-settle an UNsettled ticket with a typed error; the typed
    error then wins over a still-in-flight device result — but never
    over a ``result()`` that already returned a success (settling and
    force-failing are one atomic check-and-set, so retries stay
    consistent with what the first caller saw)."""

    __slots__ = ("_gw", "_ticket", "tenant", "lane", "_settled",
                 "_forced_error", "_lock", "_probe_fp")

    def __init__(self, gw: "SolveGateway", ticket, tenant: str,
                 lane: str, probe_fp: Optional[str] = None):
        self._gw = gw
        self._ticket = ticket
        self.tenant = tenant
        self.lane = lane
        self._settled = False
        self._forced_error = None
        self._lock = threading.Lock()
        # fingerprint this ticket is the door's half-open probe for
        # (None for normal traffic): settling it re-opens the probe
        # slot so the door can try again if the breaker is still open
        self._probe_fp = probe_fp

    def done(self) -> bool:
        return self._forced_error is not None or self._ticket.done()

    def result(self):
        with self._lock:
            if self._forced_error is not None:
                raise self._forced_error
        try:
            res = self._ticket.result()
        except BaseException as e:
            self._settle(error=e)
            raise
        settle = False
        with self._lock:
            # a drain timeout that force-settled this ticket while we
            # were blocked in the fetch wins: the caller sees the same
            # typed failure the drain report counted, not a success
            # the accounting already wrote off.  Marking settled in
            # the SAME critical section closes the converse race: once
            # a success is returned here, a later _fail is a no-op.
            if self._forced_error is not None:
                raise self._forced_error
            if not self._settled:
                self._settled = True
                settle = True
        if settle:
            self._gw._on_settle(self, None)
        return res

    def _fail(self, err: BaseException) -> bool:
        """Force-settle with a typed error (drain timeout): admitted
        tickets are never lost — they complete or fail TYPED.
        Returns False without touching the ticket when it already
        settled (a client's ``result()`` completed first): that
        outcome stands, and the caller must not count this ticket as
        timed out."""
        with self._lock:
            if self._settled or self._forced_error is not None:
                return False
            self._forced_error = err
            self._settled = True
        self._gw._on_settle(self, err)
        return True

    def _settle(self, error):
        with self._lock:
            if self._settled:
                return
            self._settled = True
        self._gw._on_settle(self, error)


class SolveGateway:
    """Multi-tenant, deadline-aware, load-shedding front door.

    Parameters
    ----------
    service: an existing BatchedSolveService to front, or None to
        build one from ``config`` / ``store`` / ``service_kwargs``.
        The gateway shares the service's ServeMetrics, so gateway
        counters and serve counters land in one snapshot.
    max_inflight: global concurrency budget — admitted-but-unsettled
        tickets.  This, not the submit rate, is what bounds memory:
        staged rows and device results live until the ticket settles.
    interactive_reserve_frac: fraction of the budget only the
        interactive lane may use; the batch lane sheds at
        ``(1 - frac) * max_inflight`` so overload degrades batch
        first (the load-bench contract).
    quotas / default_quota: per-tenant token buckets
        (:class:`~amgx_tpu_torch.serve.admission.TenantQuota`);
        ``default_quota=None`` means unlisted tenants are unlimited.
    deadline_headroom: shed a deadline tighter than
        ``headroom * p99``; the p99 comes from the service's ticket
        latency reservoir and a missing percentile always admits.
    shed_broken: shed patterns whose circuit breaker is open at the
        DOOR (typed, with a retry hint at the breaker's probe
        cadence) instead of letting them occupy queue and quarantine
        capacity.  Every Nth broken-pattern submit (the service's own
        probe cadence) is admitted as the half-open probe so the
        breaker can still close; its success re-opens the door for
        the fingerprint.
    """

    def __init__(
        self,
        service: Optional[BatchedSolveService] = None,
        *,
        config=None,
        store=None,
        max_inflight: int = 256,
        interactive_reserve_frac: float = 0.25,
        quotas: Optional[dict] = None,
        default_quota: Optional[TenantQuota] = None,
        deadline_headroom: float = 1.0,
        retry_after_cap_s: float = 60.0,
        shed_broken: bool = True,
        **service_kwargs,
    ):
        if service is None:
            service = BatchedSolveService(
                config=config, store=store, **service_kwargs
            )
        elif config is not None or store is not None or service_kwargs:
            raise ValueError(
                "pass EITHER an existing service OR construction "
                "kwargs, not both"
            )
        self.service = service
        self.metrics = service.metrics
        self.admission = AdmissionController(
            max_inflight=max_inflight,
            interactive_reserve_frac=interactive_reserve_frac,
            default_quota=default_quota,
            quotas=quotas,
            deadline_headroom=deadline_headroom,
            retry_after_cap_s=retry_after_cap_s,
        )
        self.shed_broken = bool(shed_broken)
        self._state = "serving"  # serving | draining | drained
        self._state_lock = threading.Lock()
        self._outstanding: set = set()
        # fingerprints with a door-admitted half-open probe currently
        # in flight (guarded by the SERVICE lock, like the probe
        # counter it aligns with): exactly one probe per fingerprint
        # at a time, so a burst of broken-pattern traffic cannot
        # flood past the breaker gate during the admit-to-execute
        # window
        self._probe_pending: set = set()
        self._drain_report: Optional[dict] = None
        # set once the drain's report is final: concurrent drain()
        # callers (shutdown hook + health manager) wait for the ONE
        # running drain instead of racing a second settle loop
        self._drained = threading.Event()
        # per-tenant admitted/shed/completed counters (telemetry):
        # bounded cardinality, own lock (tiny critical sections, never
        # nested with the state or service locks)
        self._tenant_lock = threading.Lock()
        self._tenants: dict = {}
        # the service's flight recorder is the gateway's too: sheds
        # and drains land in the same incident log as quarantines
        self.recorder = self.service.recorder
        # device-seconds enforcement: every share the fetch records
        # per (tenant, lane) is also charged against the tenant's
        # device budget, so quotas with
        # device_seconds_rate shed big-n tenants typed
        # (reason="device_budget") once their measured device time
        # outruns the refill.  Last gateway wired to a shared service
        # wins the hook — same single-owner contract as telemetry
        # registration.
        self.metrics.on_tenant_device = self._charge_device_seconds
        # streaming-session manager (amgx_tpu_torch.sessions), built lazily
        # by the first open_session(); drain() persists its manifests
        self._session_mgr = None
        self.telemetry_name = get_registry().register("gateway", self)

    # ------------------------------------------------------------------
    # telemetry

    def _charge_device_seconds(self, tenant: str, lane: str,
                               seconds: float):
        """ServeMetrics.on_tenant_device hook: debit the tenant's
        device-seconds budget with this ticket's measured share."""
        self.admission.charge_device_seconds(tenant, seconds, lane=lane)

    def _tenant_inc(self, tenant: str, key: str):
        with self._tenant_lock:
            st = self._tenants.get(tenant)
            if st is None:
                if len(self._tenants) >= _TENANT_CAP:
                    tenant = _TENANT_OVERFLOW
                st = self._tenants.setdefault(
                    tenant, {"admitted": 0, "sheds": 0, "completed": 0}
                )
            st[key] += 1

    def telemetry_snapshot(self) -> dict:
        """Registry source (kind="gateway"): admission/tenant view
        plus the flight-recorder summary.  The shared serve counter
        set is exported by the service's own registration — this
        source covers what only the gateway knows."""
        with self._tenant_lock:
            tenants = {t: dict(st) for t, st in self._tenants.items()}
        adm = self.admission.snapshot()
        for t, tokens in adm.pop("tenant_tokens", {}).items():
            if t in tenants:
                tenants[t]["tokens"] = tokens
        return {
            "state": self._state,
            "tenants": tenants,
            # per-tenant/lane device-seconds (cost accounting): lives
            # in the shared serve metrics, exported under the gateway
            # source as amgx_gateway_tenant_device_seconds_total
            "tenant_device_s": self.metrics.tenant_device_snapshot(),
            "recorder": self.recorder.summary(),
            **adm,
        }

    def debug_report(self) -> dict:
        """The whole observability surface in one call (operator
        debugging: "what is this worker doing and what has gone wrong
        lately"): health view, full metrics snapshot, flight-recorder
        records and incident log, and the trace-buffer stats."""
        return {
            "health": self.health(),
            "metrics": self.metrics.snapshot(),
            "flight": self.recorder.to_dict(),
            "tracing": tracing.telemetry_snapshot(),
        }

    # ------------------------------------------------------------------
    # lifecycle

    @property
    def state(self) -> str:
        return self._state

    def start(self, interval_s: float = 0.005):
        self.service.start(interval_s)
        return self

    def stop(self):
        self.service.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def flush(self):
        self.service.flush()

    # ------------------------------------------------------------------
    # submission

    def _shed(self, err: AdmissionRejected, tenant: str = None,
              ctx=None, t0: float = None, root: bool = True):
        """Count one typed shed by reason (and tenant), log the
        incident, and raise it.  ``root=False`` when a front-end (a
        streaming session) minted the trace and owns its root span —
        the shed's submit span then records as a child."""
        self.metrics.inc("gateway_sheds")
        self.metrics.inc(f"shed_{err.reason}")
        if tenant is not None:
            self._tenant_inc(tenant, "sheds")
        # every typed shed is a flight-recorder incident (throttled
        # snapshot capture inside: an overload's shed storm must not
        # turn the observer into load)
        self.service._flight_incident(
            "shed", detail=f"{err.reason} (tenant {tenant!r})"
        )
        if ctx is not None:
            # close the sampled trace's root: without this the shed
            # path's child spans parent onto a root id that never
            # appears in the export (dangling parent_id in Perfetto)
            tracing.record_span(
                "submit", t0, time.perf_counter(), ctx,
                args={"tenant": tenant, "shed": err.reason}, root=root,
            )
        raise err

    def predicted_p99_s(self) -> Optional[float]:
        """The shed predictor's tail estimate: p99 of end-to-end
        ticket latency, None while the reservoir is empty (which
        ADMITS — a cold service must take traffic to learn).  Read
        through the LOCKED accessor: the bare reservoir's copy+sort
        races concurrent submit threads writing the ring."""
        return self.metrics.latency_percentile("total", 99.0)

    def _door_probe(self, fp: str) -> bool:
        """Half-open probing through a shedding door: every Nth
        broken-pattern submit (the service's own probe cadence) is
        ADMITTED so the breaker can still close — with everything
        else shed at the door, nothing would otherwise reach
        ``_execute_group`` and a tripped fingerprint would be a
        permanent outage.  The door shares the service's per-
        fingerprint probe counter and, on the admitting hit, rolls it
        back one so ``_execute_group``'s own increment lands back on
        the probe multiple: the admitted group IS the batched probe,
        not the start of another shed cycle.

        At most ONE probe is in flight per fingerprint
        (``_probe_pending``, cleared when the probe's ticket settles):
        while it is pending the door sheds WITHOUT counting, so the
        rolled-back counter cannot re-admit a flood of broken-pattern
        traffic during the admit-to-execute window, and the counter
        stays aligned for the probe group's own increment."""
        svc = self.service
        with svc._lock:
            if fp in self._probe_pending:
                return False
            n = svc._bypass_counts.get(fp, 0) + 1
            if n % svc.breaker_probe_every == 0:
                svc._bypass_counts[fp] = n - 1
                self._probe_pending.add(fp)
                return True
            svc._bypass_counts[fp] = n
            return False

    def _probe_done(self, fp: str):
        """The in-flight probe for ``fp`` resolved (its ticket
        settled, or it never became a ticket): re-open the probe
        slot."""
        with self.service._lock:
            self._probe_pending.discard(fp)

    def submit(self, A, b, x0=None, *, tenant: str = "default",
               lane: str = "interactive",
               deadline_s: Optional[float] = None,
               _host=None,
               _trace=BatchedSolveService._TRACE_UNSET) -> GatewayTicket:
        """Admit-or-shed, then queue.  Raises typed
        :class:`AdmissionRejected`/:class:`Overloaded` (with
        ``retry_after_s``) on shed, typed
        :class:`DeadlineExceededError` for a dead-on-arrival
        deadline; returns a :class:`GatewayTicket` once admitted.

        ``_host``/``_trace``: the streaming-session fast path — a
        session that registered its pattern once passes the
        pre-extracted ``(ro, ci, vals, n, fingerprint)`` tuple (no
        per-step CSR extraction or hashing) and the trace context it
        minted for the step (the session owns the root span; the
        gateway's submit span records as a child)."""
        from amgx_tpu_torch.core import faults

        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; lanes: {LANES}")
        # request tracing: the gateway is the front door, so the trace
        # root is minted here (one float compare when tracing is off)
        # — unless a session front-end already minted one
        root = _trace is BatchedSolveService._TRACE_UNSET
        ctx = tracing.new_trace() if root else _trace
        t_gw = time.perf_counter()
        if self._state != "serving":
            self._shed(Overloaded(
                f"gateway is {self._state}: not admitting",
                # the hint is for the REPLACEMENT worker: one drain
                # timeout's worth of backoff, capped like every hint
                retry_after_s=min(1.0, self.admission.retry_after_cap_s),
                reason="draining",
            ), tenant, ctx=ctx, t0=t_gw, root=root)
        if faults.should_fire("gateway_shed"):
            self._shed(Overloaded(
                "injected shed (fault site gateway_shed)",
                retry_after_s=0.05,
                reason="overloaded",
            ), tenant, ctx=ctx, t0=t_gw, root=root)
        svc = self.service
        host = _host
        probe_fp = None
        if self.shed_broken and svc._broken:
            # tripped fingerprint sheds BEFORE it queues.  The CSR
            # extraction runs once — the tuple is threaded through to
            # svc.submit — and the fingerprint hash is memoized on
            # the matrix object, so the gate stays cheap even while
            # a breaker is open (exactly the incident window where
            # the door must not get slower)
            if host is None:
                host = _host_csr(A)
            ro, ci, vals, n, raw_fp = host
            pat = svc._pattern_for(ro, ci, n, raw_fp)
            if pat.fingerprint in svc._broken:
                if self._door_probe(pat.fingerprint):
                    probe_fp = pat.fingerprint
                else:
                    self._shed(AdmissionRejected(
                        "pattern's circuit breaker is open "
                        f"({pat.fingerprint[:12]}...): shedding at "
                        "admission",
                        retry_after_s=min(
                            svc.max_wait_s * svc.breaker_probe_every,
                            self.admission.retry_after_cap_s,
                        ),
                        reason="breaker_open",
                    ), tenant, ctx=ctx, t0=t_gw, root=root)
        try:
            t_adm = time.perf_counter()
            try:
                self.admission.admit(
                    tenant=tenant,
                    lane=lane,
                    deadline_s=deadline_s,
                    # bound method, not a value: the controller
                    # resolves it lazily, so the reservoir copy+sort
                    # behind the p99 never runs on the hot
                    # no-deadline, under-budget path
                    predicted_s=self.predicted_p99_s,
                )
            except AdmissionRejected as e:
                if ctx is not None:
                    tracing.record_span(
                        "admission", t_adm, time.perf_counter(), ctx,
                        args={"shed": e.reason},
                    )
                # count by reason, close the trace root, re-raise
                self._shed(e, tenant, ctx=ctx, t0=t_gw, root=root)
            if ctx is not None:
                tracing.record_span(
                    "admission", t_adm, time.perf_counter(), ctx
                )
            try:
                t = svc.submit(A, b, x0, deadline_s=deadline_s,
                               lane=lane, tenant=tenant, _host=host,
                               _trace=ctx)
            except BaseException:
                # not admitted after all (validation reject, dead-on-
                # arrival deadline, malformed input): hand the budget
                # back
                self.admission.release()
                if ctx is not None:
                    # close the sampled root so the already-recorded
                    # admission/serve_submit children don't dangle
                    tracing.record_span(
                        "submit", t_gw, time.perf_counter(), ctx,
                        args={"tenant": tenant, "rejected": True},
                        root=root,
                    )
                raise
        except BaseException:
            # the door-admitted probe never became a ticket (shed by
            # a later gate or rejected by the service): re-open the
            # probe slot so the next broken-pattern submit retries it
            if probe_fp is not None:
                self._probe_done(probe_fp)
            raise
        gt = GatewayTicket(self, t, tenant, lane, probe_fp=probe_fp)
        with self._state_lock:
            self._outstanding.add(gt)
            late = self._state != "serving"
        if late:
            # drain() started between the (unlocked) state gate and
            # this registration: the drain's flush may have missed the
            # group we just queued into a stopped service — flush it
            # ourselves so the ticket can always settle.  If the
            # drain's settle loop is still running it picks the ticket
            # up from _outstanding; if it already returned, the caller
            # holds the ticket and settles it — either way it is not
            # lost, it is merely absent from the drain report.
            self.service.flush()
        self.metrics.inc("gateway_admitted")
        self._tenant_inc(tenant, "admitted")
        if ctx is not None:
            # the trace root: gateway entry to admitted ticket (a
            # plain child span when a session owns the root)
            tracing.record_span(
                "submit", t_gw, time.perf_counter(), ctx,
                args={"lane": lane, "tenant": tenant}, root=root,
            )
        return gt

    async def solve(self, A, b, x0=None, *, tenant: str = "default",
                    lane: str = "interactive",
                    deadline_s: Optional[float] = None):
        """Asyncio face: admission runs inline (typed sheds raise
        synchronously into the coroutine); the blocking per-group
        fetch parks on the default executor so the event loop stays
        free."""
        import asyncio

        ticket = self.submit(
            A, b, x0, tenant=tenant, lane=lane, deadline_s=deadline_s
        )
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, ticket.result)

    # ------------------------------------------------------------------
    # streaming sessions (amgx_tpu_torch.sessions)

    @property
    def sessions(self):
        """The gateway's :class:`~amgx_tpu_torch.sessions.SessionManager`
        (built on first use): every streamed step submits through THIS
        gateway, so admission control, lanes, tenant quotas and
        deadline shedding apply per step."""
        if self._session_mgr is None:
            from amgx_tpu_torch.sessions import SessionManager

            mgr = SessionManager(self)
            with self._state_lock:
                # locked check-then-set: two concurrent first
                # open_session() calls must share ONE manager, or the
                # loser's sessions would be invisible to drain()
                if self._session_mgr is None:
                    self._session_mgr = mgr
        return self._session_mgr

    def open_session(self, A, *, session_id=None,
                     tenant: str = "default",
                     lane: str = "interactive", dtype=None,
                     deadline_s: Optional[float] = None, x0=None):
        """Open a streaming solve session (transient-PDE workload):
        registers ``A``'s sparsity fingerprint once; the returned
        :class:`~amgx_tpu_torch.sessions.SolveSession` then streams
        ``(values, b)`` steps — each admitted as one ticket — with
        values-only resetup pipelined against the in-flight previous
        step and masked warm starts.  ``deadline_s`` applies per
        step."""
        return self.sessions.open(
            A, session_id=session_id, tenant=tenant, lane=lane,
            dtype=dtype, deadline_s=deadline_s, x0=x0,
        )

    def restore_session(self, session_id: str):
        """Resume a persisted session (see
        :meth:`~amgx_tpu_torch.sessions.SessionManager.restore`); callers
        warm-boot the service first so the stream continues without a
        single coarsening call."""
        return self.sessions.restore(session_id)

    def _on_settle(self, ticket: GatewayTicket, error):
        if ticket._probe_fp is not None:
            self._probe_done(ticket._probe_fp)
        self.admission.release()
        with self._state_lock:
            self._outstanding.discard(ticket)
        if error is None:
            self.metrics.inc("gateway_completed")
            self._tenant_inc(ticket.tenant, "completed")
        else:
            from amgx_tpu_torch.core.errors import AMGXTPUError

            self.metrics.inc(
                "gateway_typed_failures"
                if isinstance(error, AMGXTPUError)
                else "gateway_untyped_failures"
            )

    # ------------------------------------------------------------------
    # drain + health

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Graceful handoff: stop admission, flush and settle every
        admitted ticket, export the hierarchy cache to the store.

        The contract: no admitted ticket is LOST — each one completes or raises a
        typed failure (tickets still unsettled when ``timeout_s``
        runs out fail with :class:`DeadlineExceededError`) — and the
        fleet's hot fingerprints are on disk for the replacement
        worker's ``warm_boot()`` before this returns.  Idempotent and
        single-flight: concurrent callers wait for the one running
        drain and receive its report.

        Timeout granularity: the budget is checked between tickets,
        so ``drain`` can overrun ``timeout_s`` by at most the one
        ``result()`` currently settling — every queued group was
        flushed first, so that wait is one dispatched group's device
        fetch, not an unbounded queue."""
        from amgx_tpu_torch.core import faults

        with self._state_lock:
            already = self._state != "serving"
            self._state = "draining" if not already else self._state
        if already:
            # single-flight: wait for the running (or finished) drain
            self._drained.wait()
            with self._state_lock:
                return dict(self._drain_report)
        self.metrics.set_gauge("gateway_draining", 1)
        self.service.stop()  # stops the poller AND flushes
        self.service.flush()  # no poller was running: flush explicitly
        if faults.should_fire("drain_timeout"):
            timeout_s = 0.0
        deadline = time.monotonic() + max(float(timeout_s), 0.0)
        settled = failed = timed_out = 0
        while True:
            with self._state_lock:
                ticket = next(iter(self._outstanding), None)
            if ticket is None:
                break
            if time.monotonic() > deadline:
                if ticket._fail(DeadlineExceededError(
                    "gateway drain timed out before this ticket "
                    "settled"
                )):
                    timed_out += 1
                else:
                    # lost the settle race to a client thread: its
                    # success stands; give its _on_settle a beat to
                    # unregister the ticket before re-scanning
                    time.sleep(0.0005)
                continue
            try:
                ticket.result()
                settled += 1
            except BaseException:  # noqa: BLE001 — typed per-ticket
                failed += 1
        exported = self.service.export_all_entries()
        # streaming sessions: every outstanding ticket above has
        # settled, so each session's warm-start state is final —
        # persist the manifests now, next to the hierarchies the
        # replacement worker will warm-boot
        sessions_saved = 0
        if self._session_mgr is not None:
            try:
                sessions_saved = self._session_mgr.save_all()
            except Exception:  # noqa: BLE001 — drain stays
                # best-effort: a broken store must not fail the
                # handoff (Ctrl-C still propagates)
                pass
        if timed_out:
            # a drain that force-failed tickets is an operator-grade
            # event: capture it (with a metrics snapshot) so the
            # post-mortem can see what was still in flight
            self.service._flight_incident(
                "drain_timeout",
                detail=f"{timed_out} tickets force-failed after "
                       f"{float(timeout_s):g}s settle budget",
            )
        report = {
            "settled": settled,
            "failed": failed,
            "timed_out": timed_out,
            "exported": exported,
            "sessions_saved": sessions_saved,
        }
        with self._state_lock:
            self._state = "drained"
            self._drain_report = report
        self.metrics.set_gauge("gateway_draining", 0)
        self.metrics.inc("gateway_drains")
        self._drained.set()
        return dict(report)

    def health(self) -> dict:
        """Liveness/readiness view for an external prober: serving
        state, budget occupancy, queue depth, breaker count, shed and
        lane-latency summaries, and the flight-recorder ``incidents``
        summary (what has tripped lately — counts by kind; the full
        incident log is :meth:`debug_report`).

        When the service's placement policy keeps per-device failure
        breakers (``placement.health`` is a
        :class:`~amgx_tpu_torch.serve.placement.health.DeviceHealthBoard`;
        none of the port's, whose one policy is single-device), its
        snapshot rides along as ``device_health`` so one probe reads
        worker AND device health."""
        m = self.metrics
        snap = {
            "incidents": self.recorder.summary(),
            "state": self._state,
            "inflight": self.admission.inflight,
            "max_inflight": self.admission.max_inflight,
            "queue_depth": m.get("queue_depth"),
            "breakers_open": m.get("breakers_open"),
            "admitted": m.get("gateway_admitted"),
            "completed": m.get("gateway_completed"),
            "sheds": m.get("gateway_sheds"),
            "typed_failures": m.get("gateway_typed_failures"),
            "untyped_failures": m.get("gateway_untyped_failures"),
        }
        for lane in LANES:
            p99 = m.lane_percentile(lane, 99.0)
            snap[f"{lane}_p99_s"] = p99
        board = getattr(self.service.placement, "health", None)
        if board is not None:
            try:
                snap["device_health"] = board.snapshot()
            except Exception:  # noqa: BLE001 — health must not raise
                self.metrics.inc("telemetry_errors")
        return snap
