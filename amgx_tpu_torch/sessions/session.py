"""Streaming solve sessions: time stepping as a serve workload (the JAX
package's ``sessions/session.py``).

AmgX's main production pattern is a time or Newton step: the same
sparsity pattern solved every step with new coefficients.  A session
registers the pattern once and then streams ``(values, b)`` pairs:

  SessionManager.open(A)   registers (ro, ci, n, fingerprint) and
       |                   the padded pattern once
       |
       v
  step(values_k, b_k)      per step, per session:
       | 1. prestage  - the values and rhs coerced and checked;
       | 2. resolve   - the previous step's result read; its x becomes
       |                the warm start (masked: a step that did not
       |                converge is never reused, zeros instead);
       | 3. submit    - the values-only fast path into the service
       |                (``_host``: no CSR extraction, no pattern hash),
       |                x0 = the warm start.
       v
  SessionManager.step_all(...)   B sessions of one pattern step in
                                 lockstep: their steps form one batched
                                 group, one hierarchy, one built
                                 batched solve.

The hierarchy is the service's: one setup per (pattern, config, dtype)
in its hierarchy cache, each step's coefficients through the batch
rebuild.  Every ``resetup_every`` steps of a pattern the manager also
refreshes the cached solver through
:meth:`BatchedSolveService.resetup_entry`, so the quarantine path and
the Chebyshev bound cache (``reestimate_eigs``) follow the stream.

Differences from the JAX package (ROADMAP.md, queue C):
  * the port's solve is synchronous (queue A.7.5): a group has run when
    its flush returns, so ``prestage`` never overlaps a solve in flight
    and ``resetup_overlap_s`` stays 0;
  * the service's batched loop reads each iteration's norms, so a step
    group costs its iterations + 2 host syncs, not one.

Telemetry, as in the JAX package: the manager registers a ``sessions``
source (:meth:`SessionManager.telemetry_snapshot`, the
``amgx_session_*`` families; :meth:`SessionManager.counters` holds the
same counts); a resolved step leaves a flight record (``path``
``session_step``) in the service's recorder; with request tracing on, a
sampled step's root span is ``session_step`` (its ``resetup`` child at
prestage, then the service's ``pad`` ... ``fetch``).

Not ported, each raising ``NotImplementedError`` with its queue item:
persistence (``save`` / ``restore`` / ``recover`` / ``save_all`` /
``drain``, a ``store`` and ``checkpoint_every``: A.7.6), a gateway
front, tenants and lanes, ``placement_device`` (A.7.7).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

import numpy as np

from amgx_tpu_torch.core.types import host_array
from amgx_tpu_torch.serve.service import (
    LANE,
    TENANT,
    BatchedSolveService,
    _host_csr,
    _resolve_dtype,
)
from amgx_tpu_torch.telemetry import (
    get_registry,
    telemetry_enabled,
    tracing,
)

_WARM_BOOT = "ROADMAP.md, queue A.7.6: warm boot and the service's store"
_GATEWAY = ("ROADMAP.md, queue A.7.7: the gateway, lanes, tenants and "
            "placement")


class StepTicket:
    """Handle of one streamed step.  ``result()`` resolves through the
    owning session, so the warm-start state updates once whoever asks
    first (the session's next ``step`` or the client)."""

    __slots__ = ("session", "step", "ticket", "resetup_s", "_res", "_err",
                 "_trace", "_t0")

    def __init__(self, session: "SolveSession", step: int, ticket,
                 resetup_s: float, trace=None, t0: float = 0.0):
        self.session = session
        self.step = step
        self.ticket = ticket
        self.resetup_s = resetup_s
        self._res = None
        self._err = None
        self._trace = trace
        self._t0 = t0

    def done(self) -> bool:
        return (self._res is not None or self._err is not None
                or self.ticket.done())

    def result(self):
        self.session._resolve_ticket(self)
        if self._err is not None:
            raise self._err
        return self._res


class SolveSession:
    """One streamed solve: a registered sparsity pattern and the
    warm-start state of its steps.  Made by :meth:`SessionManager.open`,
    never directly."""

    def __init__(self, manager: "SessionManager", session_id: str,
                 host: tuple, dtype, deadline_s: Optional[float] = None):
        self.manager = manager
        self.session_id = session_id
        # (row_offsets, col_indices, n, raw fingerprint): the one-time
        # registration that makes every step a values-only submit
        ro, ci, n, raw_fp = host
        self._ro = np.asarray(ro)
        self._ci = np.asarray(ci)
        self.n = int(n)
        self.nnz = int(self._ci.shape[0])
        self.fingerprint = raw_fp
        self.dtype = _resolve_dtype(dtype)
        self.deadline_s = deadline_s
        self.step_idx = 0  # steps resolved so far
        self.closed = False
        self._last_x: Optional[np.ndarray] = None
        self._last_status: Optional[int] = None
        self._last_iters: Optional[int] = None
        self._pending: Optional[StepTicket] = None
        self._staged = None  # (values, b, t0, resetup_s, trace)
        # the padded fingerprint (the hierarchy cache's key), set at open
        self._padded_fp: Optional[str] = None

    # -- warm-start state ----------------------------------------------

    def _x0_for_next(self):
        """(x0, warm): the previous step's solution where it converged,
        else None (zeros): a diverged step's x never seeds the next."""
        if self._last_x is not None and self._last_status == 0:
            return self._last_x, True
        return None, False

    @property
    def placement_device(self):
        raise NotImplementedError(
            f"SolveSession.placement_device: {_GATEWAY} is not ported")

    @property
    def last_x(self) -> Optional[np.ndarray]:
        """The last resolved step's solution (converged or not), a host
        array: the time-stepping client's state.  The warm start reuses
        only a converged one (``_x0_for_next``)."""
        return self._last_x

    @property
    def last_status(self) -> Optional[int]:
        return self._last_status

    @property
    def last_iterations(self) -> Optional[int]:
        return self._last_iters

    # -- the step's phases ---------------------------------------------

    def _coerce_b(self, b) -> np.ndarray:
        b = np.ascontiguousarray(np.asarray(b, dtype=self.dtype).reshape(-1))
        if b.shape[0] != self.n:
            raise ValueError(
                f"session {self.session_id}: expected length-{self.n} rhs, "
                f"got {b.shape[0]}")
        return b

    def prestage(self, values, b=None):
        """Stage the next step: coerce and check its coefficients (and
        rhs).  ``b`` may wait for :meth:`commit`, or be a callable of the
        session evaluated there, after the previous step resolved: the
        implicit-Euler form ``sess.prestage(vals, lambda s: s.last_x /
        dt + f)``."""
        if self.closed:
            raise RuntimeError(f"session {self.session_id} is closed")
        if self._staged is not None:
            raise RuntimeError(
                "prestage called twice without a commit; a session "
                "pipelines at depth one (x0 depends on the previous x)")
        t0 = time.perf_counter()
        ctx = tracing.new_trace()
        values = np.ascontiguousarray(
            np.asarray(values, dtype=self.dtype).reshape(-1))
        if values.shape[0] != self.nnz:
            raise ValueError(
                f"session {self.session_id}: expected {self.nnz} "
                f"coefficients, got {values.shape[0]}")
        if b is not None and not callable(b):
            b = self._coerce_b(b)
        resetup_s = time.perf_counter() - t0
        if ctx is not None:
            tracing.record_span("resetup", t0, t0 + resetup_s, ctx)
        self.manager._account_resetup(resetup_s)
        self._staged = (values, b, t0, resetup_s, ctx)
        return self

    def commit(self, b=None) -> StepTicket:
        """Resolve the previous step (updating the warm start) and submit
        the staged one with the masked warm start.  ``b`` (an array or a
        callable of the session) overrides a staged rhs; a callable sees
        the just-resolved step's ``last_x``."""
        if self._staged is None:
            raise RuntimeError("commit without a prestage")
        # consume the stage first: a failure below (the previous step's
        # error surfacing in the resolve, a raising rhs callable) leaves
        # the session retryable with a fresh prestage, not wedged
        (values, b0, t0, resetup_s, ctx), self._staged = self._staged, None
        if b is None:
            b = b0
        try:
            if self._pending is not None:
                self._resolve_ticket(self._pending)
            if callable(b):
                b = b(self)
            if b is None:
                raise ValueError("no rhs: pass b to prestage or commit")
            b = self._coerce_b(b)
            x0, warm = self._x0_for_next()
            step_idx = self.step_idx
            mgr = self.manager
            ticket = mgr._submit(self, values, b, x0, ctx)
        except BaseException as e:
            # close the sampled root, so its resetup child does not
            # dangle
            self._close_root(t0, ctx, error=type(e).__name__)
            raise
        mgr._count("steps_total")
        mgr._count("warm_starts_total" if warm else "cold_starts_total")
        st = StepTicket(self, step_idx, ticket, resetup_s, ctx, t0)
        self._pending = st
        if ctx is not None:
            # the step's root span, prestage through submit: its
            # children (resetup, pad, queue, dispatch, device, fetch)
            # parent onto it
            tracing.record_span(
                "session_step", t0, time.perf_counter(), ctx,
                args={"session": self.session_id, "step": step_idx,
                      "lane": LANE, "tenant": TENANT, "warm": warm},
                root=True)
        mgr._maybe_entry_resetup(self, values)
        return st

    def _close_root(self, t0, ctx, error: str):
        if ctx is not None:
            tracing.record_span(
                "session_step", t0, time.perf_counter(), ctx,
                args={"session": self.session_id, "step": self.step_idx,
                      "error": error},
                root=True)

    def step(self, values, b) -> StepTicket:
        """One time step: ``prestage`` and ``commit``.  For many sessions
        in lockstep use :meth:`SessionManager.step_all`."""
        self.prestage(values, b)
        return self.commit()

    def _abandon_stage(self, err=None):
        """Drop a staged step without submitting it (a lockstep peer
        failed), so the session stays retryable, and close its sampled
        root span."""
        if self._staged is None:
            return
        (_v, _b, t0, _rs, ctx), self._staged = self._staged, None
        self._close_root(t0, ctx, error=(type(err).__name__
                                         if err is not None
                                         else "abandoned"))

    def finish(self):
        """Resolve the step in flight, if any, and return ``last_x``
        (None before a resolved step).  Its error, if any, stays in the
        session state (``last_status`` None): ``finish`` does not
        raise."""
        self._abandon_stage()
        p = self._pending
        if p is not None:
            try:
                self._resolve_ticket(p)
            except Exception:  # noqa: BLE001 — captured in the state
                pass
        return self._last_x

    def _resolve_ticket(self, st: StepTicket):
        """Settle one step ticket once and fold its outcome into the
        warm-start state."""
        if st._res is not None or st._err is not None:
            if st._err is not None:
                raise st._err
            return
        try:
            res = st.ticket.result()
        except BaseException as e:
            st._err = e
            if self._pending is st:
                self._pending = None
                self._last_status = None  # never warm-start off an error
                self.step_idx = st.step + 1
            self.manager._count("step_failures_total")
            raise
        st._res = res
        if self._pending is st:
            self._pending = None
            self._last_x = host_array(res.x)
            self._last_status = int(res.status)
            self._last_iters = int(res.iters)
            self.step_idx = st.step + 1
            self.manager._record_step(self, st, res)

    def save(self, store=None) -> bool:
        raise NotImplementedError(
            f"SolveSession.save: {_WARM_BOOT} is not ported")

    def close(self):
        """Finish and deregister (the hierarchy stays cached for other
        sessions)."""
        self.finish()
        self.closed = True
        self.manager._discard(self)


class SessionManager:
    """The streaming sessions of one :class:`BatchedSolveService`.

    Parameters
    ----------
    front: the service every step submits through (a gateway front is
        not ported: queue A.7.7).
    store: the sessions' artifact store: not ported (A.7.6); None.
    resetup_every: every N streamed steps of a pattern, refresh its
        cached hierarchy entry with the step's values through
        :meth:`BatchedSolveService.resetup_entry` (0: never; default
        64).  Counted per
        fingerprint: B lockstep sessions share one entry.
    checkpoint_every: 0 (the default with no store); a cadence needs the
        store (A.7.6).
    """

    def __init__(self, front, store=None,
                 resetup_every: int = 64,
                 checkpoint_every: Optional[int] = None):
        if not isinstance(front, BatchedSolveService):
            raise NotImplementedError(
                f"SessionManager over {type(front).__name__}: {_GATEWAY} "
                "is not ported; pass a BatchedSolveService")
        if store is not None:
            raise NotImplementedError(
                f"SessionManager(store=...): {_WARM_BOOT} is not ported")
        if checkpoint_every:
            raise NotImplementedError(
                f"SessionManager(checkpoint_every=...): {_WARM_BOOT} is "
                "not ported")
        self.service = front
        self.store = None
        self.checkpoint_every = 0
        self.resetup_every = int(resetup_every)
        self._lock = threading.Lock()
        self._sessions: dict = {}
        self._counters: dict = {}
        self._resetup_s = 0.0
        # steps per fingerprint: the entry-refresh cadence follows the
        # entry's traffic, not one session's step count
        self._fp_steps: dict = {}
        self.telemetry_name = get_registry().register("sessions", self)

    # -- counters ------------------------------------------------------

    def _count(self, name: str, by: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def _account_resetup(self, seconds: float):
        with self._lock:
            self._resetup_s += seconds

    def counters(self) -> dict:
        """The manager's counters (the JAX package's ``amgx_session_*``
        families: ``opens_total``, ``steps_total``, ``warm_starts_total``,
        ``cold_starts_total``, ``step_groups_total``,
        ``step_failures_total``, ``entry_resetups_total``, ...), the
        resetup seconds and the open sessions."""
        with self._lock:
            out = dict(self._counters)
            out["resetup_seconds_total"] = self._resetup_s
            out["open"] = len(self._sessions)
        return out

    def telemetry_snapshot(self) -> dict:
        """Registry source (kind ``sessions``): :meth:`counters` and the
        overlap seconds (0: the solve is synchronous), the
        ``amgx_session_*`` families."""
        out = self.counters()
        out["resetup_overlap_seconds_total"] = self.resetup_overlap_s
        return out

    def _record_step(self, sess: SolveSession, st: StepTicket, res):
        """The flight record of one resolved step (``path``
        ``session_step``), in the service's recorder under its degrade
        contract."""
        if not telemetry_enabled():
            return
        self.service._flight_record(
            fingerprint=sess._padded_fp or sess.fingerprint,
            config=self.service.cfg_key, lane=LANE, tenant=TENANT,
            iterations=int(res.iters),
            final_residual=float(np.max(np.asarray(res.final_norm))),
            status=int(res.status),
            stages={"resetup": st.resetup_s,
                    "step": max(time.perf_counter() - st._t0, 0.0)},
            path="session_step",
            trace_id=(st._trace.trace_id if st._trace is not None
                      else None))

    @property
    def resetup_overlap_s(self) -> float:
        """Seconds of prestage work that ran while the previous step was
        still solving: 0, since a group has run when its flush returns
        (the solve is synchronous until ROADMAP.md queue A.7.5)."""
        return 0.0

    @property
    def resetup_s(self) -> float:
        with self._lock:
            return self._resetup_s

    # -- lifecycle -----------------------------------------------------

    def open(self, A, *, session_id: Optional[str] = None,
             tenant: str = "default", lane: str = "interactive",
             dtype=None, deadline_s: Optional[float] = None,
             x0=None) -> SolveSession:
        """Register ``A``'s sparsity pattern (a SparseMatrix or a scipy
        sparse matrix; its values only set the default dtype) and return
        its session.  ``x0`` seeds the first step's warm start;
        ``deadline_s`` applies to every step's submit."""
        if tenant != "default" or lane != "interactive":
            raise NotImplementedError(
                f"SessionManager.open(tenant=, lane=): {_GATEWAY} is not "
                "ported")
        svc = self.service
        ro, ci, vals, n, raw_fp = _host_csr(A, svc.metrics)
        if session_id is None:
            session_id = f"sess-{uuid.uuid4().hex[:12]}"
        sess = SolveSession(self, session_id, (ro, ci, n, raw_fp),
                            dtype if dtype is not None else vals.dtype,
                            deadline_s=deadline_s)
        # the padded pattern too, so that no step hashes anything
        sess._padded_fp = svc._pattern_for(ro, ci, n, raw_fp).fingerprint
        if x0 is not None:
            sess._last_x = np.asarray(x0, dtype=sess.dtype).reshape(-1)
            sess._last_status = 0
        with self._lock:
            self._sessions[session_id] = sess
        self._count("opens_total")
        return sess

    def _discard(self, sess: SolveSession):
        with self._lock:
            if self._sessions.get(sess.session_id) is sess:
                del self._sessions[sess.session_id]

    def sessions(self) -> list:
        with self._lock:
            return list(self._sessions.values())

    def get(self, session_id: str) -> Optional[SolveSession]:
        with self._lock:
            return self._sessions.get(session_id)

    # -- stepping ------------------------------------------------------

    def _submit(self, sess: SolveSession, values, b, x0, trace=None):
        """One step into the service by the values-only fast path: the
        registered (ro, ci, n, fingerprint) go in as ``_host``, so the
        submit extracts no CSR and hashes no pattern; ``trace`` is the
        step's sampled context (its root is the step's)."""
        host = (sess._ro, sess._ci, values, sess.n, sess.fingerprint)
        return self.service.submit(None, b, x0, deadline_s=sess.deadline_s,
                                   _host=host, _trace=trace)

    def step_all(self, steps) -> list:
        """Lockstep step of many sessions: ``steps`` is a list of
        ``(session, values, b)``.  Stages every member first, then
        commits them all (one group of the service), then flushes.  A
        member's failure unwinds the stages still pending, so a retry of
        the whole group stages cleanly (members already committed keep
        their tickets).  Returns the StepTickets in order."""
        staged = []
        try:
            for sess, values, b in steps:
                sess.prestage(values, b)
                staged.append(sess)
            tickets = [sess.commit() for sess, _v, _b in steps]
        except BaseException as e:
            for sess in staged:
                sess._abandon_stage(e)
            raise
        self.flush()
        self._count("step_groups_total")
        return tickets

    def flush(self):
        self.service.flush()

    def _maybe_entry_resetup(self, sess: SolveSession, values):
        """The ``resetup_every`` cadence: refresh the cached hierarchy
        entry with this step's values.  Best-effort: no entry yet, or a
        failed refresh, never fails the step (the batched path rebuilds
        each step's params anyway)."""
        n = self.resetup_every
        if n <= 0:
            return
        with self._lock:
            c = self._fp_steps.get(sess.fingerprint, 0) + 1
            self._fp_steps[sess.fingerprint] = c
        if c % n:
            return
        fp = sess._padded_fp or sess.fingerprint
        try:
            self.service.resetup_entry(fp, values, sess.dtype)
            self._count("entry_resetups_total")
        except KeyError:
            pass  # the first group has not built its entry yet
        except Exception:  # noqa: BLE001 — the cadence is an optimisation
            self._count("entry_resetup_failures_total")

    # -- persistence (ROADMAP.md, queue A.7.6) -------------------------

    def save_session(self, sess, store=None) -> bool:
        raise NotImplementedError(
            f"SessionManager.save_session: {_WARM_BOOT} is not ported")

    def restore(self, session_id: str, **kw):
        raise NotImplementedError(
            f"SessionManager.restore: {_WARM_BOOT} is not ported")

    def recover(self, session_id: str, **kw):
        raise NotImplementedError(
            f"SessionManager.recover: {_WARM_BOOT} is not ported")

    def save_all(self) -> int:
        raise NotImplementedError(
            f"SessionManager.save_all: {_WARM_BOOT} is not ported")

    def drain(self) -> dict:
        raise NotImplementedError(
            f"SessionManager.drain: {_WARM_BOOT} is not ported")
