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

Over a started service (its poller running, ``start()``), the flush of
a step group (the submit that fills ``max_batch``, or ``step_all``'s
flush) hands it to the service's dispatch worker and returns at the
hand-over; the group is fetched at the next step's resolve, so
``prestage`` of step k + 1 runs while step k's loop is still running:
that time is the resetup/solve overlap (``resetup_overlap_s``).  Over a
service that is not started the group runs inline in the flush, as
every synchronous flush of the port does, and the overlap stays 0 (the
JAX package's flush returns at dispatch on any service; ROADMAP.md,
queue C).  The service's batched loop reads each iteration's norms, so
a step group costs its iterations + 2 host syncs, not one (queue C).

Persistence, as in the JAX package: :meth:`SolveSession.save` writes a
small manifest (step counter, warm start x, status, the registered
pattern) into the :class:`~amgx_tpu_torch.store.ArtifactStore`; the
hierarchy is the serve layer's own export (``store/warmboot.py``).  A
drained worker's sessions survive a restart: ``warm_boot()`` then
:meth:`SessionManager.restore` resume the stream at the saved step with
no coarsening and the exporter's hierarchy bit for bit.
``checkpoint_every`` saves each session every N resolved steps, and
:meth:`SessionManager.recover` resumes a session from its last
checkpoint.

Telemetry, as in the JAX package: the manager registers a ``sessions``
source (:meth:`SessionManager.telemetry_snapshot`, the
``amgx_session_*`` families, the saves, checkpoints, restores and their
failures among them; :meth:`SessionManager.counters` holds the same
counts); a resolved step leaves a flight record (``path``
``session_step``) in the service's recorder; with request tracing on, a
sampled step's root span is ``session_step`` (its ``resetup`` child at
prestage, then the service's ``pad`` ... ``fetch``).

Fronts, as in the JAX package: a :class:`~amgx_tpu_torch.serve.gateway.
SolveGateway` in place of the service admits each step as one ticket
(lanes, tenant quotas, deadline shedding and the concurrency budget
apply per step; a shed step raises its typed error at commit);
``open(tenant=, lane=)`` labels a session's steps, and ``restore`` takes
them from the manifest unless given.  ``SolveSession.placement_device``
is the device the placement policy routes the session's pattern to:
None on the port's one device.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional

import numpy as np

from amgx_tpu_torch.core.errors import StoreError
from amgx_tpu_torch.core.types import host_array
from amgx_tpu_torch.serve.service import _host_csr, _resolve_dtype
from amgx_tpu_torch.telemetry import (
    get_registry,
    telemetry_enabled,
    tracing,
)

SESSION_KIND = "solve_session"
# sessions are keyed in the store without a dtype axis (the dtype is in
# the manifest); this fills the key's dtype slot
_SESSION_KEY_DTYPE = "session"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


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

    def _service_ticket(self):
        """The serve SolveTicket (a gateway ticket's, unwrapped)."""
        return getattr(self.ticket, "_ticket", self.ticket)


class SolveSession:
    """One streamed solve: a registered sparsity pattern and the
    warm-start state of its steps.  Made by :meth:`SessionManager.open`,
    never directly."""

    def __init__(self, manager: "SessionManager", session_id: str,
                 host: tuple, dtype, tenant: str = "default",
                 lane: str = "interactive",
                 deadline_s: Optional[float] = None):
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
        self.tenant = tenant
        self.lane = lane
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
    def placement_device(self) -> Optional[str]:
        """The device the service's placement policy holds this
        session's hierarchy on: None before the pattern is known, and
        under a policy that does not route (the port's single
        device)."""
        fp = self._padded_fp
        if fp is None:
            return None
        return self.manager.service.placement.device_for(fp)

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
        overlapped = self._previous_in_flight()
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
        self.manager._account_resetup(resetup_s, overlapped)
        self._staged = (values, b, t0, resetup_s, ctx)
        return self

    def _previous_in_flight(self) -> bool:
        """Is the previous step's group still running (handed to the
        dispatch worker, its loop not ended)?  Host work done now then
        overlaps it.  A group flushed inline has ended by the time the
        next prestage runs."""
        p = self._pending
        if p is None or p._res is not None or p._err is not None:
            return False
        batch = getattr(p._service_ticket(), "_batch", None)
        return batch is not None and batch.running()

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
                      "lane": self.lane, "tenant": self.tenant,
                      "warm": warm},
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
            self.manager._maybe_checkpoint(self)

    def save(self, store=None) -> bool:
        """Write this session's streaming state (step counter, warm
        start x, status, registered pattern) to the store (``store``, a
        directory or an ArtifactStore, else the manager's).  The
        hierarchy persists through the service's entry export.  False
        (counted) on failure: persistence never raises into a
        stream."""
        return self.manager.save_session(self, store=store)

    def close(self):
        """Finish and deregister (the hierarchy stays cached for other
        sessions)."""
        self.finish()
        self.closed = True
        self.manager._discard(self)


class SessionManager:
    """The streaming sessions of one serve front (a
    :class:`~amgx_tpu_torch.serve.service.BatchedSolveService` or a
    :class:`~amgx_tpu_torch.serve.gateway.SolveGateway`).

    Parameters
    ----------
    front: the service or the :class:`~amgx_tpu_torch.serve.gateway.
        SolveGateway` every step submits through; through a gateway each
        step is admitted as one ticket.
    store: the store of the session manifests (a directory or an
        ArtifactStore; default: the service's own store).
    resetup_every: every N streamed steps of a pattern, refresh its
        cached hierarchy entry with the step's values through
        :meth:`BatchedSolveService.resetup_entry` (0: never; default
        64).  Counted per
        fingerprint: B lockstep sessions share one entry.
    checkpoint_every: save each session's manifest every N resolved
        steps, so :meth:`recover` loses at most N steps (0: never;
        default ``AMGX_TPU_SESSION_CHECKPOINT_EVERY``, 16; nothing is
        saved without a store).
    """

    def __init__(self, front, store=None,
                 resetup_every: int = 64,
                 checkpoint_every: Optional[int] = None):
        from amgx_tpu_torch.serve.gateway import SolveGateway

        if isinstance(front, SolveGateway):
            self.gateway: Optional[SolveGateway] = front
            self.service = front.service
        else:
            self.gateway = None
            self.service = front
        self.store = store if store is not None else self.service.store
        if isinstance(self.store, (str, os.PathLike)):
            from amgx_tpu_torch.store.store import ArtifactStore

            self.store = ArtifactStore(self.store)
        self.checkpoint_every = (
            _env_int("AMGX_TPU_SESSION_CHECKPOINT_EVERY", 16)
            if checkpoint_every is None else int(checkpoint_every))
        self.resetup_every = int(resetup_every)
        self._lock = threading.Lock()
        self._sessions: dict = {}
        self._counters: dict = {}
        self._resetup_s = 0.0
        self._overlap_s = 0.0
        # steps per fingerprint: the entry-refresh cadence follows the
        # entry's traffic, not one session's step count
        self._fp_steps: dict = {}
        self.telemetry_name = get_registry().register("sessions", self)

    # -- counters ------------------------------------------------------

    def _count(self, name: str, by: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def _account_resetup(self, seconds: float, overlapped: bool = False):
        with self._lock:
            self._resetup_s += seconds
            if overlapped:
                self._overlap_s += seconds

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
        overlap seconds, the ``amgx_session_*`` families."""
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
            config=self.service.cfg_key, lane=sess.lane, tenant=sess.tenant,
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
        """Seconds of prestage work that ran while the previous step's
        loop was still running."""
        with self._lock:
            return self._overlap_s

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
        ``deadline_s`` applies to every step's submit; ``tenant`` and
        ``lane`` to every step's ticket."""
        svc = self.service
        ro, ci, vals, n, raw_fp = _host_csr(A, svc.metrics)
        if session_id is None:
            session_id = f"sess-{uuid.uuid4().hex[:12]}"
        sess = SolveSession(self, session_id, (ro, ci, n, raw_fp),
                            dtype if dtype is not None else vals.dtype,
                            tenant, lane, deadline_s=deadline_s)
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
        """One step into the front (the gateway, else the service) by
        the values-only fast path: the registered (ro, ci, n,
        fingerprint) go in as ``_host``, so the submit extracts no CSR
        and hashes no pattern; ``trace`` is the step's sampled context
        (its root is the step's)."""
        host = (sess._ro, sess._ci, values, sess.n, sess.fingerprint)
        front = self.gateway if self.gateway is not None else self.service
        return front.submit(None, b, x0, deadline_s=sess.deadline_s,
                            tenant=sess.tenant, lane=sess.lane,
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
        (self.gateway or self.service).flush()

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

    # -- persistence ---------------------------------------------------

    def _session_key(self, session_id: str, store=None):
        """The one place a session's store key derives (save and
        restore must agree)."""
        st = store if store is not None else self.store
        if st is None:
            raise StoreError("SessionManager has no artifact store")
        return st.entry_key(session_id, self.service.cfg_key,
                            _SESSION_KEY_DTYPE, kind=SESSION_KIND)

    def save_session(self, sess: SolveSession, store=None) -> bool:
        """Write one session's streaming state (manifest and arrays, the
        JAX package's layout).  False (counted) on any failure."""
        st = store if store is not None else self.store
        if isinstance(st, (str, os.PathLike)):
            from amgx_tpu_torch.store.store import ArtifactStore

            st = ArtifactStore(st)
        if st is None:
            self._count("save_failures_total")
            return False
        try:
            arrays = {"row_offsets": np.asarray(sess._ro),
                      "col_indices": np.asarray(sess._ci)}
            if sess._last_x is not None:
                arrays["x"] = np.asarray(sess._last_x)
            manifest = {
                "kind": SESSION_KIND,
                "session_id": sess.session_id,
                "raw_fingerprint": sess.fingerprint,
                "padded_fingerprint": sess._padded_fp,
                "cfg_key": self.service.cfg_key,
                "dtype": str(sess.dtype),
                "n": sess.n,
                "nnz": sess.nnz,
                "step": sess.step_idx,
                "last_status": sess._last_status,
                "last_iterations": sess._last_iters,
                "tenant": sess.tenant,
                "lane": sess.lane,
                "deadline_s": sess.deadline_s,
            }
            key = self._session_key(sess.session_id, store=st)
            ok = st.put(key, arrays, manifest)
        except Exception:  # noqa: BLE001 — persistence never raises
            ok = False
        self._count("saves_total" if ok else "save_failures_total")
        return ok

    def _maybe_checkpoint(self, sess: SolveSession):
        """The ``checkpoint_every`` cadence: save the session after every
        Nth resolved step (the whole payload, the pattern included: the
        store holds one entry per session, overwritten atomically).  A
        failed checkpoint counts and never fails the step."""
        n = self.checkpoint_every
        if n <= 0 or self.store is None or sess.step_idx % n:
            return
        if self.save_session(sess):
            self._count("checkpoints_total")
            self.service.metrics.inc("resilience_checkpoints")
        else:
            self._count("checkpoint_failures_total")

    def recover(self, session_id: str, **kw) -> SolveSession:
        """Resume one session from its last checkpoint (:meth:`restore`)
        and retire the live object: its step in flight is dropped, the
        checkpoint is the resume point.  ``StoreError`` when there is no
        checkpoint; the live session is then left as it was (restore
        runs first)."""
        live = self.get(session_id)
        sess = self.restore(session_id, **kw)
        if live is not None:
            live._abandon_stage()
            live._pending = None
            live.closed = True
        self._count("recoveries_total")
        return sess

    def save_all(self) -> int:
        """Finish and save every open session (the drain protocol);
        returns the number saved."""
        saved = 0
        for sess in self.sessions():
            sess.finish()
            if self.save_session(sess):
                saved += 1
        return saved

    def restore(self, session_id: str, *, tenant: Optional[str] = None,
                lane: Optional[str] = None,
                deadline_s: Optional[float] = None) -> SolveSession:
        """Resume a saved session: its step counter, warm start x,
        status and registered pattern (and its tenant, lane and per-step
        deadline, unless given).  The hierarchy is expected in the
        service's cache (``warm_boot()`` it first), so the resumed
        stream coarsens nothing.  ``StoreError`` (counted in
        ``restore_failures_total``) when the manifest is missing or
        corrupt, or was written under another configuration."""
        if self.store is None:
            self._count("restore_failures_total")
            raise StoreError("SessionManager has no artifact store")
        got = self.store.get(self._session_key(session_id))
        if got is None:
            self._count("restore_failures_total")
            raise StoreError(
                f"no persisted session {session_id!r} for this service's "
                "config")
        manifest, arrays = got
        try:
            if manifest.get("kind") != SESSION_KIND:
                raise StoreError(
                    f"payload kind {manifest.get('kind')!r} is not a solve "
                    "session")
            if manifest.get("cfg_key") != self.service.cfg_key:
                raise StoreError(
                    "session was streamed under a different solver "
                    "configuration")
            host = (np.asarray(arrays["row_offsets"]),
                    np.asarray(arrays["col_indices"]),
                    int(manifest["n"]), str(manifest["raw_fingerprint"]))
            if deadline_s is None:
                dl = manifest.get("deadline_s")
                deadline_s = None if dl is None else float(dl)
            sess = SolveSession(
                self, session_id, host, manifest.get("dtype"),
                tenant if tenant is not None
                else str(manifest.get("tenant", "default")),
                lane if lane is not None
                else str(manifest.get("lane", "interactive")),
                deadline_s=deadline_s)
            sess.step_idx = int(manifest.get("step", 0))
            sess._padded_fp = manifest.get("padded_fingerprint")
            if "x" in arrays:
                sess._last_x = np.array(arrays["x"])
                ls = manifest.get("last_status")
                sess._last_status = None if ls is None else int(ls)
            li = manifest.get("last_iterations")
            sess._last_iters = None if li is None else int(li)
        except StoreError:
            self._count("restore_failures_total")
            raise
        except Exception as e:
            self._count("restore_failures_total")
            raise StoreError(
                f"malformed session manifest for {session_id!r}: {e}"
            ) from e
        if sess._padded_fp is None:
            sess._padded_fp = self.service._pattern_for(
                sess._ro, sess._ci, sess.n, sess.fingerprint).fingerprint
        with self._lock:
            self._sessions[session_id] = sess
        self._count("restores_total")
        self.service.metrics.inc("resilience_restores")
        return sess

    def drain(self) -> dict:
        """A graceful hand-off over the service: flush, finish and save
        every session, and export the hierarchy cache."""
        self.flush()
        saved = self.save_all()
        exported = self.service.export_all_entries()
        return {"sessions_saved": saved, "entries_exported": exported}
