"""Batched solve service: many independent solve requests, solved as a
few batched groups on one device (the JAX package's
``serve/service.py``, its core).

    submit(A, b) --+   group by (padded fingerprint, dtype)
    submit(A, b) --+-> queue --flush--> staging slot (rows padded in place
    submit(A, b) --+   (max_batch /       at submit)
                        max_wait_s)            |
                                               v
                       hierarchy cache: one setup per (pattern, config,
                       dtype), reused for every later coefficient set
                                               |
                                               v
                       batched solve (serve/batched.py), one per
                       template signature: one masked loop for the group
                                               |
                                               v
                       dispatch stage (inline, or the single worker for
                       the poller): ship the rows, release the slot,
                       tickets done(), run the loop
                                               |
                                               v
                       SolveTicket.result(): ONE wait and fetch per
                       group, results per request, unpadded

Solvers without an iteration protocol (GMRES, IDR) run each request in
turn (``fallback_solves``).  Guardrails, as in the
JAX package: non-finite uploads are rejected at submit with a typed
error (``validate``); a group that fails as a unit is quarantined and
every member re-solves alone, so only the poisoned requests fail; a
per-fingerprint circuit breaker bypasses batching for a pattern that
keeps failing, with a half-open probe every ``breaker_probe_every``-th
group; a ticket whose deadline passes fails alone.  The fault site
``serve_compile`` (``core/faults.py``) fails a group after its
hierarchy entry is built and before its batched solve is looked up, so
the group quarantines.

Async pipeline, as in the JAX package: a flush splits into a host stage
(deadlines, the breaker, the hierarchy entry and its batched solve, on
the flushing thread) and a device stage (``_dispatch_batched``: the
staged rows shipped to the device, the slot released, the group handed
to its tickets, then the batched loop).  The poller (``start()``) and
``poll()`` hand the device stage to the process-wide single-worker
dispatch stage (``core/dispatch.py``, ``serve-dispatch``) and go back to
padding, so padding group N+1 overlaps group N on the device.  A flush
(a submit that fills ``max_batch``, ``flush()``, ``solve_many``) hands
it over too on a started service, and returns at the hand-over, as the
JAX package's returns at dispatch; on a service that is not started it
runs the device stage inline.  ``SolveTicket.done()`` is True once
its group is handed over; ``result()`` makes the group's one blocking
wait (``_block_ready``: the worker's future and the CUDA event recorded
after the loop's last launch) and its host fetch (``_fetch_host``), once
for the group, whichever ticket asks first.  The port's loop reads each
iteration's norms on the worker, so ``host_syncs`` counts them and the
fetch (iterations + 2; the JAX package reads once a group), and the
fetch copies nothing more: x stays on the service's device.  Solvers
without a batch rebuild solve each request with ``solve(block=False)``.

Warm boot, as in the JAX package: with ``store=`` (a directory or an
``ArtifactStore``) every hierarchy entry the service builds is exported
on the shared background worker (``serve/cache._compile_pool``), and
:meth:`BatchedSolveService.warm_boot` restores a store's entries of the
service's configuration into the hierarchy cache, so that their first
group is a cache hit (``store/warmboot.py``).

Telemetry, as in the JAX package: the service registers a ``serve``
source in the process registry (``amgx_tpu_torch.telemetry``); its
:class:`FlightRecorder` (``recorder``) keeps one record per solved
ticket (``path`` batched, quarantine or fallback) and an incident per
quarantine, breaker trip and deadline expiry; with request tracing on
(``AMGX_TPU_TRACE_SAMPLE``) a sampled ticket's spans are ``submit``
(its root), ``pad``, ``queue``, ``dispatch``, ``device`` and ``fetch``,
and each batched group with a sampled member records one ``flush_group``
span naming its members (spans recorded on the dispatch worker carry
the ticket's trace context).  Telemetry failures (the
``telemetry_export`` site) count ``telemetry_errors`` and never fail a
solve.  A group's ``dispatch`` stage runs from its flush to the
hand-over, its ``device`` stage from there to the end of the fetch's
wait (an upper bound when the fetch comes late), ``fetch`` after it.

Priority lanes and tenants, as in the JAX package: ``submit(lane=,
tenant=)`` (``interactive`` and ``default`` unless named); groups never
mix lanes (the group key is (padded fingerprint, dtype, lane)), a flush
takes interactive groups first, ``poll()`` defers due batch groups while
an interactive one is due (``batch_deferrals``), and a batch group
passed over for ``_BATCH_AGING_FACTOR`` x ``max_wait_s`` gains
interactive rank (``batch_promotions``).  The admission-controlled door
in front of a service is :mod:`amgx_tpu_torch.serve.gateway`.

Failure domains, as in the JAX package: every group is placed through
``placement.plan`` (``serve/placement``: the one device of
``SingleDevicePolicy``).  With ``failover`` (default on,
``AMGX_TPU_FAILOVER``) a flush keeps a host copy of its batched values,
b and x0, taken before the staging slot goes back to the pool.  A device
lost at dispatch (the ``device_lost_dispatch`` site) replans once and
ships the still-staged rows again (``_failover_replan``); one lost at
the fetch (``device_lost_fetch``), one whose loop raised a CUDA runtime
error (``_classify_device_loss``: ``torch.cuda.OutOfMemoryError`` and
plain exceptions keep the quarantine path), and one whose fetch outran
the watchdog re-dispatch the group once from that copy
(``_failover_refetch``); a second loss settles every groupmate with a
typed ``DeviceLostError``.  The watchdog (``fetch_watchdog_s``, default
``AMGX_TPU_FETCH_WATCHDOG_S``, 120 s, and never below 25 x the p99 of
the warm groups' loop seconds; <= 0 waits inline) waits for a group on a daemon
thread (``_DaemonFetchPool``), so a hung card never blocks ``result()``
(the ``fetch_hang`` site sleeps there).  The port's loop reads a norm
each iteration, so the requeue's loop runs on a fetch-pool thread and
the fetching thread waits for it under the watchdog; when the fire
finds the group's loop itself still running on the dispatch worker,
later groups go to a fresh worker (``core/dispatch.abandon_worker``).
Buffer donation (``donate=``: torch has none) raises
``NotImplementedError``, and so do the multi-device placements
(ROADMAP.md, queue A.9).  Scalar (block_size 1) systems only, as in the
JAX package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
import re
import threading
import time
from typing import Optional

import numpy as np
import torch

from amgx_tpu_torch.config.amg_config import AMGConfig
from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.device import resolve_device
from amgx_tpu_torch.core.dispatch import abandon_worker
from amgx_tpu_torch.core.dispatch import dispatch_pool as _dispatch_pool
from amgx_tpu_torch.core.dispatch import on_dispatch_worker
from amgx_tpu_torch.core.errors import (
    AMGXTPUError,
    DeviceLostError,
    ResourceError,
)
from amgx_tpu_torch.core.matrix import SparseMatrix, sparsity_fingerprint
from amgx_tpu_torch.core.types import torch_dtype
from amgx_tpu_torch.serve.batched import make_batched_solve
from amgx_tpu_torch.serve.bucketing import (
    PaddedPattern,
    StagingSlot,
    bucket_batch,
    pad_pattern,
)
from amgx_tpu_torch.serve.cache import (
    CompileCache,
    HierarchyCache,
    HierarchyEntry,
    _compile_pool,
    config_hash,
    template_signature,
)
from amgx_tpu_torch.core.profiling import trace_range
from amgx_tpu_torch.serve.metrics import ServeMetrics
from amgx_tpu_torch.serve.placement import (
    breaker_probe_every as _probe_cadence,
)
from amgx_tpu_torch.serve.placement import resolve_placement
from amgx_tpu_torch.solvers.base import PendingSolveResult, SolveResult
from amgx_tpu_torch.telemetry import (
    FlightRecorder,
    SolveRecord,
    get_registry,
    telemetry_enabled,
    tracing,
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _host_csr(A, metrics=None):
    """(row_offsets, col_indices, values, n, raw fingerprint) host
    arrays of a SparseMatrix or a scipy sparse matrix; scalar matrices
    only.  A scipy matrix's fingerprint is memoized on it, so callers
    that change its index arrays in place after a submit must pass a
    new matrix.  Each fingerprint computed (not read from a memo)
    counts in ``metrics``' ``pattern_hashes``."""
    if isinstance(A, SparseMatrix):
        if A.block_size != 1:
            raise ValueError(
                "BatchedSolveService: scalar (block_size == 1) systems "
                "only")
        ro, ci, v = A._host
        if metrics is not None and getattr(
                A, "_fingerprint_cache", None) is None:
            metrics.inc("pattern_hashes")
        return ro, ci, v, A.n_rows, A.fingerprint()
    try:
        sp = A.tocsr()
    except AttributeError:
        raise TypeError(
            f"expected SparseMatrix or scipy sparse matrix, got "
            f"{type(A).__name__}") from None
    sp.sort_indices()
    fp = getattr(sp, "_amgx_tpu_fp", None)
    if fp is None:
        if metrics is not None:
            metrics.inc("pattern_hashes")
        fp = sparsity_fingerprint(sp.indptr, sp.indices, sp.shape[0],
                                  sp.shape[1], 1)
        try:
            sp._amgx_tpu_fp = fp
        except AttributeError:
            pass
    return sp.indptr, sp.indices, sp.data, sp.shape[0], fp


def _resolve_dtype(dt) -> np.dtype:
    """The service dtype of an upload: integers promote to f64."""
    rdt = np.dtype(dt)
    if not np.issubdtype(rdt, np.inexact):
        rdt = np.dtype(np.float64)
    return rdt


# the service's stock configuration (PCG + BLOCK_JACOBI)
DEFAULT_CONFIG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 200, "tolerance": 1e-8,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "jac", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.9, "max_iters": 2,'
    ' "monitor_residual": 0}}}'
)

# s-step PCG over an aggregation AMG V-cycle smoothed by the
# fourth-kind Chebyshev polynomial (the JAX package's recommended serve
# configuration); a group runs as one batch
COMM_AVOIDING_CONFIG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "SSTEP_PCG", "s_step": 4, "max_iters": 200,'
    ' "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "sm", "solver": "OPT_POLYNOMIAL",'
    ' "chebyshev_polynomial_order": 2, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 32, "max_levels": 10,'
    ' "structure_reuse_levels": -1,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)

# the cheap-preconditioner configuration: an f32 AMG hierarchy with an
# INEXACT coarse solve inside f64 ITERATIVE_REFINEMENT; a group runs as
# one batch (the cycle on the f32 levels, PCG's operator and the outer
# residual in f64), and a batched instance that ends non-SUCCESS keeps
# its status: the precision guardrail re-solves only requests solved
# alone (quarantine, the breaker), as in the JAX package
CHEAP_PRECONDITIONER_CONFIG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "ITERATIVE_REFINEMENT", "max_iters": 40,'
    ' "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI", "precision_fallback": 1,'
    ' "preconditioner": {"scope": "inner", "solver": "PCG",'
    ' "max_iters": 8, "monitor_residual": 0,'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "hierarchy_dtype": "FLOAT32", "level_dtype_policy": "ALL",'
    ' "smoother": {"scope": "sm", "solver": "OPT_POLYNOMIAL",'
    ' "chebyshev_polynomial_order": 2, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 32, "max_levels": 10,'
    ' "structure_reuse_levels": -1,'
    ' "coarse_solver": "INEXACT",'
    ' "inexact_coarse_solver": "OPT_POLYNOMIAL", "cycle": "V",'
    ' "monitor_residual": 0}}}}'
)


def _block_ready(inflight):
    """The group's one blocking wait: the dispatch stage's future (the
    batched loop's result and the CUDA event recorded after its last
    launch), then that event.  A module hook, so that tests count that
    it runs once a group."""
    res, event = inflight.result()
    if event is not None:
        event.synchronize()
    return res


def _run_loop(device, fn, *args):
    """Run a group's batched loop ``fn(*args)``: (its result, the CUDA
    event recorded after its last launch (None off the card), its clock
    for :meth:`_BatchResult.loop_s`).  On the card the clock is a pair
    of timing events around the launches, so a fetch that comes late
    adds nothing to it.  Off the card it is the smaller of the loop's
    wall seconds and this process's CPU seconds over it, so that a host
    that runs other processes meanwhile does not lengthen it."""
    start = end = None
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0, c0 = time.perf_counter(), time.process_time()
    res = fn(*args)
    host_s = min(time.perf_counter() - t0, time.process_time() - c0)
    if start is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    return res, end, (start, end, host_s)


def _fetch_host(res):
    """The group's host fetch, the second half of its one sync (a hook
    the tests count): the loop has already read every host field
    (iterations, statuses, norms, history) on its way, and x stays on
    the service's device, where the port's results keep it; so nothing
    more is copied."""
    return res


class _DaemonFetchPool:
    """Daemon threads for the watchdog's waits (the JAX package's
    ``_DaemonFetchPool``): a group's blocking wait runs here so that the
    fetching caller can give up at the watchdog.  Not a
    ``ThreadPoolExecutor``, whose workers are joined at interpreter exit:
    one truly hung wait would hold the exit.  A stuck worker is
    abandoned and the pool grows around it, up to ``max_workers``;
    workers are reused."""

    def __init__(self, max_workers: int = 32):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._workers = 0
        self._idle = 0
        self._max = int(max_workers)

    def submit(self, fn) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((fn, fut))
        with self._lock:
            if self._idle == 0 and self._workers < self._max:
                self._workers += 1
                threading.Thread(target=self._loop,
                                 name=f"serve-fetch-{self._workers}",
                                 daemon=True).start()
        return fut

    def _loop(self):
        while True:
            with self._lock:
                self._idle += 1
            fn, fut = self._q.get()
            with self._lock:
                self._idle -= 1
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — to the waiter
                fut.set_exception(e)


_FETCH_POOL: Optional[_DaemonFetchPool] = None
_FETCH_POOL_LOCK = threading.Lock()


def _fetch_pool() -> _DaemonFetchPool:
    global _FETCH_POOL
    with _FETCH_POOL_LOCK:
        if _FETCH_POOL is None:
            _FETCH_POOL = _DaemonFetchPool(max_workers=32)
        return _FETCH_POOL


# a RuntimeError whose message names a CUDA runtime failure (a torch
# built without AcceleratorError raises these as plain RuntimeErrors)
_CUDA_ERROR = re.compile(
    r"CUDA( \w+)? error|cudaError|CUBLAS_STATUS|CUSPARSE_STATUS"
    r"|illegal memory access|device-side assert|launch failure"
    r"|unspecified launch|ECC error|device not ready|GPU is lost")


def _outcome(k: int):
    """The ``k``-th request's outcome in a fallback group's settled
    list (:meth:`BatchedSolveService._fallback_settled`): its result,
    or its error raised."""

    def pick(outcomes):
        out = outcomes[k]
        if isinstance(out, BaseException):
            raise out
        return out

    return pick


@dataclasses.dataclass
class SolveTicket:
    """Handle returned by submit().  ``done()`` never blocks: it is
    True once the ticket's group was handed to the device stage, or the
    ticket settled alone; the result may still be in flight.
    ``result()`` flushes the group if needed, makes the group's one
    blocking wait (shared with every groupmate, whichever asks first)
    and returns this request's SolveResult (x on the service's device,
    unpadded), or raises its typed error."""

    _service: "BatchedSolveService"
    _group_key: tuple
    _row: int = 0
    _result: object = None
    _done: bool = False
    _error: Optional[BaseException] = None
    _batch: object = None  # _BatchResult once the group ran batched
    _deadline: Optional[float] = None  # absolute monotonic, or None
    _t_submit: float = 0.0  # perf_counter at submit
    _pad_s: float = 0.0  # seconds writing the staging row
    _trace: object = None  # the sampled trace context, or None
    _lane: str = "interactive"
    _tenant: str = "default"  # the gateway's, or "default" direct
    # concurrent result() calls on one ticket settle consistently
    _rlock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def done(self) -> bool:
        return self._done

    def result(self) -> SolveResult:
        if not self._done:
            self._service._flush_group_of(self)
        with self._rlock:
            if self._error is not None:
                raise self._error
            if self._result is None and self._batch is not None:
                # a deadline that passed before the group's results were
                # fetched fails this ticket (sticky), not the group
                if (self._deadline is not None
                        and not self._batch.fetched()
                        and time.monotonic() > self._deadline):
                    from amgx_tpu_torch.core.errors import (
                        DeadlineExceededError,
                    )

                    self._service.metrics.inc("deadline_expired_fetch")
                    self._error = DeadlineExceededError(
                        "serve deadline exceeded before the result was "
                        "fetched")
                    self._batch = None
                    self._service._flight_incident(
                        "deadline_expired",
                        detail="fetch-boundary short-circuit")
                    raise self._error
                self._result = self._batch.result_for(self)
            if isinstance(self._result, PendingSolveResult):
                # a sequential solve(block=False): its error raises here
                self._result._settle()
            return self._result


@dataclasses.dataclass
class _Request:
    ticket: SolveTicket
    row: int  # staging-slot row owned by this request
    deadline: Optional[float] = None
    # the row write finished (writes happen outside the service lock)
    ready: bool = False


@dataclasses.dataclass
class _Group:
    key: tuple  # (padded fingerprint, dtype str, lane)
    pattern: PaddedPattern
    dtype: np.dtype
    requests: list
    deadline: float  # monotonic max-wait flush time
    slot: Optional[StagingSlot]
    lane: str = "interactive"
    created: float = 0.0  # monotonic creation time (aging)
    promoted: bool = False  # the batch aging credit, once given


class _BatchResult:
    """One dispatched batched group: ``inflight`` is the future of its
    loop's (result, CUDA event).  ``fetch()`` makes the group's one
    blocking wait (``_block_ready``, under the service's watchdog) and
    host fetch (``_fetch_host``), once, whichever ticket asks first, and
    records the group's metrics, latency stages, spans and flight
    records; ``result_for`` cuts a ticket's row out.  The ``device``
    stage runs from the hand-over to the end of that wait, measured at
    fetch: an upper bound when the fetch comes late (a watcher waiting at
    completion would be a second sync a group, which the one-sync
    contract rules out).  A group whose loop failed settles its future
    with None after its quarantine: each ticket then holds its own
    outcome.  A device lost after dispatch re-dispatches the group once
    from ``retry`` (the host copy of its batched arrays, with
    ``failover``); a failure that stays settles every groupmate with the
    same typed error."""

    def __init__(self, service, inflight, pattern, tickets, Bb, t_flush,
                 t_dispatch, plan=None, entry=None, retry=None, cold=False):
        self._service = service
        self.inflight = inflight
        self.res = None
        self.pattern = pattern
        self.tickets = tickets
        self.Bb = Bb
        self.t_flush = t_flush
        self.t_dispatch = t_dispatch
        self.plan = plan  # the placement GroupPlan (fetch accounting)
        # failover: the hierarchy entry and the retained host payload a
        # device-lost group re-dispatches from, once
        self.entry = entry
        self.retry = retry
        # the first group of its batched solve: its seconds stay out of
        # the watchdog's reservoir
        self.cold = cold
        # the loop's own clock (start event, end event, host seconds),
        # set where the loop runs (:func:`_run_loop`)
        self.loop_clock = None
        self.requeued = False
        self._lock = threading.Lock()
        self._fetched = False
        self._error = None

    def fetched(self) -> bool:
        with self._lock:
            return self._fetched

    def running(self) -> bool:
        """Is the group's loop still running: its future unsettled (the
        loop on the dispatch worker), or its CUDA event not reached?  A
        group run inline has ended when its flush returns."""
        fut = self.inflight
        if fut is None:
            return False
        if not fut.done():
            return True
        if fut.exception() is not None:
            return False
        event = fut.result()[1]
        return event is not None and not event.query()

    def loop_s(self):
        """The batched loop's own seconds, after the wait: the card's
        time between the events recorded around its launches, or off the
        card the host's (:func:`_run_loop`); None where it did not run."""
        clock = self.loop_clock
        if clock is None:
            return None
        start, end, host_s = clock
        if start is None:
            return host_s
        return start.elapsed_time(end) / 1e3

    def _sync_once(self):
        """One attempt at the group's wait and fetch: the
        ``device_lost_fetch`` site, then the watched wait, then the host
        fetch.  Returns (result or None, t_done); raises a typed
        ``DeviceLostError`` on an injected loss or a watchdog fire."""
        label = self.plan.device_label if self.plan is not None else None
        if faults.should_fire("device_lost_fetch"):
            raise DeviceLostError(
                "injected device loss at fetch (fault site "
                "device_lost_fetch)", device_label=label)
        res = self._service._watched_block(self.inflight, label)
        t_done = time.perf_counter()
        return (None if res is None else _fetch_host(res)), t_done

    def fetch(self):
        with self._lock:
            if self._fetched:
                return self.res
            if self._error is not None:
                raise self._error
            svc = self._service
            m = svc.metrics
            try:
                res, t_done = self._sync_once()
            except BaseException as e:  # noqa: BLE001 — settled typed
                res, t_done = self._failed(e)
            self.inflight = None
            # settled: the failover payload and the entry are dead weight
            self.retry = None
            self.entry = None
            self._fetched = True
            if res is None:
                # the loop failed and the group went through the
                # quarantine
                if self.plan is not None:
                    self.plan.abandon()
                return None
            self.res = res
            # the loop's norm reads and this wait
            m.inc("host_syncs", self.res.host_reads + 1)
            device_s = max(t_done - self.t_dispatch, 0.0)
            dispatch_s = self.t_dispatch - self.t_flush
            if self.plan is not None:
                try:
                    self.plan.on_fetch(res, device_s)
                except Exception:  # noqa: BLE001 — placement telemetry
                    m.inc("telemetry_errors")
            pat = self.pattern
            m.add_time("device_busy_s", device_s)
            loop_s = None if self.cold else self.loop_s()
            if loop_s is not None:
                m.record_watchdog(loop_s)
            m.record_batch((pat.nb, pat.nnzb, self.Bb), device_s,
                           len(self.tickets), self.Bb - len(self.tickets))
            m.inc("solved", len(self.tickets))
            m.inc("padded_elems", self.Bb * pat.nb)
            m.inc("real_elems", len(self.tickets) * pat.n)
            t_fetch = time.perf_counter()
            m.add_time("host_busy_s", t_fetch - t_done)
            self._observe(device_s, dispatch_s, t_done, t_fetch)
            return self.res

    def _failed(self, e):
        """The group's wait raised (caller holds the lock): a device
        loss (typed, or a CUDA runtime error classified as one) tries
        the one-shot requeue, whose (result, t_done) is returned; any
        other failure, or a failed requeue, settles the group with one
        typed error, raised here."""
        svc = self._service
        label = self.plan.device_label if self.plan is not None else None
        dl = svc._classify_device_loss(e, label)
        if dl is not None:
            e = dl
            try:
                return svc._failover_refetch(self, e)
            except BaseException as e2:  # noqa: BLE001
                if not isinstance(e2, Exception):
                    raise  # Ctrl-C and SystemExit propagate
                if isinstance(e2, AMGXTPUError):
                    e = e2
                elif e.__cause__ is None:
                    e.__cause__ = e2
                else:
                    # the device failure stays the cause; the requeue's
                    # error rides along
                    e.requeue_error = e2
        if isinstance(e, AMGXTPUError):
            err = e
        else:
            err = ResourceError("batched group execution failed after "
                                f"dispatch: {type(e).__name__}: {e}")
            err.__cause__ = e
        self._error = err
        self.inflight = None
        self.retry = None
        self.entry = None
        svc.metrics.inc("failed_groups")
        if self.plan is not None:
            try:
                self.plan.abandon()
            except Exception:  # noqa: BLE001 — never masks the failure
                svc.metrics.inc("telemetry_errors")
        if (not isinstance(err, DeviceLostError)
                or getattr(err, "inferred", False)):
            # a certain device loss (injected, the watchdog) is not the
            # pattern's fault; an inferred one charges its breaker too
            svc._breaker_failure(self.pattern.fingerprint)
        raise err

    def _observe(self, device_s, dispatch_s, t_done, t_fetch):
        """Each ticket's latency stages, spans and flight record, and
        each ticket's even share of the group's device seconds against
        its tenant and lane (summed per pair: one metrics lock a
        pair)."""
        svc = self._service
        m = svc.metrics
        rec_on = telemetry_enabled()
        share = device_s / len(self.tickets)
        tenant_shares: dict = {}
        if rec_on:
            # shared or vectorised once: the loop only builds records
            ts_now = time.time()
            iters_l = np.asarray(self.res.iters).tolist()
            status_l = np.asarray(self.res.status).tolist()
            fn = np.asarray(self.res.final_norm)
            fn_max = fn.reshape(fn.shape[0], -1).max(axis=1)
            recs = []
        for t in self.tickets:
            total = max(t_fetch - t._t_submit, 0.0)
            stages = {
                "queue": max(self.t_flush - t._t_submit - t._pad_s, 0.0),
                "pad": t._pad_s,
                "dispatch": dispatch_s,
                "device": device_s,
                "fetch": t_fetch - t_done,
                "total": total,
            }
            m.record_ticket(stages)
            m.record_lane(t._lane, total)
            tk = (t._tenant, t._lane)
            tenant_shares[tk] = tenant_shares.get(tk, 0.0) + share
            ctx = t._trace
            if ctx is not None:
                tracing.record_span("queue", t._t_submit + t._pad_s,
                                    self.t_flush, ctx)
                tracing.record_span("device", self.t_dispatch, t_done, ctx)
                tracing.record_span("fetch", t_done, t_fetch, ctx)
            if rec_on:
                i = t._row
                recs.append(SolveRecord(
                    ts=ts_now, fingerprint=self.pattern.fingerprint,
                    config=svc.cfg_key, lane=t._lane, tenant=t._tenant,
                    iterations=iters_l[i],
                    final_residual=float(fn_max[i]),
                    status=status_l[i], stages=stages, path="batched",
                    trace_id=ctx.trace_id if ctx is not None else None,
                ))
        for (tn, ln), sec in tenant_shares.items():
            m.record_tenant_device(tn, ln, sec)
        if rec_on and recs:
            svc._flight_record_many(recs)

    def result_for(self, ticket: SolveTicket) -> SolveResult:
        res = self.fetch()
        if res is None:
            # quarantined after the hand-over: the ticket's own outcome
            if ticket._error is not None:
                raise ticket._error
            return ticket._result
        i, n = ticket._row, self.pattern.n
        return SolveResult(
            x=res.x[i, :n].clone(),
            iters=int(res.iters[i]),
            status=int(res.status[i]),
            final_norm=res.final_norm[i],
            initial_norm=res.initial_norm[i],
            history=res.history[i],
        )


class BatchedSolveService:
    """Shape-bucketed batched multi-system solver front end.

    Parameters
    ----------
    config: AMGConfig, JSON / key-value string or None (DEFAULT_CONFIG):
        the configuration every request shares.
    max_batch: flush a group when it reaches this many requests.
    max_wait_s: flush a group this long after its first request
        (enforced by poll() and flush(); start() runs a poller).
    queue_limit: bound on queued requests; reaching it flushes all.
    cache_entries: hierarchy-cache capacity (LRU).
    validate: reject non-finite uploads at submit() with a typed
        ``NonFiniteValuesError`` (``validation_rejects``).
    breaker_threshold: consecutive group failures of one pattern after
        which its requests bypass batching (``breaker_trips`` /
        ``breaker_bypasses``); 0 disables the breaker.
    breaker_probe_every: every this-many-th group of an open-breaker
        pattern is a half-open probe whose success closes it (None:
        ``AMGX_TPU_BREAKER_PROBE_EVERY``, default 8; the device breakers
        of ``serve/placement`` share it).
    device: ``"cuda"`` (the default; raises without a card) or
        ``"cpu"``, where the kernels' plain versions run.
    store: the setup-artifact store of warm-boot serving (a directory
        or an :class:`~amgx_tpu_torch.store.ArtifactStore`): every
        hierarchy entry the service builds is exported to it in the
        background, and :meth:`warm_boot` fills the hierarchy cache
        from it.  The JAX package also points XLA's compile cache there;
        the port's kernel cache is the ``_build/`` directory of the
        checkout.
    placement: a :class:`~amgx_tpu_torch.serve.placement.PlacementPolicy`,
        a spec string or None (``AMGX_TPU_PLACEMENT``; unset: single
        device).  The multi-device specs raise ``NotImplementedError``
        (ROADMAP.md, queue A.9).
    fetch_watchdog_s: the bound on a group's one blocking wait; past it
        the fetch settles with a typed ``DeviceLostError`` and the group
        requeues once.  None: ``AMGX_TPU_FETCH_WATCHDOG_S`` (default
        120); <= 0 waits inline.  Never below 25 x the p99 of the warm
        groups' loop seconds (:meth:`watchdog_s`).
    failover: keep a host copy of each flushed group's batched values,
        b and x0 (freed at its fetch), so that a device lost after
        dispatch requeues the group once; without it such a loss
        settles every groupmate typed.  None: ``AMGX_TPU_FAILOVER``
        (default on).
    """

    def __init__(self, config=None, max_batch: int = 32,
                 max_wait_s: float = 0.02, queue_limit: int = 1024,
                 cache_entries: int = 64, validate: bool = True,
                 breaker_threshold: int = 3,
                 breaker_probe_every: Optional[int] = None,
                 device="cuda", *, donate=None, store=None,
                 placement=None, fetch_watchdog_s=None, failover=None):
        if donate is not None:
            raise NotImplementedError(
                "BatchedSolveService(donate=...): buffer donation (torch "
                "has none) is not ported")
        self.device = resolve_device(device)
        if config is None:
            config = DEFAULT_CONFIG
        if isinstance(config, str):
            config = AMGConfig.from_string(config)
        self.cfg = config
        self.cfg_key = config_hash(config)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.queue_limit = int(queue_limit)
        self.validate = bool(validate)
        self.breaker_threshold = int(breaker_threshold)
        # the half-open cadence of the fingerprint breaker and the
        # placement's device breakers: the parameter, then the
        # environment, then 8
        self.breaker_probe_every = _probe_cadence(breaker_probe_every)
        self.fetch_watchdog_s = (
            _env_float("AMGX_TPU_FETCH_WATCHDOG_S", 120.0)
            if fetch_watchdog_s is None else float(fetch_watchdog_s))
        self.failover = (os.environ.get("AMGX_TPU_FAILOVER", "1") != "0"
                         if failover is None else bool(failover))
        self.placement = resolve_placement(placement)
        if (breaker_probe_every is not None
                and getattr(self.placement, "health", None) is not None):
            # an explicit parameter governs the device breakers too
            self.placement.health.probe_every = self.breaker_probe_every
        self.metrics = ServeMetrics()
        # the flight recorder: its incident snapshots read this
        # service's metrics
        self.recorder = FlightRecorder(snapshot_fn=self.metrics.snapshot)
        self.cache = HierarchyCache(
            max_entries=cache_entries, metrics=self.metrics,
            on_evict=self._on_hierarchy_evict)
        self.compile_cache = CompileCache(metrics=self.metrics)
        self.store = None
        self._store_futures: list = []
        if store is not None:
            from amgx_tpu_torch.store.store import ArtifactStore

            self.store = (store if isinstance(store, ArtifactStore)
                          else ArtifactStore(store))
        self._lock = threading.RLock()
        self._groups: dict = {}
        self._queued = 0
        self._patterns: dict = {}
        self._staging: dict = {}
        # template signature -> batch bucket of its last flush (a
        # restored entry's build target)
        self._last_bucket: dict = {}
        self._poller: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # circuit breaker: padded fingerprint -> consecutive failures
        self._fail_counts: dict = {}
        self._broken: set = set()
        self._bypass_counts: dict = {}
        # the registry holds a weak reference: registering never extends
        # the service's lifetime
        self.telemetry_name = get_registry().register("serve", self)

    # ------------------------------------------------------------------
    # telemetry

    def telemetry_snapshot(self) -> dict:
        """Registry source (kind ``serve``): the metrics snapshot and the
        hierarchy cache's resident bytes by dtype and by format."""
        snap = self.metrics.snapshot()
        try:
            snap["hierarchy_bytes"] = self.cache.bytes_by_dtype()
            snap["hierarchy_format_bytes"] = self.cache.bytes_by_format()
        except Exception:  # noqa: BLE001 — telemetry never fails
            pass
        return snap

    def _flight_record(self, **fields):
        """One solve into the flight recorder; a failure (the
        ``telemetry_export`` fault included) counts ``telemetry_errors``
        and never fails the solve."""
        try:
            self.recorder.record(**fields)
        except Exception:  # noqa: BLE001 — degrade, never raise
            self.metrics.inc("telemetry_errors")

    def _flight_record_many(self, recs):
        """A group's records in one append; a failure counts one
        ``telemetry_errors`` for each record lost."""
        try:
            self.recorder.extend(recs)
        except Exception:  # noqa: BLE001 — degrade, never raise
            self.metrics.inc("telemetry_errors", len(recs))

    def _flight_incident(self, kind: str, detail: str = ""):
        """One incident (quarantine, breaker trip, deadline expiry),
        under the same degrade contract."""
        if not telemetry_enabled():
            return
        try:
            self.recorder.incident(kind, detail=detail)
        except Exception:  # noqa: BLE001 — degrade, never raise
            self.metrics.inc("telemetry_errors")

    # ------------------------------------------------------------------
    # submission

    # a front end (a session's step) that already made the sampling
    # decision passes its context, possibly None
    _TRACE_UNSET = object()

    def submit(self, A, b, x0=None, deadline_s=None,
               lane: str = "interactive", tenant: str = "default", *,
               _host=None, _trace=_TRACE_UNSET) -> SolveTicket:
        """Queue one system and return its ticket.  ``A`` is a
        SparseMatrix or a scipy sparse matrix (block size 1), ``b`` and
        ``x0`` host arrays.  ``deadline_s`` (seconds from now): an
        expired one is refused here with ``DeadlineExceededError``; one
        that passes while queued fails this ticket at flush, and one
        that passes before the group's results are fetched fails it at
        ``result()``; the group goes on either way.

        ``_host``: ``(row_offsets, col_indices, values, n, raw
        fingerprint)`` of a pattern registered before (a streaming
        session's step, ``amgx_tpu_torch.sessions``); ``A`` is then
        ignored, and the submit extracts no CSR and hashes no
        pattern; ``_trace``: its sampled trace context (the session
        step's root), so this submit records no root of its own.

        ``lane`` (``interactive`` or ``batch``) is the priority lane:
        groups never mix lanes, a flush takes interactive groups first,
        and a batch group passed over for ``_BATCH_AGING_FACTOR`` x
        ``max_wait_s`` gains interactive rank (``batch_promotions``).
        ``tenant`` labels the ticket's records and device seconds."""
        t_submit = time.perf_counter()
        ctx = tracing.new_trace() if _trace is self._TRACE_UNSET else _trace
        if deadline_s is not None and float(deadline_s) <= 0.0:
            from amgx_tpu_torch.core.errors import DeadlineExceededError

            self.metrics.inc("deadline_expired")
            self._flight_incident("deadline_expired",
                                  detail="dead on arrival at submit")
            raise DeadlineExceededError(
                f"deadline_s={float(deadline_s):g} already expired at "
                "submit")
        ro, ci, vals, n, raw_fp = (_host if _host is not None
                                   else _host_csr(A, self.metrics))
        if self.validate:
            from amgx_tpu_torch.core.errors import NonFiniteValuesError

            bad = not np.all(np.isfinite(vals))
            bad = bad or (b is not None
                          and not np.all(np.isfinite(np.asarray(b))))
            bad = bad or (x0 is not None
                          and not np.all(np.isfinite(np.asarray(x0))))
            if bad:
                self.metrics.inc("validation_rejects")
                raise NonFiniteValuesError(
                    "BatchedSolveService.submit: system contains NaN/Inf "
                    "(validation reject)")
        pattern = self._pattern_for(ro, ci, n, raw_fp)
        dtype = _resolve_dtype(vals.dtype)
        key = (pattern.fingerprint, str(dtype), lane)
        flush_now = []
        with self._lock:
            now = time.monotonic()
            grp = self._groups.get(key)
            if grp is None:
                grp = _Group(key=key, pattern=pattern, dtype=dtype,
                             requests=[], deadline=now + self.max_wait_s,
                             slot=self._acquire_slot(key, pattern, dtype),
                             lane=lane, created=now)
                self._groups[key] = grp
            ticket = SolveTicket(_service=self, _group_key=key,
                                 _row=len(grp.requests),
                                 _t_submit=t_submit, _trace=ctx,
                                 _lane=lane, _tenant=tenant)
            if deadline_s is not None:
                ticket._deadline = now + float(deadline_s)
            req = _Request(ticket=ticket, row=ticket._row,
                           deadline=ticket._deadline)
            grp.requests.append(req)
            self._queued += 1
            self.metrics.inc("submitted")
            self.metrics.set_gauge("queue_depth", self._queued)
            if len(grp.requests) >= self.max_batch:
                flush_now.append(self._take_group(key))
            elif self._queued >= self.queue_limit:
                # flush all, interactive groups first
                flush_now.extend(self._take_group(k)
                                 for k in self._ordered_keys(now))
        # pad the request into its staging row outside the lock (the
        # row is this thread's until the group flushes)
        t0 = time.perf_counter()
        try:
            # spans recorded inside attribute to this request's trace
            with tracing.use_context(ctx), trace_range("serve_submit"):
                grp.slot.write_row(req.row, vals, b, x0)
        except BaseException as e:
            # a malformed request fails only its own ticket; groups
            # already taken for flushing still run
            ticket._error = e
            ticket._done = True
            req.ready = True
            for g in flush_now:
                self._execute_group(g)
            raise
        req.ready = True
        ticket._pad_s = time.perf_counter() - t0
        self.metrics.profile.add("pad", ticket._pad_s)
        if ctx is not None:
            tracing.record_span("pad", t0, t0 + ticket._pad_s, ctx)
            if _trace is self._TRACE_UNSET:
                # a direct submit is its trace's root
                tracing.record_span(
                    "submit", t_submit, time.perf_counter(), ctx,
                    args={"lane": lane, "tenant": tenant}, root=True)
        for g in flush_now:
            self._execute_group(g)
        return ticket

    def solve_many(self, systems):
        """Submit every (A, b[, x0]) tuple, flush, and return the
        SolveResults in order."""
        tickets = [self.submit(*sys) for sys in systems]
        self.flush()
        return [t.result() for t in tickets]

    def prewarm(self, A, batch: Optional[int] = None):
        """Build (or find) the hierarchy entry of ``A``'s pattern and its
        batched solve for the ``batch`` bucket (default max_batch) on
        the shared background worker, so the pattern's first flush finds
        both (``prewarms`` / ``prewarm_failures``).  Returns the job's
        future."""
        ro, ci, vals, n, raw_fp = _host_csr(A, self.metrics)
        pattern = self._pattern_for(ro, ci, n, raw_fp)
        dtype = _resolve_dtype(vals.dtype)
        Bb = bucket_batch(self.max_batch if batch is None else batch)
        vals = np.asarray(vals).copy()

        def job():
            self._enter_device()
            try:
                entry = self.cache.get_or_build(
                    pattern, self.cfg_key, dtype,
                    lambda: self._build_entry(pattern, vals, dtype))
                if entry.batch_fn is not None:
                    self.placement.warm(self, entry, Bb)
                self.metrics.inc("prewarms")
            except Exception:  # noqa: BLE001 — a warm-up is best-effort
                self.metrics.inc("prewarm_failures")

        return _compile_pool().submit(job)

    # ------------------------------------------------------------------
    # the setup-artifact store (warm-boot serving, store/warmboot.py)

    def _export_entry(self, entry: HierarchyEntry, dtype):
        """Export a freshly built entry to the store on the background
        worker (never on a flush path).  Best-effort: a failure counts
        ``store_export_failures`` and raises nothing."""
        if self.store is None:
            return

        def job():
            try:
                from amgx_tpu_torch.store.warmboot import export_entry

                ok = export_entry(self, entry, dtype)
                self.metrics.inc("store_exports" if ok
                                 else "store_export_failures")
            except Exception:  # noqa: BLE001 — never a serve fault
                self.metrics.inc("store_export_failures")

        with self._lock:
            self._store_futures = [f for f in self._store_futures
                                   if not f.done()]
            self._store_futures.append(_compile_pool().submit(job))

    def flush_store(self, timeout: Optional[float] = None):
        """Wait until every scheduled export has settled (tests and an
        orderly shutdown; the serve path never calls it)."""
        with self._lock:
            futures, self._store_futures = self._store_futures, []
        for f in futures:
            f.result(timeout=timeout)

    def export_all_entries(self) -> int:
        """Export every cached hierarchy entry now (a drain: the hot
        patterns must be on disk before a replacement boots), after the
        background exports have settled, so that an entry already on
        disk is skipped (``store_export_skips``).  Returns the number on
        disk; 0 without a store."""
        if self.store is None:
            return 0
        from amgx_tpu_torch.store.warmboot import export_all

        self.flush_store()
        return export_all(self)

    def warm_boot(self, wait: bool = True, compile: bool = True) -> int:
        """Fill the hierarchy cache from the store
        (:func:`amgx_tpu_torch.store.warmboot.warm_boot`): a persisted
        pattern's first group is a cache hit, with no setup, and with
        ``compile`` its batched solve is built ahead on the background
        worker too."""
        from amgx_tpu_torch.store.warmboot import warm_boot

        return warm_boot(self, wait=wait, compile=compile)

    # ------------------------------------------------------------------
    # flushing

    # a batch group passed over this long (x max_wait_s) gains its aging
    # credit and sorts with interactive rank
    _BATCH_AGING_FACTOR = 8

    def _lane_rank(self, grp: _Group, now: float) -> int:
        """0: flush first (interactive, or a batch group its aging
        credit promoted), 1: batch."""
        if grp.lane != "batch" or grp.promoted:
            return 0
        if now - grp.created >= self.max_wait_s * self._BATCH_AGING_FACTOR:
            grp.promoted = True
            self.metrics.inc("batch_promotions")
            return 0
        return 1

    def _ordered_keys(self, now: float) -> list:
        """Group keys in flush order (caller holds the lock):
        interactive before batch, then oldest max-wait deadline
        first."""
        return sorted(self._groups, key=lambda k: (
            self._lane_rank(self._groups[k], now), self._groups[k].deadline))

    def flush(self):
        """Run every queued group now, interactive groups first."""
        now = time.monotonic()
        with self._lock:
            groups = [self._take_group(k) for k in self._ordered_keys(now)]
        for grp in groups:
            self._execute_group(grp)

    def poll(self):
        """Run the groups whose max-wait deadline has passed, in lane
        order, their device stage handed to the dispatch worker
        (pipelined).  While an interactive group is due, a due batch
        group waits for a later poll (``batch_deferrals``), until its
        aging credit promotes it."""
        now = time.monotonic()
        with self._lock:
            due_keys = [k for k in self._ordered_keys(now)
                        if self._groups[k].deadline <= now]
            pressure = any(self._groups[k].lane != "batch"
                           for k in due_keys)
            due = []
            for k in due_keys:
                g = self._groups[k]
                if (pressure and g.lane == "batch"
                        and self._lane_rank(g, now) != 0):
                    self.metrics.inc("batch_deferrals")
                    continue
                due.append(self._take_group(k))
        for grp in due:
            self._execute_group(grp, wait_dispatch=False)

    def _enter_device(self):
        """Make the service's card this thread's current device (the
        kernel wrappers launch on the current device's stream)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def start(self, interval_s: float = 0.005):
        """Run a daemon poller that enforces max_wait_s; its groups run
        pipelined on the dispatch worker (:meth:`poll`), and so do the
        groups of every flush until :meth:`stop`."""
        if self._poller is not None:
            return
        self._stop.clear()

        def loop():
            self._enter_device()
            while not self._stop.wait(interval_s):
                self.poll()

        self._poller = threading.Thread(target=loop, name="serve-poller",
                                        daemon=True)
        self._poller.start()

    def stop(self):
        """Stop the poller, then flush (the shared workers stay: other
        services use them)."""
        if self._poller is not None:
            self._stop.set()
            self._poller.join()
            self._poller = None
        self.flush()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------
    # internals

    _PATTERN_CACHE_MAX = 512
    # two resident staging slots per group key
    _STAGING_SLOTS_PER_KEY = 2

    def _pattern_for(self, ro, ci, n, raw_fp) -> PaddedPattern:
        """Padded pattern of a raw fingerprint, cached."""
        with self._lock:
            pat = self._patterns.get(raw_fp)
        if pat is not None:
            return pat
        # the padded pattern's own fingerprint
        self.metrics.inc("pattern_hashes")
        pat = pad_pattern(ro, ci, n)
        with self._lock:
            if len(self._patterns) >= self._PATTERN_CACHE_MAX:
                self._patterns.clear()
            self._patterns[raw_fp] = pat
        return pat

    def _acquire_slot(self, key, pattern, dtype) -> StagingSlot:
        """A free staging slot of the key, or a new one (caller holds
        the lock)."""
        pool = self._staging.setdefault(key, [])
        for s in pool:
            if not s.in_use:
                s.in_use = True
                s.x0_used = False
                self.metrics.inc("staging_reuses")
                return s
        s = StagingSlot(pattern, dtype, bucket_batch(self.max_batch))
        s.in_use = True
        if len(pool) < self._STAGING_SLOTS_PER_KEY:
            pool.append(s)
        else:
            self.metrics.inc("staging_overflows")
        if len(self._staging) > self._PATTERN_CACHE_MAX:
            for k in list(self._staging):
                if k != key and not any(x.in_use for x in self._staging[k]):
                    del self._staging[k]
        return s

    def _release_group_slot(self, grp: _Group):
        """Release a group's slot exactly once (``grp.slot`` is the
        ownership token)."""
        slot, grp.slot = grp.slot, None
        if slot is not None:
            with self._lock:
                slot.in_use = False

    # total bytes the batched dense copies may take (B x nb x nb); above
    # it a bucket that is neither DIA nor ELL stays CSR
    _DENSE_BUDGET_MB = 256
    # padded max row length up to which the ELL structure is used
    _ELL_MAX_WIDTH = 64

    def _accel_for(self, pat: PaddedPattern) -> tuple:
        """Formats of a padded pattern's template, as the JAX package
        picks them (at its default dense budget): DIA for stencil
        patterns, then slot-major ELL, then dense within the byte
        budget, else CSR."""
        from amgx_tpu_torch.core.matrix import dia_gate

        if dia_gate(pat.num_diagonals, pat.nb, pat.nnzb):
            return ("dia",)
        w = pat.max_row_len
        if 0 < w <= self._ELL_MAX_WIDTH and w * pat.nb <= 4 * pat.nnzb:
            return ("ell",)
        budget = self._DENSE_BUDGET_MB * 2**20
        if bucket_batch(self.max_batch) * pat.nb * pat.nb * 8 <= budget:
            return ("dense",)
        return ()

    def _take_group(self, key) -> _Group:
        """Remove a group from the queue (caller holds the lock)."""
        grp = self._groups.pop(key)
        self._queued -= len(grp.requests)
        self.metrics.set_gauge("queue_depth", self._queued)
        return grp

    def _flush_group_of(self, ticket: SolveTicket):
        with self._lock:
            grp = self._groups.get(ticket._group_key)
            if grp is None or ticket not in [r.ticket
                                             for r in grp.requests]:
                grp = None
            else:
                grp = self._take_group(ticket._group_key)
        if grp is not None:
            self._execute_group(grp)
        else:
            # another thread is running the group right now
            while not ticket._done:
                time.sleep(0.001)

    @staticmethod
    def _wait_ready(grp: _Group):
        """Row writes happen outside the lock: wait until every
        submitter of the group has finished its write."""
        for r in grp.requests:
            while not r.ready:
                time.sleep(0.0001)

    def _new_solver(self):
        import amgx_tpu_torch.amg  # noqa: F401 — registers "AMG"
        import amgx_tpu_torch.solvers  # noqa: F401 — registry
        from amgx_tpu_torch.solvers.registry import (
            create_solver,
            make_nested,
        )

        # make_nested: the service owns the solve boundary (no scaling
        # or renumbering of padded systems)
        return make_nested(create_solver(self.cfg, "default",
                                         device=self.device))

    def _template(self, pattern, values, dtype):
        return pattern.template_matrix(
            values, dtype, accel_formats=self._accel_for(pattern),
            device=self.device)

    def _build_entry(self, pattern: PaddedPattern, values, dtype
                     ) -> HierarchyEntry:
        """One solver setup for a padded pattern (a hierarchy-cache
        miss) from one request's coefficients (original (nnz,)
        layout)."""
        with self.metrics.profile.phase("setup"):
            solver = self._new_solver()
            solver.setup(self._template(pattern, values, dtype))
            bp = solver.make_batch_params()
            batch_fn = make_batched_solve(solver)
            template = bp[0] if bp is not None else None
            sig = (template_signature(template) if batch_fn is not None
                   else None)
        for k, v in (getattr(solver, "setup_profile", None) or {}).items():
            if isinstance(v, float):
                self.metrics.profile.add(f"setup:{k}", v)
        inner = getattr(solver, "precond", None)
        for k, v in (getattr(inner, "setup_profile", None) or {}).items():
            if isinstance(v, float):
                self.metrics.profile.add(f"setup:{k}", v)
        entry = HierarchyEntry(solver=solver, template=template,
                               batch_fn=batch_fn, signature=sig,
                               pattern=pattern)
        self._export_entry(entry, dtype)
        return entry

    def resetup_entry(self, fingerprint: str, values, dtype=None, *,
                      b=None, x0=None):
        """Values-only resetup of a CACHED hierarchy entry (the serve
        form of ``AMGX_solver_resetup``): ``values`` (original (nnz,)
        layout) are embedded in the pattern's padded template and the
        cached solver refreshes through ``replace_values`` and its
        ``resetup``.  ``fingerprint`` is a submitted matrix's raw
        fingerprint or the padded one; ``KeyError`` when nothing is
        cached for it.  With ``b`` (padded or original length) the
        refreshed solver also solves once, in the same critical section,
        and its SolveResult (x padded) is returned; else None."""
        dtype = (_resolve_dtype(np.asarray(values).dtype) if dtype is None
                 else np.dtype(dtype))
        with self._lock:
            pat = self._patterns.get(fingerprint)
        fp = pat.fingerprint if pat is not None else fingerprint
        entry = self.cache.peek(fp, self.cfg_key, dtype)
        if entry is None:
            raise KeyError(
                f"no cached hierarchy entry for fingerprint "
                f"{str(fingerprint)[:16]}... under this service's "
                "config/dtype")
        pat = entry.pattern
        values = np.asarray(values).reshape(-1)
        old = entry.solver.A
        if (old is not None and old.nnz == pat.nnzb
                and old.dtype == torch_dtype(dtype)):
            A = old.replace_values(pat.embed_values(values, dtype))
        else:
            A = self._template(pat, values, dtype)
        if b is not None:
            bb = np.asarray(b).reshape(-1)
            if bb.shape[0] == pat.n:
                bb = pat.embed_vector(bb, dtype)
            if x0 is not None:
                x0 = np.asarray(x0).reshape(-1)
                if x0.shape[0] == pat.n:
                    x0 = pat.embed_vector(x0, dtype)
        with entry.solver_lock:
            entry.settle()
            entry.solver.resetup(A)
            res = None if b is None else entry.solver.solve(bb, x0=x0)
        self.metrics.inc("entry_resetups")
        return res

    def _on_hierarchy_evict(self, key, entry: HierarchyEntry):
        """Drop an evicted entry's batched solves, and its signature's
        last bucket (the store's build target), unless another cached
        entry shares its signature."""
        sig = entry.signature
        if sig is None or self.cache.any_with_signature(sig):
            return
        self.compile_cache.evict_signature(sig)
        with self._lock:
            self._last_bucket.pop(sig, None)

    def _expire_deadlines(self, grp: _Group):
        """Fail (only) the tickets whose deadline already passed; their
        rows ride along inert."""
        from amgx_tpu_torch.core.errors import DeadlineExceededError

        now = time.monotonic()
        for r in grp.requests:
            if (r.deadline is not None and now > r.deadline
                    and not r.ticket._done):
                r.ticket._error = DeadlineExceededError(
                    "serve deadline exceeded before execution")
                r.ticket._done = True
                self.metrics.inc("deadline_expired")
                self._flight_incident(
                    "deadline_expired",
                    detail=f"expired while queued (lane {grp.lane})")

    def _breaker_failure(self, fp: str):
        """Count a group failure; trip the breaker at the threshold
        (under the lock: two failures crossing it together trip it
        once)."""
        if self.breaker_threshold <= 0:
            return
        with self._lock:
            if fp in self._broken:
                return
            n = self._fail_counts.get(fp, 0) + 1
            self._fail_counts[fp] = n
            tripped = n >= self.breaker_threshold
            if tripped:
                self._broken.add(fp)
                self.metrics.inc("breaker_trips")
                self.metrics.set_gauge("breakers_open", len(self._broken))
        if tripped:
            # outside the service lock: the incident snapshots the
            # metrics, which take their own
            self._flight_incident("breaker_trip",
                                  detail=f"fingerprint {fp[:16]}...")

    def _breaker_success(self, fp: str):
        """A group completed: reset the count, and close the breaker if
        this was its half-open probe."""
        with self._lock:
            self._fail_counts.pop(fp, None)
            if fp in self._broken:
                self._broken.discard(fp)
                self._bypass_counts.pop(fp, None)
                self.metrics.inc("breaker_closes")
                self.metrics.set_gauge("breakers_open", len(self._broken))

    def _execute_group(self, grp: _Group, wait_dispatch: bool = True):
        """Host stage of a flush: deadlines, the breaker, the hierarchy
        entry and the group's placement plan (its device and its built
        batched solve); then the device stage.  A flush
        (``wait_dispatch``: a submit at ``max_batch``, ``flush()``,
        ``solve_many``, a ``result()`` of a queued ticket) returns once
        its tickets are done(): a service that is not started runs the
        device stage inline, a started one hands it to the dispatch
        worker and waits for the hand-over only, as the JAX package's
        flush returns at dispatch.  The poller (``wait_dispatch``
        False) hands it over and goes back to padding.  A failure here
        quarantines the group."""
        if not grp.requests:
            self._release_group_slot(grp)
            return
        self._wait_ready(grp)
        t_flush = time.perf_counter()
        self._expire_deadlines(grp)
        live = [r for r in grp.requests if not r.ticket._done]
        if not live:
            self._release_group_slot(grp)
            return
        fp = grp.pattern.fingerprint
        with self._lock:
            broken = fp in self._broken
            if broken:
                probes = self._bypass_counts.get(fp, 0) + 1
                self._bypass_counts[fp] = probes
        if broken and probes % self.breaker_probe_every != 0:
            # breaker open: per-request isolation, no batched attempt
            self.metrics.inc("breaker_bypasses")
            self._execute_quarantined(grp)
            return
        try:
            vals0 = grp.pattern.extract_values(grp.slot.vals[live[0].row])
            entry = self.cache.get_or_build(
                grp.pattern, self.cfg_key, grp.dtype,
                lambda: self._build_entry(grp.pattern, vals0, grp.dtype))
            if entry.batch_fn is None:
                self._execute_sequential(entry, grp, live)
                return
            if faults.should_fire("serve_compile"):
                raise ResourceError("injected serve compile failure "
                                    "(fault site serve_compile)")
            Bb = bucket_batch(len(grp.requests))
            # where the group runs, and with which built solve
            plan = self.placement.plan(self, entry, Bb)
            with self._lock:
                if len(self._last_bucket) >= self._PATTERN_CACHE_MAX:
                    self._last_bucket.clear()
                self._last_bucket[entry.signature] = Bb
        except Exception:  # noqa: BLE001 — failures reach the tickets
            # the group failed as a unit (a poisoned member spoiled the
            # shared setup, or the build raised): every member re-solves
            # alone, so only the poisoned ones fail
            self._group_failed(grp, fp)
            self._execute_quarantined(grp)
            return
        if wait_dispatch and (self._poller is None or on_dispatch_worker()):
            # (a job on the worker cannot wait for one queued behind it)
            self._dispatch_batched(entry, plan, grp, live, Bb, t_flush)
            return
        handed = threading.Event()
        _dispatch_pool().submit(self._dispatch_batched, entry, plan, grp,
                                live, Bb, t_flush, handed)
        if wait_dispatch:
            handed.wait()

    def _group_failed(self, grp: _Group, fp: str,
                      device_loss: bool = False):
        """Count a group that failed as a unit (its members then
        re-solve alone).  A lost device is not the pattern's fault: it
        does not count toward the fingerprint breaker."""
        self.metrics.inc("failed_groups")
        if not device_loss:
            self._breaker_failure(fp)
        self.metrics.inc("quarantines")
        self._flight_incident(
            "quarantine",
            detail=(f"group of {len(grp.requests)} (lane {grp.lane}) "
                    f"fingerprint {fp[:16]}..."))

    def _ship(self, plan, slot, Bb):
        """The staged rows' copies on the plan's device (the slot goes
        back to the pool before the loop reads them), then the
        ``device_lost_dispatch`` site."""
        shipped = tuple(
            None if a is None else plan.put(a[:Bb])
            for a in (slot.vals, slot.bs,
                      slot.x0s if slot.x0_used else None))
        if faults.should_fire("device_lost_dispatch"):
            raise DeviceLostError(
                "injected device loss at dispatch (fault site "
                "device_lost_dispatch)", device_label=plan.device_label)
        return shipped

    def _dispatch_batched(self, entry, plan, grp, live, Bb, t_flush,
                          handed=None):
        """Device stage: ship the staged rows through the plan (a device
        lost there replans once and ships again), keep the failover copy,
        release the slot, hand the group to its tickets (done() from
        here, and ``handed`` set), run the batched loop and settle the
        group's future with its result and a CUDA event recorded after
        its last launch.  Runs inline or on the dispatch worker, and
        never raises: a failure before the hand-over quarantines the
        group from its slot; a CUDA runtime error in the loop settles
        the future with a ``DeviceLostError``, which the fetch fails
        over; any other loop failure quarantines from the rows' device
        copies."""
        pat, slot = grp.pattern, grp.slot
        fp = pat.fingerprint
        nreq = len(grp.requests)
        inflight = concurrent.futures.Future()
        shipped = ship_err = br = None
        try:
            with trace_range("serve_batch_dispatch"), \
                    self.metrics.profile.phase("dispatch"):
                try:
                    self._enter_device()
                    # batch padding: clones of a live system with b = 0
                    # converge at iteration 0 and freeze
                    slot.fill_batch_padding(nreq, Bb)
                    if live[0].row != 0:
                        slot.vals[nreq:Bb] = slot.vals[live[0].row]
                    try:
                        shipped = self._ship(plan, slot, Bb)
                    except DeviceLostError as e:
                        # the rows are still staged: replan, ship again
                        # (a second loss quarantines)
                        plan = self._failover_replan(plan, e, entry, Bb)
                        shipped = self._ship(plan, slot, Bb)
                    retry = None
                    if self.failover:
                        # the host copy a device lost after this release
                        # re-dispatches from
                        retry = {"vals": np.array(slot.vals[:Bb]),
                                 "bs": np.array(slot.bs[:Bb]),
                                 "x0": (np.array(slot.x0s[:Bb])
                                        if slot.x0_used else None)}
                except Exception as e:  # noqa: BLE001 — rows still staged
                    shipped, ship_err = None, e
                if shipped is not None:
                    vals_d, bs_d, x0_d = shipped
                    if x0_d is None:
                        x0_d = torch.zeros_like(bs_d)
                    self._release_group_slot(grp)
                    t_dispatch = time.perf_counter()
                    br = self._handed_over(grp, live, Bb, inflight,
                                           t_flush, t_dispatch, plan,
                                           entry, retry)
                    if handed is not None:
                        handed.set()
                    loop_err = None
                    try:
                        res, event, br.loop_clock = _run_loop(
                            self.device, plan.fn, entry.template, vals_d,
                            bs_d, x0_d)
                        self.metrics.inc("batches")
                    except Exception as e:  # noqa: BLE001 — settled below
                        res, loop_err = None, e
            if shipped is None:
                device_loss = isinstance(ship_err, DeviceLostError)
                if device_loss:
                    # the replan's device was lost too
                    self._device_loss_attributed(plan, ship_err)
                else:
                    self._abandon(plan)
                self._group_failed(grp, fp, device_loss=device_loss)
                self._execute_quarantined(grp)
            elif br.requeued:
                # the watchdog gave up on this loop and the group was
                # requeued: its late outcome is nobody's
                inflight.set_result((None, None))
            elif loop_err is not None:
                dl = self._classify_device_loss(loop_err, plan.device_label)
                if dl is not None:
                    # the fetch fails the group over from its host copy
                    inflight.set_exception(dl)
                else:
                    self._loop_failed(grp, fp, live, inflight, shipped)
            else:
                inflight.set_result((res, event))
                self._breaker_success(fp)
        finally:
            if handed is not None:
                handed.set()

    def _abandon(self, plan):
        try:
            plan.abandon()  # release any routing reservation
        except Exception:  # noqa: BLE001 — placement telemetry
            self.metrics.inc("telemetry_errors")

    def _handed_over(self, grp, live, Bb, inflight, t_flush, t_dispatch,
                     plan=None, entry=None, retry=None):
        """The group's rows are on the device: its host time, its
        dispatch spans, and its tickets handed the group's result (done()
        from here).  Returns the group's :class:`_BatchResult`."""
        self.metrics.add_time(
            "host_busy_s",
            (t_dispatch - t_flush) + sum(r.ticket._pad_s for r in live))
        if tracing.tracing_enabled():
            sampled = [r.ticket._trace for r in live
                       if r.ticket._trace is not None]
            for c in sampled:
                tracing.record_span("dispatch", t_flush, t_dispatch, c)
            # one group-formation span per group with a sampled member,
            # naming the members' trace ids
            if sampled:
                tracing.record_span(
                    "flush_group", t_flush, t_dispatch, None,
                    args={"members": [c.trace_id for c in sampled],
                          "batch": Bb, "real": len(grp.requests),
                          "lane": grp.lane,
                          "fingerprint": grp.pattern.fingerprint[:16]})
        cold = entry is not None and Bb not in entry.ran_buckets
        if cold:
            entry.ran_buckets.add(Bb)
        br = _BatchResult(self, inflight, grp.pattern,
                          [r.ticket for r in live], Bb, t_flush, t_dispatch,
                          plan=plan, entry=entry, retry=retry, cold=cold)
        for r in live:
            r.ticket._batch = br
            r.ticket._done = True
        return br

    def _loop_failed(self, grp, fp, live, inflight, shipped):
        """The batched loop raised after the hand-over (not a device
        loss): every member re-solves alone from its rows read back from
        their device copies (``shipped``: values, b, and x0 or None for
        zeros; the slot is already back in the pool; a row that cannot
        be read back fails its request), then the group's future settles
        with None, so a ticket waiting in ``result()`` reads its own
        outcome."""
        vals_d, bs_d, x0_d = shipped
        pat = grp.pattern

        def rows(i):
            b = bs_d[i].cpu().numpy().copy()
            x0 = (np.zeros_like(b) if x0_d is None
                  else x0_d[i].cpu().numpy().copy())
            return pat.extract_values(vals_d[i].cpu().numpy()), b, x0

        try:
            self._group_failed(grp, fp)
            entry = self.cache.peek(fp, self.cfg_key, grp.dtype)
            for r in live:
                self._settle_alone(r.ticket, pat, grp.dtype, entry,
                                   lambda i=r.row: rows(i))
        finally:
            inflight.set_result((None, None))

    # ------------------------------------------------------------------
    # failure domains: the watchdog and device-loss failover

    # the watchdog never undercuts this multiple of the warm groups' p99
    # loop seconds (long groups are not failed by a fixed bound)
    _WATCHDOG_P99_FACTOR = 25.0

    def watchdog_s(self) -> float:
        """The fetch watchdog a group's wait gets now:
        ``fetch_watchdog_s``, raised to 25 x the p99 of the warm groups'
        loop seconds (:meth:`_BatchResult.loop_s`: the loop alone, not
        the window to a late fetch; each batched solve's first group is
        left out, so that a cold process's one-off first-call cost does
        not lift it above a real hang); <= 0: no watchdog."""
        wd = self.fetch_watchdog_s
        if not wd or wd <= 0:
            return wd
        p99 = self.metrics.watchdog_p99()
        if p99:
            wd = max(wd, self._WATCHDOG_P99_FACTOR * p99)
        return wd

    def _watched_block(self, inflight, device_label=None, worker=True):
        """The group's one blocking wait (``_block_ready``) under the
        watchdog: with ``fetch_watchdog_s > 0`` it runs on a daemon
        fetch-pool thread and an expiry raises a typed
        ``DeviceLostError`` (the thread is abandoned: ``result()`` never
        blocks past the watchdog); <= 0 waits inline.  The
        ``fetch_hang`` site sleeps ``faults.hang_seconds()`` first, as a
        hung card would.  ``worker``: ``inflight`` is a job of the
        dispatch worker (a requeue's is not)."""
        hang = faults.should_fire("fetch_hang")
        wd = self.watchdog_s()
        if not wd or wd <= 0:
            if hang:
                time.sleep(faults.hang_seconds())
            return _block_ready(inflight)

        gave_up = threading.Event()

        def work():
            if hang:
                time.sleep(faults.hang_seconds())
                if gave_up.is_set():
                    # the watchdog settled the group during the hang:
                    # nobody reads this wait any more
                    return None
            return _block_ready(inflight)

        fut = _fetch_pool().submit(work)
        try:
            return fut.result(timeout=wd)
        except concurrent.futures.TimeoutError:
            gave_up.set()
            self.metrics.inc("resilience_watchdog_fires")
            self._flight_incident(
                "watchdog_fire",
                detail=(f"fetch exceeded the {wd:g}s watchdog on device "
                        f"{device_label!r}"))
            if worker and not inflight.done() and not on_dispatch_worker():
                # the loop itself is still running on the dispatch
                # worker: later groups go to a fresh one
                abandon_worker()
            raise DeviceLostError(
                f"group fetch exceeded the {wd:g}s in-flight watchdog "
                "(device presumed hung)", device_label=device_label
            ) from None

    @staticmethod
    def _classify_device_loss(e, device_label=None):
        """A ``DeviceLostError`` for a failure that means the device,
        not the program, failed; None keeps the typed generic path (the
        quarantine at the loop, a ``ResourceError`` at the fetch).  A
        CUDA runtime error (``torch.AcceleratorError`` where torch has
        it, or a ``RuntimeError`` whose message names a CUDA error) is
        one, with ``inferred`` set; ``torch.cuda.OutOfMemoryError`` is a
        program-level failure (the group is too big: it would not fit
        the next device either) and stays on the generic path, with
        every plain Python exception."""
        if isinstance(e, DeviceLostError):
            return e
        if isinstance(e, (torch.cuda.OutOfMemoryError, AMGXTPUError)):
            return None
        accel = getattr(torch, "AcceleratorError", None)
        msg = str(e)
        if "out of memory" in msg.lower():
            return None
        if not ((accel is not None and isinstance(e, accel))
                or (type(e) is RuntimeError and _CUDA_ERROR.search(msg))):
            return None
        err = DeviceLostError(
            f"device runtime failure: {type(e).__name__}: {e}",
            device_label=device_label)
        err.__cause__ = e
        # inferred, not certain: a pattern whose every group dies at run
        # time still trips its own breaker
        err.inferred = True
        return err

    def _device_loss_attributed(self, plan, exc):
        """A device loss's bookkeeping: the plan's device breaker, its
        reservation released, the ``device_failover`` incident."""
        if plan is not None:
            try:
                plan.device_failure(exc)
            except Exception:  # noqa: BLE001 — health accounting
                self.metrics.inc("telemetry_errors")
            self._abandon(plan)
        self._flight_incident(
            "device_failover",
            detail=(f"device {getattr(plan, 'device_label', None)!r} "
                    f"lost: {type(exc).__name__}: {exc}"))

    def _failover_replan(self, plan, exc, entry, Bb):
        """Dispatch-side failover: the ship lost its device; a fresh
        plan through the policy (on a single device, the same device
        again), which the caller ships through once more."""
        self._device_loss_attributed(plan, exc)
        self.metrics.inc("resilience_failovers")
        return self.placement.plan(self, entry, Bb)

    def _failover_refetch(self, batch, exc):
        """Fetch-side failover: the device was lost (or hung past the
        watchdog) after dispatch, the staging slot long released: the
        group runs again from its retained host copy on a fresh plan,
        and the fetching thread waits for it under the watchdog.  The
        loop runs on a fetch-pool thread, not on the dispatch worker
        (which may be the wedged one), and is not waited for past the
        watchdog.  Once only: a second loss, or a group without a
        retained copy (``failover=False``), raises ``exc``."""
        self._device_loss_attributed(batch.plan, exc)
        retry = batch.retry
        if retry is None or batch.requeued or batch.entry is None:
            raise exc
        batch.requeued = True
        self.metrics.inc("resilience_failovers")
        entry, Bb, pat = batch.entry, batch.Bb, batch.pattern
        nplan = None
        try:
            nplan = self.placement.plan(self, entry, Bb)

            def rerun():
                self._enter_device()
                vals_d = nplan.put(retry["vals"])
                bs_d = nplan.put(retry["bs"])
                x0_d = (nplan.zeros(Bb, pat.nb, retry["bs"].dtype)
                        if retry["x0"] is None else nplan.put(retry["x0"]))
                res, event, batch.loop_clock = _run_loop(
                    self.device, nplan.fn, entry.template, vals_d, bs_d, x0_d)
                self.metrics.inc("batches")
                return res, event

            t_redispatch = time.perf_counter()
            rerun_fut = _fetch_pool().submit(rerun)
            res = self._watched_block(rerun_fut, nplan.device_label,
                                      worker=False)
            t_done = time.perf_counter()
            res = _fetch_host(res)
        except BaseException as e2:  # noqa: BLE001 — once only: any
            # second failure settles the group typed
            if isinstance(e2, DeviceLostError):
                self._device_loss_attributed(nplan, e2)
            elif nplan is not None:
                self._abandon(nplan)
            self.metrics.inc("resilience_requeue_failures")
            raise
        # the new plan owns the group: its accounting, its timings
        batch.plan = nplan
        batch.t_dispatch = t_redispatch
        return res, t_done

    def _isolated_solve(self, pat, entry, vals, b, x0, dtype):
        """One request alone: through the cached entry (a values-only
        resetup) where there is one, else a fresh setup."""
        if entry is not None:
            try:
                res = self.resetup_entry(pat.fingerprint, vals, dtype,
                                         b=b, x0=x0)
                self.metrics.inc("quarantine_entry_reuses")
                return res
            except Exception:  # noqa: BLE001 — the isolated setup decides
                pass
        solver = self._new_solver()
        solver.setup(self._template(pat, vals, dtype))
        return solver.solve(b, x0=x0)

    def _solve_alone(self, ticket, pat, dtype, entry, rows):
        """Quarantine one request: re-solve it alone from ``rows()``
        (its values, b and x0), so that only a poisoned request fails,
        with its typed error.  Returns its result (x unpadded) or raises
        that error, counted either way."""
        try:
            vals, b, x0 = rows()
            with self.metrics.profile.phase("quarantine"):
                res = self._isolated_solve(pat, entry, vals, b, x0, dtype)
        except Exception:
            self.metrics.inc("poisoned_requests")
            raise
        self.metrics.inc("quarantined_solves")
        self.metrics.inc("solved")
        self._record_alone(ticket, pat, res, "quarantine")
        return dataclasses.replace(res, x=res.x[: pat.n])

    def _settle_alone(self, ticket, pat, dtype, entry, rows):
        """A ticket's own outcome from :meth:`_solve_alone`."""
        try:
            ticket._result = self._solve_alone(ticket, pat, dtype, entry,
                                               rows)
        except Exception as e:  # noqa: BLE001 — per request
            ticket._error = e
        ticket._done = True

    def _execute_quarantined(self, grp: _Group):
        """Per-request isolation from the staging slot: every member not
        yet settled re-solves alone (:meth:`_solve_alone`)."""
        pat, slot = grp.pattern, grp.slot
        entry = self.cache.peek(pat.fingerprint, self.cfg_key, grp.dtype)
        try:
            for r in grp.requests:
                if r.ticket._done:
                    continue
                self._settle_alone(
                    r.ticket, pat, grp.dtype, entry,
                    lambda i=r.row: (pat.extract_values(slot.vals[i]),
                                     slot.bs[i].copy(), slot.x0s[i].copy()))
        finally:
            self._release_group_slot(grp)

    def _execute_sequential(self, entry: HierarchyEntry, grp: _Group,
                            live: list):
        """Solvers without a batch rebuild: each request in turn on the
        cached solver (values-only resetup, then ``solve(block=False)``:
        the loop runs on the dispatch worker while the next request is
        prepared; a resetup first waits for the solve before it, since
        the solver is shared).  A failure here leaves the rows staged
        for the quarantine path.  Once every solve is submitted the slot
        goes back to the pool, and :meth:`_fallback_settled` runs on the
        worker behind them: the tickets' results come from it."""
        pat = grp.pattern
        kept = []
        for r in live:
            with self.metrics.profile.phase("fallback"):
                i = r.row
                rows = (pat.extract_values(grp.slot.vals[i]),
                        grp.slot.bs[i].copy(), grp.slot.x0s[i].copy())
                A = self._template(pat, rows[0], grp.dtype)
                with entry.solver_lock:
                    entry.settle()
                    entry.solver.resetup(A)
                    res = entry.solver.solve(rows[1], x0=rows[2],
                                             block=False)
                    entry.pending = res
            kept.append((r.ticket, rows, res))
        self._release_group_slot(grp)
        outcomes = _dispatch_pool().submit(self._fallback_settled, grp, kept)
        for k, (t, _rows, _res) in enumerate(kept):
            t._result = PendingSolveResult(outcomes, then=_outcome(k))
            t._done = True
            self.metrics.inc("fallback_solves")
            self._record_alone(t, pat, None, "fallback")

    def _fallback_settled(self, grp: _Group, kept: list) -> list:
        """A fallback group's last job on the dispatch worker, which runs
        its jobs in order, so every solve of the group has ended: each
        request's outcome (its result, x unpadded, or its error).  All
        solved: the breaker counts a success.  A solve that raised fails
        the group as a unit, as a batched loop's failure does, and its
        request re-solves alone from its kept rows on a fresh setup (the
        shared solver's lock may be held by a flush waiting on this
        worker)."""
        pat = grp.pattern
        fp = pat.fingerprint
        out, failed = [], False
        for t, rows, res in kept:
            try:
                out.append(dataclasses.replace(res, x=res.x[: pat.n]))
                self.metrics.inc("solved")
                continue
            except Exception:  # noqa: BLE001 — the request quarantines
                pass
            if not failed:
                failed = True
                self._group_failed(grp, fp)
            try:
                out.append(self._solve_alone(t, pat, grp.dtype, None,
                                             lambda r=rows: r))
            except Exception as e:  # noqa: BLE001 — the ticket's error
                out.append(e)
        if not failed:
            self._breaker_success(fp)
        return out

    def _record_alone(self, ticket, pat, res, path: str):
        """The flight record of a request solved alone.  A quarantined
        solve is synchronous and records its status and iterations; a
        fallback solve (``res`` None) is still in flight and records -1
        and NaN, as the JAX package's does (reading them would wait)."""
        if not telemetry_enabled():
            return
        ctx = ticket._trace
        self._flight_record(
            fingerprint=pat.fingerprint, config=self.cfg_key,
            lane=ticket._lane, tenant=ticket._tenant,
            iterations=-1 if res is None else int(res.iters),
            final_residual=(float("nan") if res is None
                            else float(np.max(np.asarray(res.final_norm)))),
            status=-1 if res is None else int(res.status), stages={},
            path=path, trace_id=ctx.trace_id if ctx is not None else None)
