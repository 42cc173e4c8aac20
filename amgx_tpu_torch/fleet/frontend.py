"""FleetFrontend: the client face of the multi-process fleet (the JAX
package's ``fleet/frontend.py``).

One frontend holds one socket per attached worker, routes every submit
through the :class:`~amgx_tpu_torch.fleet.router.FleetRouter`
(fingerprint affinity across processes: a repeat structure lands on the
worker whose hierarchy cache is warm) and settles tickets from a reader
thread per connection that demultiplexes replies by request id.

Failure semantics:

* A worker replies a typed error (an ``AdmissionRejected`` shed, a
  breaker-gated fingerprint, a missed deadline): the worker is fine, its
  slot's load releases, and :meth:`FleetTicket.result` applies the
  :class:`~amgx_tpu_torch.serve.retry.RetryPolicy`: a retryable class
  backs off (honouring the shed's ``retry_after_s``, which crossed the
  wire) and is submitted again through routing; anything else raises
  typed at once.
* The connection dies (kill -9, a mid-frame disconnect): the slot's
  breaker trips, its warm set is forgotten, and every request in flight
  on that socket is requeued to a healthy worker once; a second loss
  settles the ticket with a typed
  :class:`~amgx_tpu_torch.core.errors.DeviceLostError`.  No ticket is
  lost silently.

The frontend is synchronous and threaded: its callers are the C API's
batched solve and closed-loop clients.  A result's ``x`` is a CPU
tensor, as the port's ``SolveResult`` holds.
"""

from __future__ import annotations

import itertools
import socket as socketlib
import threading
import time
import uuid
from typing import Optional

import numpy as np

from amgx_tpu_torch.core.errors import (
    AMGXTPUError,
    DeviceLostError,
    Overloaded,
)
from amgx_tpu_torch.core.profiling import LatencyReservoir
from amgx_tpu_torch.fleet import wire
from amgx_tpu_torch.fleet.registry import WorkerRegistry
from amgx_tpu_torch.fleet.router import FleetRouter
from amgx_tpu_torch.serve.retry import RetryPolicy


class _WorkerConn:
    """One attached worker: socket, reader thread, pending map."""

    def __init__(self, slot: int, worker_id: str, address,
                 dist_capable: bool, on_lost, on_reply,
                 connect_timeout_s: float):
        self.slot = int(slot)
        self.worker_id = str(worker_id)
        self.address = tuple(address)
        self.dist_capable = bool(dist_capable)
        self._on_lost = on_lost
        self._on_reply = on_reply
        self.sock = socketlib.create_connection(
            self.address, timeout=connect_timeout_s
        )
        self.sock.settimeout(None)
        self.rfile = self.sock.makefile("rb")
        self.wlock = threading.Lock()
        self.plock = threading.Lock()
        self.pending: dict = {}  # rid -> _Pending
        self.alive = True
        self.orderly = False  # set before an intentional close
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"fleet-read-{worker_id}",
            daemon=True,
        )
        self._reader.start()

    def send(self, frame: bytes) -> None:
        with self.wlock:
            self.sock.sendall(frame)

    def add_pending(self, rid: str, pending) -> None:
        with self.plock:
            self.pending[rid] = pending

    def pop_pending(self, rid):
        with self.plock:
            return self.pending.pop(rid, None)

    def drain_pending(self) -> list:
        with self.plock:
            out = list(self.pending.values())
            self.pending.clear()
            return out

    def close(self, orderly: bool = True) -> None:
        self.orderly = self.orderly or orderly
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass

    def _read_loop(self):
        err = None
        try:
            while True:
                header, arrays = wire.read_frame(self.rfile)
                rid = header.get("rid")
                pending = self.pop_pending(rid)
                if pending is not None:
                    self._on_reply(pending, header)
                    pending.settle_reply(header, arrays)
        except wire.WireClosed:
            pass
        except (wire.WireError, OSError, ValueError) as e:
            err = e
        finally:
            self.alive = False
            self._on_lost(self, err)


class _Pending:
    """One in-flight request: the resendable frame parts, the future
    its ticket waits on, and the requeue state."""

    __slots__ = (
        "header", "arrays", "fp", "n_rows", "slot", "rid",
        "requeued", "routed", "t_sent", "_outcome", "_event",
    )

    def __init__(self, header: dict, arrays: dict, fp, n_rows: int):
        self.header = header
        self.arrays = arrays
        self.fp = fp
        self.n_rows = int(n_rows)
        self.slot = -1
        self.rid = None
        self.requeued = False
        self.routed = False
        self.t_sent = 0.0
        self._outcome = None
        self._event = threading.Event()

    def settle_reply(self, header, arrays):
        self._outcome = ("reply", header, arrays)
        self._event.set()

    def settle_error(self, exc: BaseException):
        self._outcome = ("raise", exc, None)
        self._event.set()

    def rearm(self):
        self._outcome = None
        self._event.clear()

    def wait(self, timeout: Optional[float]):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"fleet request {self.rid!r} still in flight after "
                f"{timeout}s"
            )
        return self._outcome


def _host(v) -> np.ndarray:
    """A vector as host numpy (a tensor read back from its device)."""
    import torch

    if isinstance(v, torch.Tensor):
        from amgx_tpu_torch.core.types import host_array

        return host_array(v)
    return np.asarray(v)


def _rebuild_result(header, arrays):
    """The port's SolveResult of a reply frame: x a CPU tensor, the
    iteration count and status ints, the norms numpy."""
    import torch

    from amgx_tpu_torch.solvers.base import SolveResult

    return SolveResult(
        x=torch.from_numpy(arrays["x"]),
        iters=int(arrays["iters"]),
        status=int(arrays["status"]),
        final_norm=arrays["final_norm"],
        initial_norm=arrays["initial_norm"],
        history=arrays["history"],
    )


class FleetTicket:
    """Settlement handle for one fleet submit — the wire twin of the
    gateway's GatewayTicket.  ``result()`` blocks for the reply and
    applies the frontend's RetryPolicy to retryable typed errors
    (sheds re-enter routing after the hinted backoff; the policy's
    ``max_attempts`` bounds the loop)."""

    def __init__(self, frontend: "FleetFrontend", pending: _Pending):
        self._frontend = frontend
        self._pending = pending
        self._done: Optional[tuple] = None

    def done(self) -> bool:
        return self._done is not None or self._pending._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if self._done is not None:
            kind, val = self._done
            if kind == "ok":
                return val
            raise val
        policy = self._frontend.retry_policy
        attempt = 0
        while True:
            outcome = self._pending.wait(timeout)
            kind, a, b = outcome
            if kind == "reply":
                header, arrays = a, b
                err = header.get("error")
                if err is None:
                    res = _rebuild_result(header, arrays)
                    self._done = ("ok", res)
                    return res
                exc = wire.unmarshal_error(err)
            else:
                exc = a
            if (
                isinstance(exc, policy.retryable)
                and attempt + 1 < policy.max_attempts
            ):
                attempt += 1
                policy.retries += 1
                self._frontend._count("retries")
                policy.sleep(policy.backoff_s(
                    attempt, getattr(exc, "retry_after_s", None)
                ))
                try:
                    self._frontend._resubmit(self._pending)
                except AMGXTPUError as resubmit_exc:
                    exc = resubmit_exc
                else:
                    continue
            if isinstance(exc, policy.retryable):
                policy.giveups += 1
            self._frontend._count("typed_errors")
            self._done = ("err", exc)
            raise exc


class FleetFrontend:
    """Routes submits across attached fleet workers.

    ``workers`` may be a :class:`~amgx_tpu_torch.fleet.registry.
    WorkerRegistry` / registry directory (every live announced worker
    attaches) or an explicit iterable of records.  Telemetry
    registers as kind ``"fleet"`` (``amgx_fleet_*`` families).
    """

    def __init__(self, workers=None, *, capacity: int = 16,
                 retry_policy: Optional[RetryPolicy] = None,
                 dist_rows: Optional[int] = None,
                 trip_threshold: int = 1,
                 probe_every: Optional[int] = None,
                 connect_timeout_s: float = 10.0,
                 register_telemetry: bool = True):
        self.router = FleetRouter(
            capacity=capacity, dist_rows=dist_rows,
            trip_threshold=trip_threshold, probe_every=probe_every,
        )
        self.retry_policy = retry_policy or RetryPolicy()
        self.connect_timeout_s = float(connect_timeout_s)
        self._lock = threading.Lock()
        self._conns: dict = {}  # slot -> _WorkerConn
        self._rid_counter = itertools.count(1)
        self._rid_prefix = uuid.uuid4().hex[:8]
        self._counters = {
            "submitted": 0, "completed": 0, "typed_errors": 0,
            "retries": 0, "requeued": 0, "requeue_failures": 0,
            "conn_losses": 0,
        }
        self.wire_latency = LatencyReservoir()
        self.telemetry_name = None
        if register_telemetry:
            from amgx_tpu_torch.telemetry import get_registry

            self.telemetry_name = get_registry().register("fleet", self)
        if workers is not None:
            if isinstance(workers, (str, WorkerRegistry)):
                self.attach_registry(workers)
            else:
                for rec in workers:
                    self.attach(rec)

    # -- membership ----------------------------------------------------

    def attach(self, record) -> int:
        """Attach an announced worker (a WorkerRecord): connect, add
        its slot to routing.  Returns the slot."""
        conn = _WorkerConn(
            record.slot, record.worker_id, record.address,
            record.dist_capable, self._conn_lost, self._on_reply,
            self.connect_timeout_s,
        )
        with self._lock:
            old = self._conns.get(conn.slot)
            self._conns[conn.slot] = conn
        if old is not None:
            old.close(orderly=True)
        self.router.add_worker(conn.slot, conn.dist_capable)
        return conn.slot

    def attach_registry(self, registry) -> list:
        reg = (
            registry if isinstance(registry, WorkerRegistry)
            else WorkerRegistry(registry)
        )
        return [self.attach(rec) for rec in reg.workers()]

    def detach(self, slot: int, close: bool = True) -> None:
        """Orderly removal: stop routing to the slot and drop its
        connection (no breaker trip)."""
        self.router.remove_worker(slot)
        with self._lock:
            conn = self._conns.pop(slot, None)
        if conn is not None and close:
            conn.close(orderly=True)

    def quiesce(self, slot: int) -> None:
        """Stop ROUTING to a slot but keep its connection — the
        rolling-restart window between "no new work" and "drain"."""
        self.router.remove_worker(slot)

    def attached_slots(self) -> list:
        with self._lock:
            return sorted(self._conns)

    # -- internals -----------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def _next_rid(self) -> str:
        return f"{self._rid_prefix}-{next(self._rid_counter)}"

    def _conn_for(self, slot: int):
        with self._lock:
            conn = self._conns.get(slot)
        if conn is None or not conn.alive:
            raise DeviceLostError(
                f"fleet slot {slot} has no live connection",
                device_label=f"worker:{slot}",
            )
        return conn

    def _send_pending(self, pending: _Pending, slot: int) -> None:
        conn = self._conn_for(slot)
        rid = self._next_rid()
        pending.rid = rid
        pending.slot = slot
        pending.t_sent = time.perf_counter()
        header = dict(pending.header)
        header["rid"] = rid
        frame = wire.pack_frame(header, pending.arrays)
        conn.add_pending(rid, pending)
        try:
            conn.send(frame)
        except OSError as e:
            conn.pop_pending(rid)
            raise DeviceLostError(
                f"send to worker slot {slot} failed: {e}",
                device_label=f"worker:{conn.worker_id}",
            ) from None

    def _on_reply(self, pending: _Pending, header: dict) -> None:
        """Reader-thread settlement: ANY reply — success or typed
        error — means the worker served; release its routing load,
        charge wire time, reset its breaker."""
        wire_s = time.perf_counter() - pending.t_sent
        if pending.routed:
            pending.routed = False
            self.router.settle(pending.slot, wire_s)
        self.wire_latency.add(wire_s)
        if (
            header.get("error") is None
            and pending.header.get("verb") == wire.VERB_SUBMIT
        ):
            self._count("completed")

    def _route_and_send(self, pending: _Pending) -> None:
        if not self.router.active_slots():
            raise Overloaded(
                "no fleet workers attached", retry_after_s=1.0,
                reason="no_workers",
            )
        slot, _warm = self.router.route(pending.fp, pending.n_rows)
        pending.routed = True
        try:
            self._send_pending(pending, slot)
        except DeviceLostError:
            pending.routed = False
            self.router.release(slot)
            self.router.failure(slot)
            raise

    def _resubmit(self, pending: _Pending) -> None:
        """Re-enter routing for a retryable typed error (the slot
        already settled — its load released when the reply landed)."""
        pending.rearm()
        self._route_and_send(pending)

    # -- connection-loss path ------------------------------------------

    def _conn_lost(self, conn: _WorkerConn, err) -> None:
        """Reader thread exit.  For an UNPLANNED loss: trip the
        slot's breaker, then requeue each in-flight request exactly
        once; a request already requeued settles typed."""
        with self._lock:
            current = self._conns.get(conn.slot) is conn
        stranded = conn.drain_pending()
        if conn.orderly and not stranded:
            return
        if current and not conn.orderly:
            self._count("conn_losses")
            self.router.failure(conn.slot)
            with self._lock:
                self._conns.pop(conn.slot, None)
            self.router.remove_worker(conn.slot)
        lost = DeviceLostError(
            f"fleet worker {conn.worker_id!r} (slot {conn.slot}) "
            f"connection lost" + (f": {err}" if err else ""),
            device_label=f"worker:{conn.worker_id}",
        )
        for pending in stranded:
            if pending.routed:
                pending.routed = False
                self.router.release(pending.slot)
            if pending.requeued:
                self._count("requeue_failures")
                pending.settle_error(lost)
                continue
            pending.requeued = True
            try:
                self._route_and_send(pending)
                self._count("requeued")
            except AMGXTPUError as e:
                pending.settle_error(e)

    # -- submission ----------------------------------------------------

    def submit(self, A, b, x0=None, *, tenant: str = "default",
               lane: str = "interactive",
               deadline_s: Optional[float] = None) -> FleetTicket:
        """Route one system to a fleet worker; returns a
        :class:`FleetTicket`.  Raises typed ``Overloaded`` when no
        workers are attached."""
        from amgx_tpu_torch.serve.service import _host_csr

        row_offsets, col_indices, values, n, fp = _host_csr(A)
        header = {
            "verb": wire.VERB_SUBMIT,
            "tenant": str(tenant),
            "lane": str(lane),
            "deadline_s": deadline_s,
            "n": int(n),
            "fp": fp,
        }
        trace = wire.trace_carrier()
        if trace is not None:
            header["trace"] = trace
        arrays = {
            "row_offsets": np.asarray(row_offsets),
            "col_indices": np.asarray(col_indices),
            "values": np.asarray(values),
            "b": _host(b),
        }
        if x0 is not None:
            arrays["x0"] = _host(x0)
        pending = _Pending(header, arrays, fp, n)
        self._route_and_send(pending)
        self._count("submitted")
        return FleetTicket(self, pending)

    def solve(self, A, b, x0=None, *, tenant: str = "default",
              lane: str = "interactive",
              deadline_s: Optional[float] = None,
              timeout: Optional[float] = None):
        """Submit and wait — the one-call face."""
        return self.submit(
            A, b, x0, tenant=tenant, lane=lane, deadline_s=deadline_s
        ).result(timeout)

    def flush(self) -> None:
        """Face-compat no-op (workers flush on their own cadence)."""

    # -- control-plane verbs -------------------------------------------

    def _call(self, slot: int, header: dict, arrays=None,
              timeout: Optional[float] = 30.0) -> tuple:
        pending = _Pending(header, arrays or {}, None, 0)
        pending.requeued = True  # control verbs never re-route
        self._send_pending(pending, slot)
        kind, a, b = pending.wait(timeout)
        if kind == "raise":
            raise a
        err = a.get("error")
        if err is not None:
            raise wire.unmarshal_error(err)
        return a, b

    def health(self, slot: int, timeout: Optional[float] = 30.0) -> dict:
        header, _ = self._call(
            slot, {"verb": wire.VERB_HEALTH}, timeout=timeout
        )
        return header["health"]

    def ping(self, slot: int, timeout: Optional[float] = 10.0) -> bool:
        header, _ = self._call(
            slot, {"verb": wire.VERB_PING}, timeout=timeout
        )
        return bool(header.get("pong"))

    def metrics_text(self, slot: int,
                     timeout: Optional[float] = 30.0) -> str:
        header, _ = self._call(
            slot, {"verb": wire.VERB_METRICS}, timeout=timeout
        )
        return str(header.get("metrics_text", ""))

    def drain_worker(self, slot: int,
                     timeout: Optional[float] = 60.0) -> dict:
        """Drain a worker over the wire (it settles every admitted
        ticket, exports hierarchies + sessions to the shared store,
        replies its drain report and exits)."""
        with self._lock:
            conn = self._conns.get(slot)
        if conn is not None:
            conn.orderly = True  # its exit is planned, not a failure
        header, _ = self._call(
            slot,
            {"verb": wire.VERB_DRAIN, "timeout_s": timeout},
            timeout=(timeout or 0) + 30.0,
        )
        return header["drain"]

    # -- telemetry -----------------------------------------------------

    def telemetry_snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
        snap = {
            "counters": counters,
            "routing": self.router.snapshot(),
            "retry": {
                "retries": self.retry_policy.retries,
                "giveups": self.retry_policy.giveups,
            },
            "wire_latency": self.wire_latency.summary(),
        }
        return snap

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            conn.close(orderly=True)
