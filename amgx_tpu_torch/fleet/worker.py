"""FleetWorker: one process, one SolveGateway, one wire endpoint (the
JAX package's ``fleet/worker.py``).

The worker wraps a :class:`~amgx_tpu_torch.serve.gateway.SolveGateway`
(admission, batching, placement, sessions: the port's whole serving
stack in one process) and serves the :mod:`~amgx_tpu_torch.fleet.wire`
protocol over an asyncio socket:

* ``submit``: rebuild the CSR system from the frame's arrays,
  ``await gateway.solve(...)``, reply the solution arrays; a taxonomy
  error replies as a marshalled typed error (an ``AdmissionRejected``
  shed here is an ``AdmissionRejected`` at the client, ``retry_after_s``
  intact).
* ``health``: the gateway's health view, the worker's identity and the
  warm-boot evidence (``coarsen_calls`` / ``restored`` over the cached
  entries) a rolling restart is held to.
* ``drain``: ``gateway.drain()`` settles every admitted ticket and
  exports hierarchies and sessions to the shared ArtifactStore; the
  report crosses the wire, then the worker withdraws from the registry
  and exits.  Its replacement warm-boots from the same store.
* ``metrics``: the process's Prometheus text exposition.
* ``ping``, and ``session_open`` / ``session_step`` / ``session_close``,
  the streaming-session face.

Garbage on a connection (bad magic, truncated frames, unknown verbs) is
answered with a typed error frame where a reply is still possible and
the connection is dropped; the worker never dies of wire input.  Each
request runs in its own asyncio task.

The worker solves on one device: ``--device`` (default ``cuda``, the
current card; the port's entry points all take it).  Without a card a
``cuda`` worker raises before it announces itself, and it loads every
kernel library first: a kernel that fails to load fails the worker.
Several workers may share one card, each with its own CUDA context.

    python -m amgx_tpu_torch.fleet.worker --registry /run/fleet \\
        --store /var/amgx/store --worker-id w0 --slot 0 [--device cuda]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys
import time
from typing import Optional

import numpy as np

from amgx_tpu_torch.core.errors import AMGXTPUError
from amgx_tpu_torch.fleet import wire
from amgx_tpu_torch.fleet.registry import WorkerRecord, WorkerRegistry

_HEARTBEAT_S = 2.0


def _result_arrays(res) -> dict:
    """A SolveResult's fields as wire arrays (scalars as 0-d arrays, x
    read back to the host)."""
    from amgx_tpu_torch.core.types import host_array

    return {
        "x": host_array(res.x),
        "iters": np.asarray(res.iters),
        "status": np.asarray(res.status),
        "final_norm": np.asarray(res.final_norm),
        "initial_norm": np.asarray(res.initial_norm),
        "history": np.asarray(res.history),
    }


def _entry_setup_evidence(service) -> dict:
    """Warm-boot evidence over the hierarchy cache: the coarsening calls
    the cached entries' AMG setups ran, and how many entries were
    restored from the store.  A rolling restart's replacement shows
    ``coarsen_calls == 0`` and ``restored > 0`` on its repeat
    fingerprints."""
    total_coarsen = restored = entries = 0
    try:
        with service.cache._lock:
            solvers = [e.solver for e in service.cache._entries.values()]
    except Exception:  # noqa: BLE001 — evidence, not control flow
        return {"entries": 0, "coarsen_calls": 0, "restored": 0}
    for solver in solvers:
        entries += 1
        # the preconditioner chain down to the AMG solver (a smoother
        # preconditioner has no setup_stats: it coarsens nothing)
        node, stats = solver, None
        for _ in range(4):
            if node is None:
                break
            stats = getattr(node, "setup_stats", None)
            if isinstance(stats, dict):
                break
            stats = None
            node = getattr(node, "precond", None)
        if stats is None:
            continue
        total_coarsen += int(stats.get("coarsen_calls", 0) or 0)
        if stats.get("restored"):
            restored += 1
    return {"entries": entries, "coarsen_calls": total_coarsen,
            "restored": restored}


class FleetWorker:
    """One wire-serving solve process.  Construct, then :meth:`run`
    (blocking; the CLI entry point) or ``await`` :meth:`serve` inside a
    running loop.  ``gateway_kwargs`` (``config``, ``device``,
    ``max_batch``, ...) build the gateway's service."""

    def __init__(self, worker_id: str, registry_dir: str, *,
                 store=None, host: str = "127.0.0.1", port: int = 0,
                 slot: int = 0, max_inflight: int = 256,
                 placement=None, gateway=None,
                 flush_interval_s: float = 0.005,
                 warm_compile: bool = False, **gateway_kwargs):
        from amgx_tpu_torch.serve.gateway import SolveGateway

        self.worker_id = str(worker_id)
        self.registry = WorkerRegistry(registry_dir)
        self.slot = int(slot)
        self._host = host
        self._port = int(port)
        if gateway is not None:
            self.gateway = gateway
        else:
            svc_kwargs = dict(gateway_kwargs)
            if placement is not None:
                svc_kwargs["placement"] = placement
            self.gateway = SolveGateway(store=store,
                                        max_inflight=max_inflight,
                                        **svc_kwargs)
        self._flush_interval_s = float(flush_interval_s)
        self._warm_compile = bool(warm_compile)
        self.warm_booted = 0
        self._server = None
        self._record: Optional[WorkerRecord] = None
        self._shutdown = asyncio.Event()
        self._draining = False
        self._sessions: dict = {}  # session_id -> SolveSession
        self._requests: set = set()  # request tasks of every connection
        self.frames_in = 0
        self.frames_out = 0
        self.wire_errors = 0
        self.started_at = time.time()

    # -- identity ------------------------------------------------------

    def dist_capable(self) -> bool:
        """Whether this worker's placement shards oversized patterns
        (never, in the port: its one policy is ``SingleDevicePolicy``)."""
        pol = self.gateway.service.placement
        return getattr(pol, "telemetry_kind", None) == "dist"

    @property
    def address(self) -> tuple:
        return (self._host, self._port)

    # -- lifecycle -----------------------------------------------------

    async def serve(self):
        """Warm-boot, announce, serve until drained or cancelled."""
        if self.gateway.service.store is not None:
            self.warm_booted = self.gateway.service.warm_boot(
                wait=True, compile=self._warm_compile)
        self.gateway.start(self._flush_interval_s)
        self._server = await asyncio.start_server(
            self._handle_conn, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        self._record = WorkerRecord(
            self.worker_id, self._host, self._port, os.getpid(),
            slot=self.slot, dist_capable=self.dist_capable(),
            extra={"warm_booted": self.warm_booted})
        self.registry.announce(self._record)
        hb = asyncio.ensure_future(self._heartbeat_loop())
        try:
            await self._shutdown.wait()
        finally:
            hb.cancel()
            self._server.close()
            # the connection handlers (parked on reads) close their
            # sockets as they are cancelled: wait_closed() waits for
            # every connection to close
            me = asyncio.current_task()
            others = [t for t in asyncio.all_tasks() if t is not me]
            for t in others:
                t.cancel()
            await asyncio.gather(*others, return_exceptions=True)
            await self._server.wait_closed()
            self.registry.withdraw(self.worker_id)
            if not self._draining:
                # cancelled without a drain: stop the poller anyway
                try:
                    self.gateway.stop()
                except Exception:  # noqa: BLE001
                    pass

    def run(self):
        """Blocking entry point (the spawned subprocess's main)."""
        asyncio.run(self.serve())

    async def _heartbeat_loop(self):
        while True:
            await asyncio.sleep(_HEARTBEAT_S)
            try:
                self.registry.heartbeat(self._record)
            except OSError:
                pass

    # -- connection handling -------------------------------------------

    async def _handle_conn(self, reader, writer):
        wlock = asyncio.Lock()
        tasks = set()
        try:
            while True:
                try:
                    header, arrays = await wire.read_frame_async(reader)
                except wire.WireClosed:
                    return
                except wire.WireError as e:
                    # garbage: answer typed (best effort), drop the
                    # connection, keep the worker
                    self.wire_errors += 1
                    await self._reply_error(writer, wlock, None, e)
                    return
                self.frames_in += 1
                t = asyncio.ensure_future(
                    self._dispatch(header, arrays, writer, wlock))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
                self._requests.add(t)
                t.add_done_callback(self._requests.discard)
        finally:
            for t in tasks:
                t.cancel()
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _send(self, writer, wlock, header, arrays=None):
        frame = wire.pack_frame(header, arrays)
        async with wlock:
            writer.write(frame)
            await writer.drain()
        self.frames_out += 1

    async def _reply_error(self, writer, wlock, rid, exc):
        try:
            await self._send(writer, wlock, {
                "verb": wire.VERB_RESULT, "rid": rid,
                "error": wire.marshal_error(exc)})
        except (OSError, wire.WireError):
            pass  # the peer is gone

    async def _dispatch(self, header, arrays, writer, wlock):
        rid = header.get("rid")
        verb = header.get("verb")
        try:
            if verb == wire.VERB_SUBMIT:
                await self._do_submit(header, arrays, writer, wlock)
            elif verb == wire.VERB_HEALTH:
                await self._send(writer, wlock, {
                    "verb": wire.VERB_RESULT, "rid": rid,
                    "health": self._health_view()})
            elif verb == wire.VERB_PING:
                await self._send(writer, wlock, {
                    "verb": wire.VERB_RESULT, "rid": rid, "pong": True})
            elif verb == wire.VERB_METRICS:
                await self._send(writer, wlock, {
                    "verb": wire.VERB_RESULT, "rid": rid,
                    "metrics_text": self._metrics_text()})
            elif verb == wire.VERB_DRAIN:
                await self._do_drain(header, writer, wlock)
            elif verb == wire.VERB_SESSION_OPEN:
                await self._do_session_open(header, arrays, writer, wlock)
            elif verb == wire.VERB_SESSION_STEP:
                await self._do_session_step(header, arrays, writer, wlock)
            elif verb == wire.VERB_SESSION_CLOSE:
                await self._do_session_close(header, writer, wlock)
            else:
                self.wire_errors += 1
                await self._reply_error(
                    writer, wlock, rid,
                    wire.WireError(f"unknown verb {verb!r}"))
        except asyncio.CancelledError:
            raise
        except AMGXTPUError as e:
            await self._reply_error(writer, wlock, rid, e)
        except Exception as e:  # noqa: BLE001 — cross the wire typed
            await self._reply_error(
                writer, wlock, rid,
                AMGXTPUError(f"{type(e).__name__}: {e}"))

    # -- verb handlers -------------------------------------------------

    @staticmethod
    def _csr_from(header, arrays):
        import scipy.sparse as sp

        n = int(header["n"])
        A = sp.csr_matrix((arrays["values"], arrays["col_indices"],
                           arrays["row_offsets"]), shape=(n, n))
        fp = header.get("fp")
        if fp:
            # the client fingerprinted this structure: memoized, so that
            # the service's _host_csr agrees without hashing it again
            A._amgx_tpu_fp = str(fp)
        return A

    @staticmethod
    def _deadline(header):
        d = header.get("deadline_s")
        return float(d) if d is not None else None

    async def _do_submit(self, header, arrays, writer, wlock):
        from amgx_tpu_torch.telemetry import tracing

        rid = header.get("rid")
        ctx = wire.trace_from_carrier(header.get("trace"))
        t0 = time.perf_counter()
        A = self._csr_from(header, arrays)
        with tracing.use_context(ctx):
            res = await self.gateway.solve(
                A, np.asarray(arrays["b"]), arrays.get("x0"),
                tenant=str(header.get("tenant", "default")),
                lane=str(header.get("lane", "interactive")),
                deadline_s=self._deadline(header))
            if ctx is not None:
                tracing.record_span("wire_serve", t0, time.perf_counter(),
                                    ctx, args={"worker": self.worker_id})
        await self._send(writer, wlock,
                         {"verb": wire.VERB_RESULT, "rid": rid},
                         _result_arrays(res))

    def _health_view(self) -> dict:
        h = self.gateway.health()
        h["worker"] = {
            "worker_id": self.worker_id,
            "pid": os.getpid(),
            "slot": self.slot,
            "dist_capable": self.dist_capable(),
            "warm_booted": self.warm_booted,
            "uptime_s": time.time() - self.started_at,
            "frames_in": self.frames_in,
            "frames_out": self.frames_out,
            "wire_errors": self.wire_errors,
        }
        m = self.gateway.service.metrics
        h["serve"] = {k: m.get(k) for k in (
            "setups", "cache_hits", "cache_misses", "compiles",
            "solves")}
        h["setup_evidence"] = _entry_setup_evidence(self.gateway.service)
        return h

    def _metrics_text(self) -> str:
        from amgx_tpu_torch.telemetry import get_registry

        return get_registry().render_prometheus()

    async def _do_drain(self, header, writer, wlock):
        rid = header.get("rid")
        self._draining = True
        timeout_s = float(header.get("timeout_s", 30.0))
        loop = asyncio.get_running_loop()
        report = await loop.run_in_executor(
            None, lambda: self.gateway.drain(timeout_s=timeout_s))
        # the drain settled every admitted ticket: let their replies go
        # out before the shutdown cancels the request tasks
        me = asyncio.current_task()
        replies = [t for t in self._requests if t is not me]
        if replies:
            await asyncio.wait(replies, timeout=timeout_s)
        await self._send(writer, wlock, {
            "verb": wire.VERB_RESULT, "rid": rid, "drain": report})
        self._shutdown.set()

    # -- streaming sessions --------------------------------------------

    async def _do_session_open(self, header, arrays, writer, wlock):
        rid = header.get("rid")
        A = self._csr_from(header, arrays)
        loop = asyncio.get_running_loop()
        sess = await loop.run_in_executor(None, lambda: (
            self.gateway.restore_session(header["session_id"])
            if header.get("restore")
            else self.gateway.open_session(
                A, session_id=header.get("session_id"),
                tenant=str(header.get("tenant", "default")),
                lane=str(header.get("lane", "interactive")),
                deadline_s=self._deadline(header))))
        self._sessions[sess.session_id] = sess
        await self._send(writer, wlock, {
            "verb": wire.VERB_RESULT, "rid": rid,
            "session_id": sess.session_id})

    def _session(self, header):
        sid = str(header.get("session_id"))
        sess = self._sessions.get(sid)
        if sess is None:
            raise AMGXTPUError(f"unknown session {sid!r}")
        return sess

    async def _do_session_step(self, header, arrays, writer, wlock):
        rid = header.get("rid")
        sess = self._session(header)
        ticket = sess.step(arrays.get("values"), arrays["b"])
        self.gateway.flush()
        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(None, ticket.result)
        await self._send(writer, wlock,
                         {"verb": wire.VERB_RESULT, "rid": rid},
                         _result_arrays(res))

    async def _do_session_close(self, header, writer, wlock):
        rid = header.get("rid")
        sess = self._sessions.pop(str(header.get("session_id")), None)
        saved = False
        if sess is not None:
            loop = asyncio.get_running_loop()
            try:
                await loop.run_in_executor(None, sess.save)
                saved = True
            except Exception:  # noqa: BLE001 — close is best-effort
                saved = False
        await self._send(writer, wlock, {
            "verb": wire.VERB_RESULT, "rid": rid, "saved": saved})


# ----------------------------------------------------------------------
# CLI


def main(argv=None, **worker_kwargs) -> int:
    """The worker process: parse the flags, check the device (a ``cuda``
    worker raises without a card and loads every kernel library before
    it announces itself), serve until drained or signalled.
    ``worker_kwargs`` reach :class:`FleetWorker` (a ``config`` from a
    launcher that imports this module, for instance)."""
    p = argparse.ArgumentParser(
        description="amgx_tpu_torch fleet worker: serve one SolveGateway "
        "over the fleet wire protocol")
    p.add_argument("--registry", required=True,
                   help="worker-registry directory (shared)")
    p.add_argument("--worker-id", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 binds an ephemeral port (announced in the "
                   "registry)")
    p.add_argument("--store", default=None,
                   help="shared ArtifactStore directory (warm boot and "
                   "drain export)")
    p.add_argument("--slot", type=int, default=0)
    p.add_argument("--max-inflight", type=int, default=256)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--warm-compile", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the device the worker solves on (default: the "
                   "current CUDA card; 'cpu' runs the kernels' plain "
                   "PyTorch versions)")
    args = p.parse_args(argv)

    from amgx_tpu_torch.core.device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        # no card (or no such device): refused before any announce
        p.error(f"--device {args.device}: {e}")
    if device.type == "cuda":
        from amgx_tpu_torch.ops import kernels

        for name in kernels.SOURCES:
            kernels.library(name)

    store = None
    if args.store:
        from amgx_tpu_torch.store import ArtifactStore

        store = ArtifactStore(args.store)

    kw = {"max_batch": args.max_batch, **worker_kwargs}
    worker = FleetWorker(
        args.worker_id, args.registry, store=store, host=args.host,
        port=args.port, slot=args.slot, max_inflight=args.max_inflight,
        warm_compile=args.warm_compile, device=device, **kw)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, worker._shutdown.set)
        except (NotImplementedError, RuntimeError):
            pass
    try:
        loop.run_until_complete(worker.serve())
    finally:
        loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
