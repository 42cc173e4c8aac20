"""End-to-end request tracing: trace contexts, a bounded span ring,
and Chrome trace-event export (Perfetto-loadable); the JAX package's
``telemetry/tracing.py``.

A trace is minted per request at :meth:`BatchedSolveService.submit`
(or per step at a session's ``prestage``) and threaded through
staging -> flush-group formation -> dispatch -> device -> fetch; each
stage records a *completed* span (name, start, end) into one
process-wide bounded ring.  Group-formation spans carry the member
tickets' trace ids in their args, so a Perfetto view shows exactly
which requests shared a batch and where a slow ticket spent its time.
A request through the gateway (``serve/gateway.py``) has its root
minted there, with an ``admission`` span before the service's.

Sampling (``AMGX_TPU_TRACE_SAMPLE``, default 0 = off) is
deterministic — every round(1/rate)-th minted trace is sampled, no
RNG — so test runs and incident reproductions see the same spans.
When tracing is off the hot-path surface is a single float compare:
:func:`new_trace` returns ``None`` without allocating, and every
``record_*`` helper early-outs on a ``None`` context.

Export is :func:`export_chrome`: the standard
``{"traceEvents": [...]}`` JSON with ``"ph": "X"`` complete events,
microsecond timestamps relative to process start, one ``tid`` row per
trace so a request's submit -> pad -> queue -> dispatch -> device ->
fetch chain renders as one nested lane.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Optional

# timestamps are perf_counter seconds; the exporter rebases onto this
# process epoch so Chrome ts values start near zero
_EPOCH = time.perf_counter()

_lock = threading.Lock()
_rate_override: Optional[float] = None
_mint_seq = itertools.count()
_id_seq = itertools.count(1)


def set_sample_rate(rate: Optional[float]) -> None:
    """Override the env sampling rate (tests/CI); ``None`` restores
    the ``AMGX_TPU_TRACE_SAMPLE`` environment value."""
    global _rate_override
    _rate_override = None if rate is None else float(rate)


_env_rate_cache = (None, 0.0)  # (raw env string, parsed rate)


def sample_rate() -> float:
    if _rate_override is not None:
        return _rate_override
    # memoize the parse on the raw string: this runs several times per
    # submit even with tracing off, so the steady state must be one
    # env lookup + one string compare, not a float() parse
    global _env_rate_cache
    raw = os.environ.get("AMGX_TPU_TRACE_SAMPLE")
    cached_raw, cached_val = _env_rate_cache
    if raw == cached_raw:
        return cached_val
    try:
        val = float(raw or 0.0)
    except ValueError:
        val = 0.0
    _env_rate_cache = (raw, val)
    return val


def tracing_enabled() -> bool:
    return sample_rate() > 0.0


class TraceContext:
    """Identity of one sampled request: ``trace_id`` names the
    request across every span; ``root_id`` is the root span's id
    (children parent onto it); ``tid`` is the Chrome row."""

    __slots__ = ("trace_id", "root_id", "tid")

    def __init__(self, trace_id: str, root_id: int, tid: int):
        self.trace_id = trace_id
        self.root_id = root_id
        self.tid = tid


def new_trace() -> Optional[TraceContext]:
    """Mint a sampled trace context, or None (not sampled / tracing
    off).  The off path is allocation-free."""
    rate = sample_rate()
    if rate <= 0.0:
        return None
    n = next(_mint_seq)
    if rate < 1.0:
        period = max(int(round(1.0 / rate)), 1)
        if n % period:
            return None
    sid = next(_id_seq)
    return TraceContext(f"t{os.getpid():x}-{n:x}", sid, sid)


# ----------------------------------------------------------------------
# span ring


def _buffer_cap() -> int:
    # clamp to >= 1: a 0/negative cap would make add() index an empty
    # ring on the solve hot path (same clamp as recorder._env_cap)
    try:
        return max(
            int(os.environ.get("AMGX_TPU_TRACE_BUFFER", "") or 16384), 1
        )
    except ValueError:
        return 16384


class SpanBuffer:
    """Bounded ring of completed spans (dicts).  A ring — recent
    behaviour is the question, memory must be bounded regardless of
    uptime; same stance as LatencyReservoir."""

    def __init__(self, cap: Optional[int] = None):
        self.cap = max(int(cap), 1) if cap is not None else _buffer_cap()
        self._lock = threading.Lock()
        self._spans: list = []
        self._next = 0
        self.total = 0  # lifetime spans, beyond the ring

    def add(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) < self.cap:
                self._spans.append(span)
            else:
                self._spans[self._next] = span
                self._next = (self._next + 1) % self.cap
            self.total += 1

    def spans(self) -> list:
        """Chronological copy of the ring."""
        with self._lock:
            return self._spans[self._next:] + self._spans[: self._next]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._next = 0

    def __len__(self):
        with self._lock:
            return len(self._spans)


_BUFFER = SpanBuffer()


def span_buffer() -> SpanBuffer:
    return _BUFFER


def clear() -> None:
    _BUFFER.clear()


def telemetry_snapshot() -> dict:
    """Registry source for the ``tracing`` component."""
    return {
        "spans_total": _BUFFER.total,
        "buffer_len": len(_BUFFER),
        "sample_rate": sample_rate(),
    }


# ----------------------------------------------------------------------
# recording

# thread-local ambient context: profiling hooks (trace_range,
# setup_phase) attach their spans to the current request when one is
# active on this thread, and to the process lane otherwise
_tls = threading.local()


def ambient() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


class use_context:
    """``with use_context(ctx):`` — make ``ctx`` the thread's ambient
    trace for profiling hooks running inside the block."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


# the process-wide lane spans fall onto when no request context is
# ambient (solver setups, background compiles): still on the timeline,
# just not attributed to one request
_PROC_TID = 0


def record_span(name: str, t0: float, t1: float,
                ctx: Optional[TraceContext] = None,
                parent: Optional[int] = None,
                args: Optional[dict] = None,
                root: bool = False) -> Optional[int]:
    """Record one completed span.  ``ctx=None`` with tracing enabled
    records onto the process lane (setup/background work);
    ``root=True`` claims the context's pre-minted root span id (so
    children recorded before the root closes still parent onto it).
    Returns the span id (for parenting) or None when tracing is
    off."""
    if not tracing_enabled():
        return None
    sid = ctx.root_id if (root and ctx is not None) else next(_id_seq)
    span = {
        "name": name,
        "sid": sid,
        "t0": t0,
        "t1": t1,
        "tid": ctx.tid if ctx is not None else _PROC_TID,
        "trace_id": ctx.trace_id if ctx is not None else None,
    }
    if ctx is not None and not root:
        span["parent"] = ctx.root_id if parent is None else parent
    elif parent is not None:
        span["parent"] = parent
    if args:
        span["args"] = args
    _BUFFER.add(span)
    return sid


class span_scope:
    """``with span_scope("name"):`` — time a block into the span ring
    under the thread's ambient context.  Cheap no-op when tracing is
    off (one enabled check, no allocation beyond the scope object)."""

    __slots__ = ("_name", "_args", "_t0", "_on")

    def __init__(self, name: str, args: Optional[dict] = None):
        self._name = name
        self._args = args

    def __enter__(self):
        self._on = tracing_enabled()
        if self._on:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._on:
            record_span(
                self._name, self._t0, time.perf_counter(),
                ambient(), args=self._args,
            )
        return False


# ----------------------------------------------------------------------
# export


def export_chrome(path: Optional[str] = None) -> dict:
    """Spans -> Chrome trace-event JSON (Perfetto / chrome://tracing
    loadable).  Returns the event dict; also writes it to ``path``
    when given.  Span times rebase onto the process epoch in
    microseconds; args carry trace/span/parent ids so tooling can
    reconstruct request chains exactly."""
    pid = os.getpid()
    events = []
    for s in _BUFFER.spans():
        args = {"trace_id": s.get("trace_id"), "span_id": s["sid"]}
        if "parent" in s:
            args["parent_id"] = s["parent"]
        if "args" in s:
            args.update(s["args"])
        events.append({
            "name": s["name"],
            "cat": "amgx_tpu_torch",
            "ph": "X",
            "ts": (s["t0"] - _EPOCH) * 1e6,
            "dur": max(s["t1"] - s["t0"], 0.0) * 1e6,
            "pid": pid,
            "tid": s["tid"],
            "args": args,
        })
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
