"""Tracing and profiling hooks (the JAX package's ``core/profiling.py``;
reference amgx_timer.h:32-60 nvtxRange and levelProfile, profile.h
phase markers).

Setup phases: ``setup_fastpath_enabled`` selects the cold-setup fast
path of the host coarsening (``AMGX_TPU_TORCH_SETUP_FASTPATH=0`` selects
the reference forms; both give the same hierarchy bit for bit).  The
port reads its own variable, so the JAX package's
``AMGX_TPU_SETUP_FASTPATH`` leaves it as it is.  The AMG solver opens a
:func:`setup_profile_scope` around hierarchy construction and the
coarsening code wraps its stages in :func:`setup_phase`, which adds
their wall-clock seconds to the active profile (and, with request
tracing on, records a ``setup:<name>`` span on the telemetry timeline).
The scope stack is thread-local, so concurrent setups never write into
each other's profiles.  :func:`count_setup_sync` counts a device-to-host
read of the classical device setup (``amg/device_setup.py``) into the
active profile's ``syncs``.

Spans: NVTX ranges map to ``torch.profiler.record_function``, the
counterpart of ``jax.profiler.TraceAnnotation`` and ``jax.named_scope``:
:func:`trace_range` around API calls (it also records a telemetry span
when request tracing is sampled on) and :func:`named_scope` around
compute.  :class:`LevelProfile` is the accumulating tic/toc phase map,
:class:`LatencyReservoir` the bounded ring behind the serve layer's
latency quantiles, and :func:`profile_cycle` measures one V-cycle phase
by phase per level (reference fixed_cycle.cu:61-110).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict


def setup_fastpath_enabled() -> bool:
    """Cold-setup fast path: on by default;
    ``AMGX_TPU_TORCH_SETUP_FASTPATH=0`` selects the reference forms
    (``ufunc.at`` row reductions).  Read per call so tests can toggle
    it mid-process."""
    return os.environ.get("AMGX_TPU_TORCH_SETUP_FASTPATH", "1") != "0"


_setup_tls = threading.local()


def _setup_stack():
    st = getattr(_setup_tls, "stack", None)
    if st is None:
        st = _setup_tls.stack = []
    return st


@contextlib.contextmanager
def setup_profile_scope(profile: dict):
    """Activate ``profile`` as this thread's setup-phase sink; nested
    scopes shadow outer ones."""
    st = _setup_stack()
    st.append(profile)
    try:
        yield profile
    finally:
        st.pop()


def active_setup_profile() -> dict | None:
    st = _setup_stack()
    return st[-1] if st else None


@contextlib.contextmanager
def setup_phase(name: str):
    """Add the wall-clock seconds of one setup phase (strength,
    cf_split, interp, rap_execute, ...) to the active profile; with
    request tracing on (``AMGX_TPU_TRACE_SAMPLE``), also record a
    ``setup:<name>`` span, so setup phases land on the same timeline as
    the serve spans.  A no-op outside a scope with tracing off."""
    prof = active_setup_profile()
    tracer = _span_recorder()
    if prof is None and tracer is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        if prof is not None:
            prof[name] = prof.get(name, 0.0) + t1 - t0
        if tracer is not None:
            tracer(f"setup:{name}", t0, t1)


def _span_recorder():
    """A ``record(name, t0, t1)`` telemetry span hook when request
    tracing is sampled on, else None (lazy import: the telemetry
    package depends on nothing here)."""
    from amgx_tpu_torch.telemetry import tracing as _tracing

    if not _tracing.tracing_enabled():
        return None

    def rec(name, t0, t1):
        _tracing.record_span(name, t0, t1, _tracing.ambient())

    return rec


def count_setup_sync(n: int = 1):
    """Add ``n`` device-to-host reads made during setup to the active
    profile's ``syncs``; a no-op outside a scope."""
    prof = active_setup_profile()
    if prof is not None:
        prof["syncs"] = prof.get("syncs", 0) + n


class _TracedRange:
    """``record_function`` plus a telemetry span: the torch profiler
    sees the range, and the telemetry span buffer gets the same
    interval attributed to the thread's ambient trace context."""

    __slots__ = ("_name", "_ann", "_rec", "_t0")

    def __init__(self, name, ann, rec):
        self._name = name
        self._ann = ann
        self._rec = rec

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        self._ann.__exit__(*exc)
        self._rec(self._name, self._t0, time.perf_counter())
        return False


def trace_range(name: str):
    """Host-side range around an API call (the NVTX range of reference
    amgx_c.cu:2747, a ``torch.profiler.record_function``).  With request
    tracing sampled on, the same interval also lands in the telemetry
    span buffer (one timeline for API ranges, setup phases and serve
    spans)."""
    import torch

    ann = torch.profiler.record_function(name)
    rec = _span_recorder()
    if rec is None:
        return ann
    return _TracedRange(name, ann, rec)


def named_scope(name: str):
    """Compute scope: labels the ops launched inside it in a
    ``torch.profiler`` trace (the JAX package's ``jax.named_scope``)."""
    import torch

    return torch.profiler.record_function(name)


def percentile(samples, q: float) -> float | None:
    """Linear-interpolated percentile of a sequence (q in [0, 100]).
    With one sample every percentile is it; an empty sequence gives
    None (never NaN or IndexError), so "no data" is not "0 s"."""
    xs = sorted(samples)
    if not xs:
        return None
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class LatencyReservoir:
    """Bounded ring of latency samples for tail quantiles (p50 / p99 of
    the serve layer's per-ticket latency).  A ring, not a sketch: the
    question is about recent behaviour, and ``cap`` bounds memory.
    Thread safety is the caller's (``ServeMetrics`` holds its lock
    around ``add`` / ``summary``)."""

    def __init__(self, cap: int = 2048):
        self.cap = int(cap)
        self._samples: list = []
        self._next = 0
        self.count = 0  # lifetime samples, beyond the ring

    def add(self, seconds: float):
        s = float(seconds)
        if len(self._samples) < self.cap:
            self._samples.append(s)
        else:
            self._samples[self._next] = s
            self._next = (self._next + 1) % self.cap
        self.count += 1

    def clear(self):
        """Drop all samples (e.g. warm-up tickets before a steady-state
        window)."""
        self._samples.clear()
        self._next = 0
        self.count = 0

    def percentile(self, q: float) -> float | None:
        """Percentile of the ring, or None before any sample."""
        return percentile(self._samples, q)

    def summary(self) -> dict:
        xs = self._samples
        return {
            "count": self.count,
            "mean_s": sum(xs) / len(xs) if xs else 0.0,
            # float-valued (0.0 when empty) for the exporters; the None
            # contract lives on percentile()
            "p50_s": percentile(xs, 50.0) or 0.0,
            "p99_s": percentile(xs, 99.0) or 0.0,
            "max_s": max(xs) if xs else 0.0,
        }


class LevelProfile:
    """Accumulating tic/toc phase map (reference amgx_timer.h:46-60).

    Thread-safe: a serve service writes one from submit threads and the
    flusher while a telemetry snapshot may read it.  Mutate through
    :meth:`phase` / :meth:`add`, read through :meth:`snapshot` (the
    ``times`` / ``counts`` attributes remain for single-threaded
    callers such as :func:`profile_cycle`)."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float, count: int = 1):
        with self._lock:
            self.times[name] += float(seconds)
            self.counts[name] += count

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        """Consistent copy: ``{"times": ..., "counts": ...}``."""
        with self._lock:
            return {"times": dict(self.times), "counts": dict(self.counts)}

    def table(self) -> str:
        snap = self.snapshot()
        times, counts = snap["times"], snap["counts"]
        lines = ["    phase                          calls      total_s"]
        for k in sorted(times):
            lines.append(
                f"    {k:<30s} {counts[k]:>5d} {times[k]:>12.6f}"
            )
        return "\n".join(lines)


def profile_cycle(amg, b, reps: int = 3) -> LevelProfile:
    """Measure one V-cycle phase by phase per level (the observability
    of the reference's per-level profile).

    Each phase is built once (one fault plan, as the JAX package jits
    each phase once), run once to warm up, then timed over ``reps``
    runs: on the card between two CUDA events around the runs (kernel
    and launch time, no host sync inside), on the CPU by the host
    clock.  The recorded time is the mean of a run.  ``amg`` is a
    set-up AMG solver and ``b`` a finest-level vector on its device;
    the keys are the JAX package's,
    ``level{i}/{smooth_pre,residual,restrict,prolong,smooth_post}`` and
    ``coarse/solve`` (``coarse/smooth`` without a coarse solver).
    Relative per-level attribution: each phase starts from a
    synchronised device."""
    import torch

    from amgx_tpu_torch.core import faults
    from amgx_tpu_torch.ops.spmv import spmv

    prof = LevelProfile()
    level_params, coarse_params = amg.apply_params()
    smooth_fns = [
        lvl.smoother.make_smooth() if lvl.smoother else None
        for lvl in amg.levels
    ]
    coarse_apply = (
        amg.coarse_solver.make_apply() if amg.coarse_solver else None
    )
    b = torch.as_tensor(b)
    cuda = b.device.type == "cuda"

    def cast(v, dt):
        return v if v.dtype == dt else v.to(dt)

    def timed(key, fn, *args):
        fn = faults.built(fn)
        out = fn(*args)  # warm-up, its result discarded
        if cuda:
            torch.cuda.synchronize(b.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(*args)
            dt = (time.perf_counter() - t0) / reps
        prof.times[key] += dt
        prof.counts[key] += 1
        return out

    def residual(A, bb, x):
        return bb - spmv(A, x)

    n_levels = len(amg.levels)
    dts = [lvl.A.dtype for lvl in amg.levels]
    bs = [cast(b, dts[0])]
    xs = []
    # downward pass
    for i in range(n_levels - 1):
        A, P, R, smp = level_params[i]
        pre, post = amg._level_sweeps(i)
        x = torch.zeros_like(bs[i])
        if pre > 0:
            x = timed(f"level{i}/smooth_pre", smooth_fns[i], smp, bs[i], x,
                      pre)
        r = timed(f"level{i}/residual", residual, A, bs[i], x)
        bc = timed(f"level{i}/restrict", spmv, R, r)
        xs.append(x)
        bs.append(cast(bc, dts[i + 1]))
    # coarsest
    i = n_levels - 1
    A, P, R, smp = level_params[i]
    xc = torch.zeros_like(bs[i])
    if coarse_apply is not None:
        xc = timed("coarse/solve", coarse_apply, coarse_params, bs[i])
    elif smooth_fns[i] is not None:
        xc = timed("coarse/smooth", smooth_fns[i], smp, bs[i], xc,
                   amg.coarsest_sweeps)
    # upward pass
    for i in range(n_levels - 2, -1, -1):
        A, P, R, smp = level_params[i]
        pre, post = amg._level_sweeps(i)
        corr = timed(f"level{i}/prolong", spmv, P, cast(xc, dts[i + 1]))
        x = xs[i] + cast(corr, xs[i].dtype)
        if post > 0:
            x = timed(f"level{i}/smooth_post", smooth_fns[i], smp, bs[i], x,
                      post)
        xc = x
    return prof
