"""Deterministic, site-keyed fault injection (the JAX package's
``core/faults.py``; reference src/tests/smoother_nan_random.cu injects
NaN into smoother output to exercise the failure paths).

Every recovery path has a named *injection site* that forces its
failure mode on demand:

  ====================  ===================================================
  site                  effect when armed
  ====================  ===================================================
  smoother_nan          NaN written into the stationary-iteration update
                        (solvers/base.py monitored loops, make_smooth)
  dot_breakdown         a dot product of a built solve returns 0
                        (ops/blas.dot, fused_dots, gram_block)
  coarse_lu_zero_pivot  the densified coarse matrix is made exactly
                        singular before factorization (solvers/dense_lu)
  serve_compile         the serve layer's build of a group's batched
                        solve raises ResourceError (serve/service)
  capi_internal         an internal RuntimeError inside the C API solve
                        path (api/capi._solve_impl)
  telemetry_export      the flight recorder's record / incident and the
                        registry's collection and dump raise; telemetry
                        degrades to a counted ``telemetry_errors`` and
                        never fails a solve (telemetry/)
  gateway_shed          the gateway sheds a submit at the door, typed
                        ``Overloaded`` (serve/gateway)
  admission_quota       the admission controller refuses a tenant's
                        submit, ``AdmissionRejected`` reason ``quota``
                        (serve/admission)
  drain_timeout         a gateway drain gets no settle budget: its
                        unsettled tickets fail typed (serve/gateway)
  device_lost_dispatch  a group's ship to the device raises
                        ``DeviceLostError``; the service replans once
                        (serve/service)
  device_lost_fetch     a group's fetch raises ``DeviceLostError``; the
                        service re-dispatches from its retained copy
  fetch_hang            a group's fetch sleeps ``hang_seconds()`` on the
                        watchdog's daemon thread, as a hung card would
  ====================  ===================================================

**When a site fires.**  The JAX package consults a site while it traces
a solve: the compiled loop body is traced once, so a site inside it
corrupts every iteration of that executable while its budget drops by
one, and a retry re-traces and so escapes a spent budget.  This package
runs eagerly; the place of the trace is taken by the *build* of a
solve: :func:`built` wraps a function at the moment it is built
(``Solver.solve``'s ``make_solve``, a retry build, the serve layer's
batched solve of a template signature, ``profile_cycle``'s phases, the
counting runs).  A built function owns one plan of decisions: the
first time a run of it meets a place, the site's budget is consulted
once (:func:`decide`), and that decision holds for every later pass
through the place in that built function.  A rebuild takes fresh
decisions.  A *place* is where the JAX trace meets the site: each call
in straight-line code is its own place (a level's pre- and
post-smoothing are two, and so is each level of a cycle), while a loop
that the JAX package runs as ``lax.while_loop`` / ``fori_loop`` is a
:func:`loop` whose body holds its places once, whatever its iteration
count.  A place the run never reaches (a loop that runs no iteration)
takes no decision, where the JAX trace would take one.  Setup-time
sites (``coarse_lu_zero_pivot``) and host-side sites consult the
budget on every call, as in the JAX package; so does a site met
outside any built function.

No wall-clock or RNG dependence: behaviour is a pure function of (armed
sites, call order), so determinism re-runs with injection disabled are
bit for bit.  Nothing here sends a kernel's work to its plain version.

Arm programmatically (``arm`` / ``inject``) or through the environment:
``AMGX_TPU_FAULTS="smoother_nan,dot_breakdown:2"`` arms sites at first
use (count after ``:``, default 1, ``-1`` = unlimited).  The variable is
the JAX package's; this package keeps a budget of its own, so one armed
site fires once in each package.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
from collections import defaultdict

SITES = (
    "smoother_nan",
    "dot_breakdown",
    "coarse_lu_zero_pivot",
    "serve_compile",
    "capi_internal",
    "gateway_shed",
    "admission_quota",
    "drain_timeout",
    "telemetry_export",
    "device_lost_dispatch",
    "device_lost_fetch",
    "fetch_hang",
)

_lock = threading.Lock()
_armed: dict = {}  # site -> remaining budget (-1 = unlimited)
_fired: dict = defaultdict(int)  # site -> times fired
_env_loaded = [False]


def _load_env():
    if _env_loaded[0]:
        return
    _env_loaded[0] = True
    spec = os.environ.get("AMGX_TPU_FAULTS", "")
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        site, _, cnt = item.partition(":")
        if site not in SITES:
            # a typo would arm nothing and let every recovery check
            # pass vacuously: make it loud
            import warnings

            warnings.warn(
                f"AMGX_TPU_FAULTS: unknown fault site {site!r} "
                f"ignored; known sites: {SITES}"
            )
            continue
        _armed[site] = int(cnt) if cnt else 1


def arm(site: str, times: int = 1):
    """Grant ``site`` a fire budget (``-1`` = unlimited)."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; known: {SITES}")
    with _lock:
        _load_env()
        _armed[site] = times


def disarm(site: str | None = None):
    """Clear one site's budget, or all of them (``site=None``)."""
    with _lock:
        _load_env()
        if site is None:
            _armed.clear()
        else:
            _armed.pop(site, None)


def armed(site: str) -> bool:
    with _lock:
        _load_env()
        return _armed.get(site, 0) != 0


def should_fire(site: str) -> bool:
    """Consume one unit of ``site``'s budget; True when the caller
    must inject its fault."""
    with _lock:
        _load_env()
        left = _armed.get(site, 0)
        if left == 0:
            return False
        if left > 0:
            _armed[site] = left - 1
        _fired[site] += 1
        return True


def fired(site: str) -> int:
    """How many times ``site`` has fired since the last reset."""
    with _lock:
        return _fired.get(site, 0)


def reset_counters():
    with _lock:
        _fired.clear()


@contextlib.contextmanager
def inject(site: str, times: int = 1):
    """``with faults.inject("smoother_nan"):`` arms for the block and
    disarms (forgetting any unspent budget) on exit."""
    arm(site, times)
    try:
        yield
    finally:
        disarm(site)


def hang_seconds() -> float:
    """How long an armed ``fetch_hang`` sleeps
    (``AMGX_TPU_FAULT_HANG_S``, default 30 s)."""
    try:
        return float(os.environ.get("AMGX_TPU_FAULT_HANG_S", "") or 30.0)
    except ValueError:
        return 30.0


# ----------------------------------------------------------------------
# build-time decisions

_tls = threading.local()


class _Cursor:
    """Where a thread's run of a built function stands: its plan, the
    loop path it is in and the next place's ordinal in this pass."""

    __slots__ = ("plan", "path", "seq")

    def __init__(self, plan):
        self.plan = plan
        self.path = ()
        self.seq = 0


def built(fn):
    """Wrap ``fn`` at its build: the returned function owns one plan of
    fault decisions (the counterpart of one JAX trace), consulted by
    :func:`decide` on every run of it."""
    plan: dict = {}

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prev = getattr(_tls, "cur", None)
        _tls.cur = _Cursor(plan)
        try:
            return fn(*args, **kwargs)
        finally:
            _tls.cur = prev

    run.fault_plan = plan
    return run


def decide(site: str) -> bool:
    """Should ``site`` inject its fault here?  Inside a built function
    the first run to meet this place consults the budget and later
    passes reuse the decision; outside one, every call consults it."""
    cur = getattr(_tls, "cur", None)
    if cur is None:
        return should_fire(site)
    key = (cur.path, cur.seq, site)
    cur.seq += 1
    d = cur.plan.get(key)
    if d is None:
        d = should_fire(site)
        with _lock:
            d = cur.plan.setdefault(key, d)
    return d


class loop:
    """A loop the JAX package runs as ``lax.while_loop`` / ``fori_loop``:
    made where the loop starts (claiming its place in the enclosing
    pass), then entered once an iteration, so that every iteration
    meets the body's places as the same places::

        body = faults.loop()
        while ...:
            with body:
                ...
    """

    __slots__ = ("_cur", "_path", "_outer")

    def __init__(self):
        cur = getattr(_tls, "cur", None)
        self._cur = cur
        if cur is not None:
            self._path = cur.path + (cur.seq,)
            cur.seq += 1

    def __enter__(self):
        cur = self._cur
        if cur is not None:
            self._outer = (cur.path, cur.seq)
            cur.path, cur.seq = self._path, 0
        return self

    def __exit__(self, *exc):
        cur = self._cur
        if cur is not None:
            cur.path, cur.seq = self._outer
        return False


def corrupt_nan(site: str, x):
    """``x`` with its first element NaN when ``site`` fires at this
    place (:func:`decide`), ``x`` itself otherwise.  For a batch (B, n)
    it is every instance's first element: the JAX package's batched loop
    runs the per-instance iteration under ``vmap``."""
    if not decide(site):
        return x
    x = x.clone()
    x[..., 0] = float("nan")
    return x
