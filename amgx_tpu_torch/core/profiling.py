"""Setup-phase profiling: the part of the JAX package's
``core/profiling.py`` that AMG setup needs.

``setup_fastpath_enabled`` selects the cold-setup fast path of the
host coarsening (``AMGX_TPU_TORCH_SETUP_FASTPATH=0`` selects the
reference forms; both give the same hierarchy bit for bit).  The port
reads its own variable, so the JAX package's ``AMGX_TPU_SETUP_FASTPATH``
leaves it as it is.  The AMG solver opens
a :func:`setup_profile_scope` around hierarchy construction and the
coarsening code wraps its stages in :func:`setup_phase`, which adds
their wall-clock seconds to the active profile.  The scope stack is
thread-local, so concurrent setups never write into each other's
profiles.  :func:`count_setup_sync` counts a device-to-host read of
the classical device setup (``amg/device_setup.py``) into the active
profile's ``syncs``.

Spans, ``LevelProfile`` and the telemetry hooks are not ported yet
(ROADMAP.md, queue A: serving tier and fault injection).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time


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
    cf_split, interp, rap_execute, ...) to the active profile; a no-op
    outside a scope."""
    prof = active_setup_profile()
    if prof is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        prof[name] = prof.get(name, 0.0) + time.perf_counter() - t0


def count_setup_sync(n: int = 1):
    """Add ``n`` device-to-host reads made during setup to the active
    profile's ``syncs``; a no-op outside a scope."""
    prof = active_setup_profile()
    if prof is not None:
        prof["syncs"] = prof.get("syncs", 0) + n
