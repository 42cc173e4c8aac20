"""The process-wide single-worker dispatch stage (the JAX package's
``serve/service.py`` ``_dispatch_pool``).

One worker thread, ``serve-dispatch``, runs the device stage of every
pipelined serve group (``serve/service.py``: the poller hands a group
to it and goes back to padding) and every ``Solver.solve(block=False)``
(``solvers/base.py``).  The port's loops read each iteration's residual
norm to the host, so "return at dispatch" means that the loop runs on
this worker while the caller goes on.  Work from every service and
solver of the process queues here in order; one worker keeps the
launches of two groups from interleaving on the card.

The pool is a :class:`concurrent.futures.ThreadPoolExecutor`, as in the
JAX package, so its worker is joined at interpreter exit.  When the
serve layer's fetch watchdog gives up on a group whose loop still runs
on the worker, :func:`abandon_worker` hands later jobs to a fresh one;
the wedged thread is not reclaimed, and jobs queued on it before then
stay there (ROADMAP.md, queue C).  Nothing
starts it at import: the first job does.  The serve layer's background
worker (``serve/cache.py``: builds ahead of a flush, the store's exports
and restores) is a second pool of the same kind, ``serve-compile``.
"""

from __future__ import annotations

import concurrent.futures
import threading

DISPATCH = "serve-dispatch"

_POOLS: dict = {}
_POOLS_LOCK = threading.Lock()


def named_pool(name: str) -> concurrent.futures.ThreadPoolExecutor:
    """The process's single-worker pool whose thread is named ``name``
    (started on first use)."""
    with _POOLS_LOCK:
        pool = _POOLS.get(name)
        if pool is None:
            pool = _POOLS[name] = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=name)
        return pool


def on_worker(name: str) -> bool:
    """Is the calling thread the worker of :func:`named_pool` ``name``?
    Work on it must never wait for another job of the same worker."""
    return threading.current_thread().name.startswith(name)


def dispatch_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The process's dispatch worker (started on first use)."""
    return named_pool(DISPATCH)


def on_dispatch_worker() -> bool:
    return on_worker(DISPATCH)


def abandon_worker(name: str = DISPATCH):
    """Hand later jobs of the pool ``name`` to a fresh worker (the
    current one is wedged in a job that never ends)."""
    with _POOLS_LOCK:
        pool = _POOLS.pop(name, None)
    if pool is not None:
        pool.shutdown(wait=False)
