"""BLAS-1 vector ops (reference src/blas.cu) and call-site counters.

``make_site_counter`` is the JAX package's counter pattern: ``record``
adds into the active context's count, ``counter()`` yields a
:class:`SiteCount` for the duration of a ``with`` block (thread-local,
nesting-safe).  The JAX package counts at trace time; here the code
runs eagerly, so a counter counts the calls made while it is active.

Every global reduction (a dot, a fused multi-dot, a Gram block, a
norm) calls ``record_reduction``: one call site is one reduction,
however many scalars it makes (on a mesh, one ``psum``).
``reduction_counter()`` around one pass of a loop body gives the
reductions an iteration makes (``Solver.reductions_per_iteration``, the
``amgx_solver_reductions_total`` family).

Fault site ``dot_breakdown`` (``core/faults.py``): where it fires, the
product returns exactly 0, the Krylov breakdown (rho / pq = 0) that
the divergence and stagnation guardrails and the retry hook recover
from.  A fused or Gram site breaks down as a unit.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from amgx_tpu_torch.core import faults

_TLS = threading.local()


class SiteCount:
    """Mutable counter yielded by a site counter's context manager."""

    def __init__(self):
        self.count = 0


def make_site_counter(slot: str):
    """``(record, counter)`` pair on its own thread-local slot."""

    def record(n: int = 1) -> None:
        c = getattr(_TLS, slot, None)
        if c is not None:
            c.count += n

    @contextlib.contextmanager
    def counter():
        prev = getattr(_TLS, slot, None)
        c = SiteCount()
        setattr(_TLS, slot, c)
        try:
            yield c
        finally:
            setattr(_TLS, slot, prev)

    return record, counter


record_reduction, reduction_counter = make_site_counter("reductions")


def _zeros(shape, x, y):
    return torch.zeros(shape, dtype=torch.result_type(x, y),
                       device=x.device)


def dot(x, y):
    """<x, y> with complex conjugation on the first argument, as a
    0-dim tensor on the device (no host sync).  For a batch of vectors,
    x and y (B, n), the B products as a (B, 1) tensor, each reduced over
    its row (the serve layer's batched solves; the 1-D path is not
    touched)."""
    record_reduction()
    if faults.decide("dot_breakdown"):
        return _zeros((x.shape[0], 1) if x.dim() == 2 else (), x, y)
    if x.dim() == 2:
        if x.is_complex():
            x = x.conj()
        return torch.sum(x * y, dim=-1, keepdim=True)
    if x.is_complex():
        return torch.vdot(x, y)
    return torch.dot(x, y)


def fused_dots(pairs):
    """k dot products as one stacked reduction -> (k,) tensor; for
    batched (B, n) vectors a (k, B, 1) tensor, so that each of the k
    unpacks to (B, 1) scalars."""
    record_reduction()
    xs = torch.stack([p[0] for p in pairs])
    ys = torch.stack([p[1] for p in pairs])
    if faults.decide("dot_breakdown"):
        return _zeros(xs.shape[:1] + ((xs.shape[1], 1) if xs.dim() > 2
                                      else ()), xs, ys)
    if xs.is_complex():
        xs = xs.conj()
    return torch.sum(xs * ys, dim=-1, keepdim=xs.dim() > 2)


def gram_block(X, Y):
    """Block of inner products G[i, j] = <X_i, Y_j> as one product:
    X is (k, n), Y is (m, n) (rows are vectors), G is (k, m);
    conjugation on the rows of X, as in :func:`dot`.  A batch (B, k, n)
    and (B, m, n) gives the B blocks (B, k, m).  The s-step Krylov
    solvers form every inner product of an outer iteration with it."""
    record_reduction()
    if faults.decide("dot_breakdown"):
        return _zeros(X.shape[:-1] + Y.shape[-2:-1], X, Y)
    if X.is_complex():
        X = X.conj()
    return X @ Y.mT
