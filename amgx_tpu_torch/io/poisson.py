"""Poisson stencil generators (reference
AMGX_generate_distributed_poisson_7pt, examples/generate_poisson.cu).

The JAX package's ``io/poisson.py`` matrices on the host (the Kronecker
sums assembled directly, bit for bit), then :class:`SparseMatrix` on
``device`` (default the card).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from amgx_tpu_torch.core.matrix import SparseMatrix


def poisson_scipy(shape):
    """The 5/7-point Laplacian on a grid ``shape`` ((nx,), (nx, ny) or
    (nx, ny, nz), the last axis fastest): the JAX package's sum of
    Kronecker products of the 1D operator [-1, 2, -1] with identities,
    assembled directly, its arrays bit for bit (2 x ndim on the
    diagonal, -1 at each neighbour, columns ascending)."""
    dims = [int(s) for s in shape]
    nd = len(dims)
    n = int(np.prod(dims))
    strides = [int(np.prod(dims[j + 1:])) for j in range(nd)]
    # the candidate columns of a row in ascending order: the neighbour
    # below along each axis (slowest first), the row, then above
    offs = ([-st for st in strides] + [0]
            + [st for st in reversed(strides)])
    k = len(offs)
    idx_t = np.int32 if n * k < 2**31 else np.int64
    idx = np.arange(n, dtype=idx_t)
    keep = np.empty((n, k), dtype=bool)
    for j, (m, st) in enumerate(zip(dims, strides)):
        c = (idx // st) % m
        keep[:, j] = c > 0
        keep[:, k - 1 - j] = c < m - 1
    keep[:, nd] = True
    cols = (idx[:, None] + np.asarray(offs, dtype=idx_t)[None, :])[keep]
    vals = np.full(k, -1.0)
    vals[nd] = 2.0 * nd
    data = np.broadcast_to(vals, keep.shape)[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    it = np.int32 if max(n, int(indptr[-1])) < 2**31 else np.int64
    return sps.csr_array((data, cols.astype(it, copy=False),
                          indptr.astype(it)), shape=(n, n))


def poisson_2d_5pt(nx, ny=None, dtype=np.float64, **kw) -> SparseMatrix:
    ny = nx if ny is None else ny
    return SparseMatrix.from_scipy(poisson_scipy((nx, ny)).astype(dtype), **kw)


def poisson_3d_7pt(nx, ny=None, nz=None, dtype=np.float64,
                   **kw) -> SparseMatrix:
    """3D 7-point Poisson matrix; ``device=`` (default ``"cuda"``) and
    other keywords go to :meth:`SparseMatrix.from_csr`."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    A = poisson_scipy((nx, ny, nz)).astype(dtype)
    return SparseMatrix.from_scipy(A, **kw)


def poisson_rhs(n, dtype=np.float64, seed=0):
    """Deterministic right-hand side (numpy, the JAX package's seed)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n).astype(dtype)


def jittered_poisson_family(shape, count, seed=0, jitter=0.08):
    """``count`` SPD scipy systems sharing the Poisson sparsity pattern,
    each with its own coefficient jitter, and random right-hand sides
    (the JAX package's ``jittered_poisson_family``, the workload of the
    serve layer, bit for bit): a list of (csr_array, rhs) pairs, host
    numpy.  The symmetrization ``(A + A^T) * 0.5 + 0.5 I`` is done on
    the values of the one symmetric pattern, each entry added to its
    transpose's (a gather), instead of by two sparse sums a system."""
    rng = np.random.default_rng(seed)
    base = poisson_scipy(shape).tocsr()
    base.sort_indices()
    n = base.shape[0]
    indptr, cols = base.indptr, base.indices
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    flat = rows * n + cols
    # the position of each entry's transpose, and of the diagonal
    trans = np.searchsorted(flat, cols.astype(np.int64) * n + rows)
    diag = np.flatnonzero(rows == cols)
    out = []
    for _ in range(count):
        v = base.data * (1.0 + jitter * rng.standard_normal(base.nnz))
        v = (v + v[trans]) * 0.5
        v[diag] += 0.5
        sp = sps.csr_array((v, cols.copy(), indptr.copy()), shape=(n, n))
        out.append((sp, rng.standard_normal(n)))
    return out
