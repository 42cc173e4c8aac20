"""Poisson stencil generators (reference
AMGX_generate_distributed_poisson_7pt, examples/generate_poisson.cu).

Copies of the JAX package's ``io/poisson.py`` host code: scipy
Kronecker assembly on the host, then :class:`SparseMatrix` on
``device`` (default the card).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from amgx_tpu_torch.core.matrix import SparseMatrix


def _poisson_1d(n):
    return sps.diags_array(
        [-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
        offsets=[-1, 0, 1],
        format="csr",
    )


def poisson_scipy(shape):
    """Kronecker-assembled 5/7-point Laplacian; shape is (nx,), (nx, ny)
    or (nx, ny, nz)."""
    dims = [int(s) for s in shape]
    A = None
    for axis, _ in enumerate(dims):
        term = None
        for j, m in enumerate(dims):
            f = _poisson_1d(m) if j == axis else sps.eye_array(m)
            term = f if term is None else sps.kron(term, f, format="csr")
        A = term if A is None else A + term
    return A.tocsr()


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
    serve layer): a list of (csr_matrix, rhs) pairs, host numpy."""
    rng = np.random.default_rng(seed)
    base = poisson_scipy(shape).tocsr()
    n = base.shape[0]
    out = []
    for _ in range(count):
        sp = base.copy()
        sp.data = sp.data * (1.0 + jitter * rng.standard_normal(sp.nnz))
        sp = (sp + sp.T) * 0.5 + sps.eye_array(n) * 0.5
        sp = sp.tocsr()
        sp.sort_indices()
        out.append((sp, rng.standard_normal(n)))
    return out
