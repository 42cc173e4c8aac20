"""Bandwidth-reducing unknown renumbering (RCM) at the solve boundary.

Counterpart of the JAX package's ``ops/reorder.py``.  ``Solver.setup``
(``solvers/base.py``) permutes the whole system once when
``matrix_reordering`` asks for it; vectors are permuted on entry to
``solve`` and back on exit, so callers never see the internal
ordering.

The JAX package's AUTO mode adopts an ordering only where the permuted
matrix gains its TPU windowed-ELL arrays or DIA, and on any other
backend never adopts; the port's CUDA kernels need no column window,
so AUTO here decides what the JAX package decides off the TPU: no
reorder.  ``RCM`` permutes every structurally eligible matrix, as
there.  The coarse-level renumbering (``reorder_coarse_level``) and
the tile-span measure behind AUTO are TPU-only and not carried over.
"""

from __future__ import annotations

import numpy as np

from amgx_tpu_torch.core import matrix as _m


def rcm_permutation(sp) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of a scipy CSR matrix."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(
        reverse_cuthill_mckee(sp.tocsr(), symmetric_mode=False),
        dtype=np.int64,
    )


def would_build_dia(sp) -> bool:
    """SparseMatrix's DIA acceptance test (matrix.dia_gate) on host CSR."""
    sp = sp.tocsr()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1] or sp.nnz == 0:
        return False
    rows = np.repeat(np.arange(n), np.diff(sp.indptr))
    offs = np.unique(sp.indices.astype(np.int64) - rows)
    return _m.dia_gate(offs.shape[0], n, sp.nnz)


def wants_reorder_scipy(sp) -> bool:
    """Is this host matrix in the zone (square, above the dense size,
    not DIA) where the JAX package's TPU kernels gain from a locality
    reordering?"""
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1] or n <= _m._DENSE_MAX_ROWS:
        return False
    return not would_build_dia(sp)


def maybe_reorder(A, mode: str = "AUTO"):
    """Try an RCM renumbering of ``A``; returns ``(A2, perm)`` with
    ``A2 = A[perm][:, perm]`` (on ``A``'s device) or ``(A, None)``.
    AUTO and NONE never reorder; RCM reorders any square matrix above
    the dense size that is not DIA, MATRIX_FREE or dense."""
    mode = (mode or "AUTO").upper()
    if mode in ("NONE", "AUTO"):
        return A, None
    if (
        A.block_size != 1
        or not A.is_square
        or A.n_rows <= _m._DENSE_MAX_ROWS
        or A.has_dia
        or A.has_matrix_free
        or A.has_dense
    ):
        return A, None
    sp = A.to_scipy()
    perm = rcm_permutation(sp)
    sp2 = sp[perm][:, perm].tocsr()
    sp2.sort_indices()
    return _m.SparseMatrix.from_scipy(sp2, device=A.device), perm
