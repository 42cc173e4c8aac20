"""Matrix analysis (reference src/matrix_analysis.cu, behind
AMGX_matrix_check_symmetry, amgx_c.h:583-590): host scipy over the
matrix's host CSR, as in the JAX package's ``ops/analysis.py``."""

from __future__ import annotations

import numpy as np


def check_symmetry(A, tol=0.0):
    """(structurally_symmetric, numerically_symmetric)."""
    sp = A.to_scipy()
    diff_pat = (sp != 0).astype(np.int8) - (sp.T != 0).astype(np.int8)
    if diff_pat.nnz != 0:
        return False, False
    d = abs(sp - sp.T)
    mx = d.max() if d.nnz else 0.0
    scale = max(abs(sp).max(), 1e-300)
    return True, bool(mx <= max(tol, 1e-12) * scale)


def diag_dominance(A):
    """Per-row diagonal dominance ratio |a_ii| / sum_{j!=i} |a_ij|."""
    sp = A.to_scipy()
    diag = np.abs(sp.diagonal())
    off = np.asarray(abs(sp).sum(axis=1)).ravel() - diag
    with np.errstate(divide="ignore"):
        return np.where(off > 0, diag / off, np.inf)
