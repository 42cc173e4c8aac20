"""Typed failure taxonomy raised on the solve path.

Same classes and AMGX_RC codes as the JAX package (reference
amgx_c.h:52-69): :class:`SetupError` and its subclasses for operators
that cannot be set up, with input validation at the upload and setup
boundaries, and :class:`ResourceError` for overflow-class failures
(the classical device setup's ``DeviceSetupOverflow``).  ``AMGX_TPU_VALIDATE=0`` disables validation in both
packages.
"""

from __future__ import annotations

import os

import numpy as np

RC_OK = 0
RC_BAD_PARAMETERS = 1
RC_UNKNOWN = 2
RC_NO_MEMORY = 7
RC_CORE = 10
RC_NOT_IMPLEMENTED = 13
RC_INTERNAL = 15


class AMGXTPUError(RuntimeError):
    """Base of the typed failure taxonomy; ``rc`` is the AMGX_RC code."""

    rc = RC_UNKNOWN

    def __init__(self, msg: str = "", rc: int | None = None):
        super().__init__(msg)
        if rc is not None:
            self.rc = rc


class SetupError(AMGXTPUError):
    """Operator setup cannot proceed (bad coefficients / structure)."""

    rc = RC_CORE


class ResourceError(AMGXTPUError):
    """Overflow/OOM-class failure: addressing limits, compile
    failures, exhausted deadlines."""

    rc = RC_NO_MEMORY


class SingularDiagonalError(SetupError):
    """A diagonal is exactly singular where the algorithm requires an
    invertible pivot (e.g. dense-LU zero pivot)."""


class NonFiniteValuesError(SetupError):
    """NaN/Inf in matrix coefficients or right-hand side."""


class PatternDegeneracyError(SetupError):
    """Malformed sparsity structure: non-monotone row pointers,
    out-of-range column indices, value/index length mismatch."""

    rc = RC_BAD_PARAMETERS


def validation_enabled() -> bool:
    """``AMGX_TPU_VALIDATE=0`` disables all input validation."""
    return os.environ.get("AMGX_TPU_VALIDATE", "1") != "0"


def validate_csr(row_offsets, col_indices, values, n_rows, n_cols,
                 where="matrix upload"):
    """Structural + numeric sanity of host CSR arrays: malformed
    structure raises :class:`PatternDegeneracyError`, NaN/Inf
    coefficients :class:`NonFiniteValuesError`."""
    ro = np.asarray(row_offsets)
    ci = np.asarray(col_indices)
    nnz = ci.shape[0]
    if ro.ndim != 1 or ro.shape[0] != n_rows + 1:
        raise PatternDegeneracyError(
            f"{where}: row_offsets has shape {ro.shape}, "
            f"expected ({n_rows + 1},)"
        )
    if n_rows and (ro[0] != 0 or ro[-1] != nnz):
        raise PatternDegeneracyError(
            f"{where}: row_offsets span [{ro[0]}, {ro[-1]}] does not "
            f"cover nnz={nnz}"
        )
    if n_rows and np.any(np.diff(ro) < 0):
        raise PatternDegeneracyError(
            f"{where}: row_offsets is not non-decreasing"
        )
    if nnz:
        cmin, cmax = int(ci.min()), int(ci.max())
        if cmin < 0 or cmax >= n_cols:
            raise PatternDegeneracyError(
                f"{where}: column indices span [{cmin}, {cmax}] outside "
                f"[0, {n_cols})"
            )
    vals = np.asarray(values)
    if vals.size and np.issubdtype(vals.dtype, np.inexact) \
            and not np.all(np.isfinite(vals)):
        raise NonFiniteValuesError(
            f"{where}: matrix coefficients contain NaN/Inf"
        )


def validate_operator(A, where="solver setup"):
    """Numeric sanity of an already-built SparseMatrix."""
    import torch

    if A.nnz and not bool(torch.isfinite(A.values).all()):
        raise NonFiniteValuesError(
            f"{where}: operator coefficients contain NaN/Inf "
            f"({A.n_rows}x{A.n_cols}, nnz={A.nnz})"
        )
