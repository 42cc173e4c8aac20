"""Typed failure taxonomy raised on the solve path.

Same classes and AMGX_RC codes as the JAX package (reference
amgx_c.h:52-69): :class:`SetupError` and its subclasses for operators
that cannot be set up, with input validation at the upload and setup
boundaries, :class:`ResourceError` for overflow-class failures (the
classical device setup's ``DeviceSetupOverflow``, the serve layer's
:class:`DeadlineExceededError`, and the gateway's
:class:`AdmissionRejected` / :class:`Overloaded` sheds, all
``RC_NO_MEMORY``), :class:`DeviceLostError` (``RC_CUDA_FAILURE``) for a
lost or hung device under the serve layer, and :class:`StoreError` for
the setup store.  ``AMGX_TPU_VALIDATE=0``
disables validation in both packages.
"""

from __future__ import annotations

import os

import numpy as np

RC_OK = 0
RC_BAD_PARAMETERS = 1
RC_UNKNOWN = 2
RC_NOT_SUPPORTED_TARGET = 3
RC_NOT_SUPPORTED_BLOCKSIZE = 4
RC_CUDA_FAILURE = 5
RC_THRUST_FAILURE = 6
RC_NO_MEMORY = 7
RC_IO_ERROR = 8
RC_BAD_MODE = 9
RC_CORE = 10
RC_PLUGIN = 11
RC_BAD_CONFIGURATION = 12
RC_NOT_IMPLEMENTED = 13
RC_LICENSE_NOT_FOUND = 14
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


class SolveBreakdown(AMGXTPUError):
    """Iteration breakdown that escaped the in-loop status machinery
    (``RC_INTERNAL``, as in the JAX package; it crosses the fleet's wire
    typed)."""

    rc = RC_INTERNAL


class ResourceError(AMGXTPUError):
    """Overflow/OOM-class failure: addressing limits, compile
    failures, exhausted deadlines."""

    rc = RC_NO_MEMORY


class DeadlineExceededError(ResourceError):
    """A request's ``deadline_s`` passed before it could be served: at
    submit (already expired on arrival), at flush (expired while
    queued) or at the fetch of its group's result (the serve layer,
    ``amgx_tpu_torch.serve``).  A :class:`ResourceError`, so its RC is
    ``RC_NO_MEMORY`` as in the JAX package."""


class DeviceLostError(ResourceError):
    """A device under the serve layer failed or hung: a dispatch or a
    fetch raised a CUDA runtime error, or the fetch watchdog expired on
    a group that never completed.  ``RC_CUDA_FAILURE`` at the C API, as
    in the JAX package.  ``device_label`` names the placement device
    where the failure could be attributed (None on a single device).
    The serve layer requeues the group once before this error reaches a
    ticket; ``inferred`` is set on one classified from a runtime error
    (``serve/service.py``), which also charges the pattern's breaker."""

    rc = RC_CUDA_FAILURE

    def __init__(self, msg: str = "", rc: int | None = None,
                 device_label: str | None = None):
        super().__init__(msg, rc)
        self.device_label = device_label


class AdmissionRejected(ResourceError):
    """The gateway (``amgx_tpu_torch.serve.gateway``) refused a request at
    the door: a tenant's quota or device-seconds budget, a deadline that
    cannot be met, an open circuit breaker.  ``retry_after_s`` is the
    back-off hint (None when unknown), ``reason`` a short slug
    (``quota``, ``device_budget``, ``deadline_unmeetable``,
    ``breaker_open``, ``draining``, ``overloaded``).  A per-system FAILED
    status at the C API (``RC_NO_MEMORY`` at the RC boundary)."""

    def __init__(self, msg: str = "", rc: int | None = None,
                 retry_after_s: float | None = None,
                 reason: str = "rejected"):
        super().__init__(msg, rc)
        self.retry_after_s = retry_after_s
        self.reason = reason


class Overloaded(AdmissionRejected):
    """The service as a whole is past its concurrency budget or is
    draining: no request of the lane is admitted now, whatever its
    tenant."""

    def __init__(self, msg: str = "", rc: int | None = None,
                 retry_after_s: float | None = None,
                 reason: str = "overloaded"):
        super().__init__(msg, rc, retry_after_s=retry_after_s,
                         reason=reason)


class SingularDiagonalError(SetupError):
    """A diagonal is exactly singular where the algorithm requires an
    invertible pivot (e.g. dense-LU zero pivot)."""


class NonFiniteValuesError(SetupError):
    """NaN/Inf in matrix coefficients or right-hand side."""


class PatternDegeneracyError(SetupError):
    """Malformed sparsity structure: non-monotone row pointers,
    out-of-range column indices, value/index length mismatch."""

    rc = RC_BAD_PARAMETERS


class StoreError(AMGXTPUError):
    """Setup-artifact persistence failure (``amgx_tpu_torch.store``):
    an unreadable or corrupt payload, a schema or configuration
    mismatch, a stale artifact, or a setup holding state that cannot be
    persisted.  The artifact store never raises it on reads (a defect
    there is a miss); ``save_setup`` / ``load_setup`` raise it."""

    rc = RC_IO_ERROR


def rc_for_exception(e: BaseException) -> int:
    """AMGX_RC code of any exception, the catch-all of the C API
    boundary (the JAX package's mapping): typed errors carry their own
    code, common Python exception classes map to the nearest reference
    code, anything else is RC_UNKNOWN."""
    rc = getattr(e, "rc", None)
    if isinstance(rc, int) and RC_OK <= rc <= RC_INTERNAL:
        return rc
    if isinstance(e, MemoryError):
        return RC_NO_MEMORY
    if isinstance(e, (OSError, EOFError)):
        return RC_IO_ERROR
    if isinstance(e, NotImplementedError):
        return RC_NOT_IMPLEMENTED
    if isinstance(e, KeyError):
        # unregistered solver / parameter names surface as KeyError
        return RC_BAD_CONFIGURATION
    if isinstance(e, (ValueError, TypeError, IndexError, AssertionError)):
        return RC_BAD_PARAMETERS
    return RC_UNKNOWN


def validation_enabled() -> bool:
    """``AMGX_TPU_VALIDATE=0`` disables all input validation."""
    return os.environ.get("AMGX_TPU_VALIDATE", "1") != "0"


def validate_csr(row_offsets, col_indices, values, n_rows, n_cols,
                 block_size=1, where="matrix upload"):
    """Structural + numeric sanity of host CSR arrays: malformed
    structure raises :class:`PatternDegeneracyError`, NaN/Inf
    coefficients :class:`NonFiniteValuesError`.  ``row_offsets`` and
    ``col_indices`` index block rows and columns of ``block_size``:
    ``values`` must hold ``block_size``^2 entries a column index, and
    the NaN/Inf check covers every entry of every block."""
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
    if vals.size != nnz * block_size * block_size:
        raise PatternDegeneracyError(
            f"{where}: {vals.size} values for {nnz} column indices of "
            f"{block_size} x {block_size} blocks"
        )
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


def validate_vector(v, n, where="vector upload"):
    """Length and finite values of a right-hand side or initial guess."""
    if v is None:
        return
    arr = np.asarray(v).reshape(-1)
    if arr.shape[0] != n:
        raise PatternDegeneracyError(
            f"{where}: expected length-{n} vector, got {arr.shape[0]}"
        )
    if arr.size and np.issubdtype(arr.dtype, np.inexact) \
            and not np.all(np.isfinite(arr)):
        raise NonFiniteValuesError(f"{where}: vector contains NaN/Inf")
