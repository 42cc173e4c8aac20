"""CSR sparse matrix with MATRIX_FREE / DIA / dense / ELL acceleration
structures, held as torch tensors on one device.

Counterpart of the JAX package's ``core/matrix.py`` (reference
Matrix<TConfig>, include/matrix.h:65).  The host-side constructors
are copies of the JAX package's numpy code, so both packages pick the same
format for the same matrix and fill it with the same values:

  * MATRIX_FREE when ``"matrix_free"`` is requested and the matrix is a
    verified constant or axis-separable stencil (``ops/stencil.py``):
    ``nd`` (or ``nd x L``) coefficients replace the DIA value planes;
  * DIA when the matrix has few distinct diagonals with acceptable
    padding (``_DIA_MAX_DIAGS``, ``_DIA_MAX_OVERHEAD``);
  * dense for small matrices that are neither (4096 rows and columns
    or fewer);
  * ELL when the padded width stays within ``_ELL_MAX_WIDTH`` and
    ``_ELL_MAX_OVERHEAD``.

Differences from the JAX package:

  * ELL is stored slot-major, ``(w, n_rows)``, so that the CUDA kernel's
    threads (one per row) read neighbouring addresses for each slot.
    The JAX package stores ``(n_rows, w)``.
  * No TPU windowed-ELL layout (the CUDA kernel gathers per thread), no
    partitions and no ``replace_values``, so the source maps into the
    CSR values (``dia_src``, the stencil's) are built on the host for
    stencil detection and then dropped (ROADMAP.md, queue A).
  * Block matrices (``block_size > 1``) and bf16 values are not ported
    yet.
  * ``device`` defaults to ``"cuda"``; without a card the constructors
    raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from amgx_tpu_torch.core.device import resolve_device

_ELL_MAX_OVERHEAD = 4.0
_ELL_MAX_WIDTH = 128
_DIA_MAX_DIAGS = 48
_DIA_MAX_OVERHEAD = 2.0
_DENSE_MAX_ROWS = 4096

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def to_tensor(a, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (dtype preserved)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        # torch.from_numpy shares memory and cannot mark it read-only
        a = a.copy()
    if a.dtype not in _TORCH_DTYPES:
        raise NotImplementedError(
            f"dtype {a.dtype} is not supported by the PyTorch port yet "
            "(ROADMAP.md, queue A: block matrices and reduced precision)"
        )
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass(eq=False)
class SparseMatrix:
    """Square-or-rectangular scalar CSR matrix on one device.

    Tensors:
      row_offsets (n_rows+1,) int32, col_indices (nnz,) int32,
      values (nnz,), row_ids (nnz,) int32 row of each entry, and
      diag (n_rows,) the summed diagonal entries.
      dia_vals (nd, n): dia_vals[k, i] = A[i, i + dia_offsets[k]], with
      dia_offsets a sorted tuple and dia_offsets_dev the same offsets as
      an int32 tensor on the device (built once, read by the kernel).
      mf_meta (host ``StencilMeta``) and mf_coefs (nd,) or (nd, L) in
      the values' dtype: the MATRIX_FREE state (``ops/stencil.py``).
      dense (n_rows, n_cols).
      ell_cols / ell_vals (w, n_rows), slot-major; padding slots hold
      column 0 and value 0.
    """

    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    values: torch.Tensor
    row_ids: torch.Tensor
    diag: torch.Tensor
    n_rows: int
    n_cols: int
    dia_offsets: Optional[tuple] = None
    dia_offsets_dev: Optional[torch.Tensor] = None
    dia_vals: Optional[torch.Tensor] = None
    mf_meta: Optional[object] = None
    mf_coefs: Optional[torch.Tensor] = None
    dense: Optional[torch.Tensor] = None
    ell_cols: Optional[torch.Tensor] = None
    ell_vals: Optional[torch.Tensor] = None
    block_size: int = 1
    # host CSR triple (numpy) the matrix was built from; the AMG setup
    # reads it back instead of copying from the device
    _host: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def is_square(self) -> bool:
        return self.n_rows == self.n_cols

    @property
    def has_matrix_free(self) -> bool:
        return self.mf_meta is not None

    @property
    def has_dia(self) -> bool:
        return self.dia_offsets is not None

    @property
    def has_dense(self) -> bool:
        return self.dense is not None

    @property
    def has_ell(self) -> bool:
        return self.ell_cols is not None

    @property
    def format(self) -> str:
        """The format SpMV dispatches to (ops/spmv.py order)."""
        if self.has_matrix_free:
            return "MATRIX_FREE"
        if self.has_dia:
            return "DIA"
        if self.has_dense:
            return "dense"
        if self.has_ell:
            return "ELL"
        return "CSR"

    # ---- construction ---------------------------------------------------

    @staticmethod
    def from_csr(
        row_offsets,
        col_indices,
        values,
        n_cols=None,
        block_size=1,
        dtype=None,
        accel_formats=("dia", "dense", "ell"),
        validate=None,
        device="cuda",
    ) -> "SparseMatrix":
        """Build from host CSR arrays (reference AMGX_matrix_upload_all).

        Formats are built in the JAX package's order (its
        ``core/matrix.py:404-491``): DIA, then MATRIX_FREE (which
        replaces the DIA planes when detection succeeds), then dense if
        neither, then ELL if none; ``accel_formats`` restricts which
        may build (MATRIX_FREE only when asked for)."""
        if block_size != 1:
            raise NotImplementedError(
                "block matrices (block_size > 1) are not ported yet "
                "(ROADMAP.md, queue A: block matrices and reduced "
                "precision)"
            )
        dev = resolve_device(device)
        row_offsets = np.asarray(row_offsets, dtype=np.int32)
        col_indices = np.asarray(col_indices, dtype=np.int32)
        values = np.asarray(values)
        if dtype is not None:
            values = values.astype(dtype)
        values = values.reshape(-1)
        n_rows = row_offsets.shape[0] - 1
        if n_cols is None:
            n_cols = n_rows
        from amgx_tpu_torch.core import errors as _errors

        if validate is None:
            validate = _errors.validation_enabled()
        if validate:
            _errors.validate_csr(
                row_offsets, col_indices, values, n_rows, n_cols
            )
        nnz = col_indices.shape[0]
        if values.shape[0] != nnz:
            raise _errors.PatternDegeneracyError(
                f"matrix upload: {values.shape[0]} values for {nnz} "
                "column indices"
            )

        row_lens = np.diff(row_offsets)
        row_ids = np.repeat(np.arange(n_rows, dtype=np.int32), row_lens)
        diag = _extract_diag_np(row_offsets, col_indices, values, n_rows)

        dia_offsets = dia_vals = dia_src = None
        if "dia" in accel_formats and n_rows == n_cols and nnz:
            dia_offsets, dia_vals, dia_src = _try_build_dia_np(
                row_offsets, col_indices, values, row_ids, n_rows
            )

        mf_meta = mf_coefs = None
        if "matrix_free" in accel_formats and n_rows == n_cols and nnz:
            # detection reads DIA planes; build them transiently when
            # "dia" was not requested
            trio = (dia_offsets, dia_vals, dia_src)
            if trio[0] is None:
                trio = _try_build_dia_np(
                    row_offsets, col_indices, values, row_ids, n_rows
                )
            if trio[0] is not None:
                from amgx_tpu_torch.ops.stencil import detect_stencil_np

                det = detect_stencil_np(trio[0], trio[1], trio[2], n_rows)
                if det is not None:
                    # the compact state replaces the O(nnz) DIA planes
                    mf_meta, mf_coefs, _ = det
                    dia_offsets = dia_vals = None

        dense = None
        dense_bytes = n_rows * n_cols * values.dtype.itemsize
        if (
            "dense" in accel_formats
            and dia_offsets is None
            and mf_meta is None
            and 0 < n_rows <= _DENSE_MAX_ROWS
            and n_cols <= _DENSE_MAX_ROWS
            and dense_bytes <= 64 * 1024 * 1024
        ):
            dense = np.zeros((n_rows, n_cols), dtype=values.dtype)
            np.add.at(dense, (row_ids, col_indices), values)

        ell_cols = ell_vals = None
        if (
            "ell" in accel_formats
            and n_rows > 0
            and dia_offsets is None
            and mf_meta is None
            and dense is None
        ):
            w = int(row_lens.max()) if nnz else 0
            if w <= _ELL_MAX_WIDTH and w * n_rows <= _ELL_MAX_OVERHEAD * max(
                nnz, 1
            ):
                ell_cols, ell_vals = _build_ell_np(
                    row_offsets, col_indices, values, n_rows, w
                )

        def put(a):
            return None if a is None else to_tensor(a, dev)

        return SparseMatrix(
            row_offsets=put(row_offsets),
            col_indices=put(col_indices),
            values=put(values),
            row_ids=put(row_ids),
            diag=put(diag),
            n_rows=int(n_rows),
            n_cols=int(n_cols),
            dia_offsets=dia_offsets,
            dia_offsets_dev=(
                None if dia_offsets is None
                else put(np.asarray(dia_offsets, dtype=np.int32))
            ),
            dia_vals=put(dia_vals),
            mf_meta=mf_meta,
            mf_coefs=put(mf_coefs),
            dense=put(dense),
            # slot-major for coalesced kernel loads
            ell_cols=None if ell_cols is None else put(ell_cols.T),
            ell_vals=None if ell_vals is None else put(ell_vals.T),
            _host=(row_offsets, col_indices, values),
        )

    @staticmethod
    def from_coo(rows, cols, vals, n_rows=None, n_cols=None,
                 **kw) -> "SparseMatrix":
        """Build from COO triples: sorted by (row, col), duplicates
        summed (the JAX package's ``from_coo``, scalar blocks only)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if n_rows is None:
            n_rows = int(rows.max()) + 1 if rows.size else 0
        if n_cols is None:
            n_cols = int(cols.max()) + 1 if cols.size else 0
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        key = rows.astype(np.int64) * n_cols + cols
        uniq, inv = np.unique(key, return_inverse=True)
        if uniq.shape[0] != key.shape[0]:
            summed = np.zeros(uniq.shape[0], vals.dtype)
            np.add.at(summed, inv, vals)
            vals = summed
            rows = (uniq // n_cols).astype(np.int32)
            cols = (uniq % n_cols).astype(np.int32)
        row_offsets = np.zeros(n_rows + 1, np.int32)
        np.add.at(row_offsets[1:], rows, 1)
        row_offsets = np.cumsum(row_offsets, dtype=np.int32)
        return SparseMatrix.from_csr(row_offsets, cols, vals,
                                     n_cols=n_cols, **kw)

    @staticmethod
    def from_scipy(sp, **kw) -> "SparseMatrix":
        sp = sp.tocsr()
        sp.sort_indices()
        return SparseMatrix.from_csr(
            sp.indptr, sp.indices, sp.data, n_cols=sp.shape[1], **kw
        )

    # ---- host conversions -----------------------------------------------

    def host_csr(self):
        """Read-only scipy CSR view of the host triple the matrix was
        built from (no device copy).  Callers must not mutate it."""
        import scipy.sparse as sps

        ro, ci, v = self._host
        return sps.csr_matrix(
            (v, ci, ro), shape=(self.n_rows, self.n_cols), copy=False
        )

    def to_scipy(self):
        """Mutable scipy CSR copy."""
        import scipy.sparse as sps

        ro, ci, v = self._host
        return sps.csr_matrix(
            (v.copy(), ci.copy(), ro.copy()),
            shape=(self.n_rows, self.n_cols),
        )

    def to_dense(self):
        return np.asarray(self.to_scipy().todense())


# ---------------------------------------------------------------------------
# host helpers (copies of the JAX package's numpy code)


def _row_ids_np(row_offsets, n_rows):
    return np.repeat(
        np.arange(n_rows, dtype=np.int32), np.diff(row_offsets)
    )


def _extract_diag_np(row_offsets, col_indices, values, n_rows):
    diag = np.zeros((n_rows,), dtype=values.dtype)
    row_ids = _row_ids_np(row_offsets, n_rows)
    hit = col_indices == row_ids
    # sum duplicates, matching the DIA/ELL/CSR SpMV paths
    np.add.at(diag, row_ids[hit], values[hit])
    return diag


def _build_ell_np(row_offsets, col_indices, values, n_rows, w):
    """Row-major (n_rows, w) ELL arrays, as the JAX package builds them;
    the caller transposes to the port's slot-major layout."""
    ell_cols = np.zeros((n_rows, w), dtype=np.int32)
    ell_vals = np.zeros((n_rows, w), dtype=values.dtype)
    row_ids = _row_ids_np(row_offsets, n_rows)
    pos = np.arange(col_indices.shape[0], dtype=np.int64) - row_offsets[
        row_ids
    ].astype(np.int64)
    ell_cols[row_ids, pos] = col_indices
    ell_vals[row_ids, pos] = values
    return ell_cols, ell_vals


def dia_gate(num_diags: int, n: int, nnz: int) -> bool:
    """DIA acceptance: few distinct diagonals with acceptable padding."""
    return (
        num_diags <= _DIA_MAX_DIAGS
        and num_diags * n <= _DIA_MAX_OVERHEAD * max(nnz, 1)
    )


def _try_build_dia_np(row_offsets, col_indices, values, row_ids, n):
    """(offsets tuple, dia_vals (nd, n), dia_src (nd, n)) or
    (None, None, None).  ``dia_src[k, i]`` is the index into the CSR
    arrays of the first entry stored at (i, i + offsets[k]), -1 where
    none is; stencil detection picks its witness rows by it."""
    offs = col_indices.astype(np.int64) - row_ids.astype(np.int64)
    uniq = np.unique(offs)
    if not dia_gate(uniq.shape[0], n, col_indices.shape[0]):
        return None, None, None
    dia_vals = np.zeros((uniq.shape[0], n), dtype=values.dtype)
    k = np.searchsorted(uniq, offs)
    # add (not assign): duplicate (row,col) entries must sum, matching
    # the ELL/CSR SpMV paths
    np.add.at(dia_vals, (k, row_ids), values)
    # unbuffered minimum: FIRST occurrence wins
    sentinel = np.iinfo(np.int32).max
    dia_src = np.full((uniq.shape[0], n), sentinel, dtype=np.int32)
    idx = np.arange(col_indices.shape[0], dtype=np.int32)
    np.minimum.at(dia_src, (k, row_ids), idx)
    dia_src[dia_src == sentinel] = -1
    return tuple(int(o) for o in uniq), dia_vals, dia_src
