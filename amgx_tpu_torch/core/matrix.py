"""Block-CSR sparse matrix with MATRIX_FREE / DIA / dense / ELL
acceleration structures, held as torch tensors on one device.

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
    The JAX package stores ``(n_rows, w)``.  Beside it, from the same
    host CSR, a sliced, row-sorted ELL (``sell``, ``ops/ell.py``) where
    that moves fewer bytes than the slot-major arrays: rows whose
    lengths vary (the classical operators) stop being padded to the
    longest row.  SpMV takes ``sell`` when it is there; the format is
    still "ELL".
  * No TPU windowed-ELL layout (the CUDA kernel gathers per thread) and
    no partitions.
  * ``replace_values`` (AmgX's ``AMGX_matrix_replace_coefficients``)
    refills every format on the device by gathers from first-occurrence
    source maps into the CSR values, as the JAX package's does.  The
    JAX package keeps its ``diag_src`` / ``dia_src`` / ``ell_src`` maps
    from upload on; here they are derived on the device from the index
    arrays at the first ``replace_values`` (or the first read of the
    ``diag_src`` / ``dia_src`` / ``ell_src`` properties, which the setup
    store writes) and shared by every matrix derived from it (``_src``),
    so a matrix whose values never change holds none.  Only the
    stencil's map (``mf_src``, at most ``nd x L`` entries) is kept from
    detection.  The host triple of a derived
    matrix reads its values back from the device once, when first
    asked for (``host_csr``, ``to_scipy``, the smoothers' setups).
  * ``astype`` casts every format on the device, bf16 included (the
    reduced-precision hierarchies of ``amg/hierarchy.py``).  numpy has
    no bf16: the host triple of a bf16 matrix reads its values back as
    float32 (exact), and an upload from host arrays takes float32,
    float64 and the complex dtypes only.
  * Block matrices (``block_size`` b > 1) store ``values`` as
    (nnz, b, b) and ``diag`` as (n_rows, b, b), as in the JAX package,
    and build block ELL where its width gate allows, with ``ell_vals``
    slot-major (w, n_rows, b, b); no DIA, MATRIX_FREE, dense or sliced
    ELL (the JAX package builds none of the first three for b > 1).
    ``host_csr`` and ``to_scipy`` give the scalar expansion.
  * ``device`` defaults to ``"cuda"``; without a card the constructors
    raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from amgx_tpu_torch.core.device import resolve_device
from amgx_tpu_torch.core.types import host_array, host_dtype, torch_dtype
from amgx_tpu_torch.ops.ell import SELL_C, SlicedEll

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
    """Host numpy array -> tensor on ``device`` (dtype preserved).
    Reduced precision is never uploaded from the host: a bf16 tensor is
    cast on the device (``SparseMatrix.astype``)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        # torch.from_numpy shares memory and cannot mark it read-only
        a = a.copy()
    if a.dtype not in _TORCH_DTYPES:
        raise NotImplementedError(
            f"dtype {a.dtype} is not uploaded from the host by the "
            "PyTorch port: float32, float64 and the complex dtypes are "
            "(bf16: SparseMatrix.astype on the device)"
        )
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass(eq=False)
class SparseMatrix:
    """Square-or-rectangular block-CSR matrix on one device.  Rows,
    columns and entries count blocks of ``block_size`` b; vectors are
    flat, (n_rows * b,).

    Tensors:
      row_offsets (n_rows+1,) int32, col_indices (nnz,) int32,
      values (nnz,) or (nnz, b, b), row_ids (nnz,) int32 row of each
      entry, and diag (n_rows,) or (n_rows, b, b) the summed diagonal
      entries.
      dia_vals (nd, n): dia_vals[k, i] = A[i, i + dia_offsets[k]], with
      dia_offsets a sorted tuple and dia_offsets_dev the same offsets as
      an int32 tensor on the device (built once, read by the kernel).
      mf_meta (host ``StencilMeta``) and mf_coefs (nd,) or (nd, L) in
      the values' dtype: the MATRIX_FREE state (``ops/stencil.py``).
      dense (n_rows, n_cols).
      ell_cols / ell_vals (w, n_rows) (ell_vals (w, n_rows, b, b) for
      blocks), slot-major; padding slots hold column 0 and value 0.
      sell: the same matrix in sliced ELL (``ops/ell.SlicedEll``), or
      None where the slot-major arrays move no more bytes (every slice
      as wide as the widest row).
      mf_src: the CSR index each of ``mf_coefs`` was read from (-1: no
      entry), on the device.
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
    sell: Optional[SlicedEll] = None
    mf_src: Optional[torch.Tensor] = None
    block_size: int = 1
    # B for a batched view (``replace_values_batched``): B instances of
    # this structure, their value tensors with a leading dimension of B;
    # 0 for a matrix
    batch: int = 0
    # host CSR triple (numpy) the matrix was built from, the values None
    # until read back (a matrix made by replace_values); read it through
    # ``_host``
    _host_csr: Optional[tuple] = dataclasses.field(default=None, repr=False)
    # replace_values' source maps (``_src_maps``), shared by every
    # matrix of one structure
    _src: Optional[dict] = dataclasses.field(default=None, repr=False)

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
        """An ELL format: the slot-major arrays, or the sliced layout
        alone (a batched view of a sliced matrix keeps no slot-major
        copy)."""
        return self.ell_cols is not None or self.sell is not None

    @property
    def _host(self) -> tuple:
        """The host CSR triple ``(row_offsets, col_indices, values)``;
        the values of a matrix made by :meth:`replace_values` or by a
        bf16 :meth:`astype` are read back from the device the first time
        (one read, counted as a setup sync inside a setup; bf16 values
        as float32)."""
        ro, ci, v = self._host_csr
        if v is None:
            from amgx_tpu_torch.core.profiling import count_setup_sync

            count_setup_sync()
            v = host_array(self.values)
            self._host_csr = (ro, ci, v)
        return self._host_csr

    # ---- identity (the setup store's key) --------------------------------

    def fingerprint(self) -> str:
        """Hash of the sparsity structure (row offsets, column indices,
        shape, block size; values excluded), equal to the JAX package's
        for the same pattern: the setup store keys on it.  Read from the
        host triple (no device read) and memoized; ``replace_values``
        and ``astype`` carry the memo over."""
        fp = getattr(self, "_fingerprint_cache", None)
        if fp is None:
            ro, ci, _ = self._host_csr
            fp = sparsity_fingerprint(ro, ci, self.n_rows, self.n_cols,
                                      self.block_size)
            self._fingerprint_cache = fp
        return fp

    def setup_key(self) -> tuple:
        """``(fingerprint, dtype name)``: the identity a set-up solver
        is stored under.  The dtype is read from the values each time,
        never memoized."""
        return self.fingerprint(), str(self.dtype).replace("torch.", "")

    def _propagate_structure_memo(self, new: "SparseMatrix"):
        """``new`` with this matrix's memoized fingerprint, where there
        is one: ``new`` must have the same index structure."""
        fp = getattr(self, "_fingerprint_cache", None)
        if fp is not None:
            new._fingerprint_cache = fp
        return new

    # first-occurrence source maps (``_src_maps``) in this package's
    # layouts: the JAX package's ``diag_src`` / ``dia_src`` /
    # ``ell_src`` (the last transposed, (w, n_rows)), derived on the
    # device at the first read; ``mf_src`` is a field

    @property
    def diag_src(self):
        return self._src_maps()["diag"]

    @property
    def dia_src(self):
        return self._src_maps()["dia"] if self.has_dia else None

    @property
    def ell_src(self):
        return (self._src_maps()["ell"] if self.ell_cols is not None
                else None)

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
        With ``block_size`` b > 1 the arrays are block CSR: ``n_cols``
        counts block columns and ``values`` holds b x b row-major
        blocks, (nnz, b, b) or any shape of as many entries.

        Formats are built in the JAX package's order (its
        ``core/matrix.py:404-491``): DIA, then MATRIX_FREE (which
        replaces the DIA planes when detection succeeds), then dense if
        neither, then ELL if none; ``accel_formats`` restricts which
        may build (MATRIX_FREE only when asked for).  A block matrix
        builds ELL only."""
        dev = resolve_device(device)
        b = int(block_size)
        row_offsets = np.asarray(row_offsets, dtype=np.int32)
        col_indices = np.asarray(col_indices, dtype=np.int32)
        values = np.asarray(values)
        if dtype is not None:
            values = values.astype(dtype)
        n_rows = row_offsets.shape[0] - 1
        if n_cols is None:
            n_cols = n_rows
        from amgx_tpu_torch.core import errors as _errors

        if validate is None:
            validate = _errors.validation_enabled()
        nnz = col_indices.shape[0]
        if validate:
            _errors.validate_csr(
                row_offsets, col_indices, values, n_rows, n_cols,
                block_size=b,
            )
        elif values.size != nnz * b * b:
            # the one check the reshape below needs
            raise _errors.PatternDegeneracyError(
                f"matrix upload: {values.size} values for {nnz} "
                f"column indices of {b} x {b} blocks"
            )
        values = values.reshape(-1) if b == 1 else values.reshape(-1, b, b)

        row_lens = np.diff(row_offsets)
        row_ids = np.repeat(np.arange(n_rows, dtype=np.int32), row_lens)
        diag = _extract_diag_np(row_offsets, col_indices, values, n_rows)

        dia_offsets = dia_vals = dia_src = None
        if "dia" in accel_formats and b == 1 and n_rows == n_cols and nnz:
            dia_offsets, dia_vals, dia_src = _try_build_dia_np(
                row_offsets, col_indices, values, row_ids, n_rows
            )

        mf_meta = mf_coefs = mf_src = None
        if ("matrix_free" in accel_formats and b == 1 and n_rows == n_cols
                and nnz):
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
                    mf_meta, mf_coefs, mf_src = det
                    dia_offsets = dia_vals = None

        dense = None
        dense_bytes = n_rows * n_cols * values.dtype.itemsize
        if (
            "dense" in accel_formats
            and b == 1
            and dia_offsets is None
            and mf_meta is None
            and 0 < n_rows <= _DENSE_MAX_ROWS
            and n_cols <= _DENSE_MAX_ROWS
            and dense_bytes <= 64 * 1024 * 1024
        ):
            dense = np.zeros((n_rows, n_cols), dtype=values.dtype)
            np.add.at(dense, (row_ids, col_indices), values)

        ell_cols = ell_vals = sell = None
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
                if b == 1:
                    sell = _build_sell_np(row_offsets, col_indices,
                                          values, n_rows, w)

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
            ell_vals=(None if ell_vals is None
                      else put(np.swapaxes(ell_vals, 0, 1))),
            sell=sliced_ell(sell, dev),
            mf_src=put(mf_src),
            block_size=b,
            _host_csr=(row_offsets, col_indices, values),
        )

    @staticmethod
    def from_coo(rows, cols, vals, n_rows=None, n_cols=None, block_size=1,
                 **kw) -> "SparseMatrix":
        """Build from COO triples of (block) rows and columns: sorted by
        (row, col), duplicates summed (the JAX package's ``from_coo``);
        ``vals`` holds one b x b block an entry for ``block_size`` b."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if n_rows is None:
            n_rows = int(rows.max()) + 1 if rows.size else 0
        if n_cols is None:
            n_cols = int(cols.max()) + 1 if cols.size else 0
        b = block_size
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        vals = vals.reshape(-1, b, b)[order] if b > 1 else vals[order]
        key = rows.astype(np.int64) * n_cols + cols
        uniq, inv = np.unique(key, return_inverse=True)
        if uniq.shape[0] != key.shape[0]:
            summed = np.zeros((uniq.shape[0],) + vals.shape[1:], vals.dtype)
            np.add.at(summed, inv, vals)
            vals = summed
            rows = (uniq // n_cols).astype(np.int32)
            cols = (uniq % n_cols).astype(np.int32)
        row_offsets = np.zeros(n_rows + 1, np.int32)
        np.add.at(row_offsets[1:], rows, 1)
        row_offsets = np.cumsum(row_offsets, dtype=np.int32)
        return SparseMatrix.from_csr(row_offsets, cols, vals,
                                     n_cols=n_cols, block_size=b, **kw)

    @staticmethod
    def from_scipy(sp, block_size=1, **kw) -> "SparseMatrix":
        """Build from a scipy sparse matrix; with ``block_size`` b > 1
        its b x b blocks become the entries (through scipy's BSR, every
        block holding a nonzero stored whole), as in the JAX
        package."""
        sp = sp.tocsr()
        sp.sort_indices()
        if block_size == 1:
            return SparseMatrix.from_csr(
                sp.indptr, sp.indices, sp.data, n_cols=sp.shape[1], **kw
            )
        import scipy.sparse as sps

        bsr = sps.bsr_matrix(sp, blocksize=(block_size, block_size))
        bsr.sort_indices()
        return SparseMatrix.from_csr(
            bsr.indptr, bsr.indices, bsr.data,
            n_cols=sp.shape[1] // block_size, block_size=block_size, **kw
        )

    # ---- value updates (structure reuse) -------------------------------

    def replace_values(self, values) -> "SparseMatrix":
        """A matrix of the same structure and formats with new CSR
        ``values`` (the JAX package's ``replace_values``, reference
        ``AMGX_matrix_replace_coefficients``).  ``values`` is a tensor
        or array of ``nnz`` entries (b x b blocks for a block matrix,
        any shape of ``nnz * b * b`` entries) in CSR order; it is taken
        to this matrix's device and dtype.  Every format is refilled on the
        device: ``diag``, the DIA planes, the slot-major and sliced ELL
        values and the stencil coefficients by gathers from
        first-occurrence source maps (padding stays 0), the dense block
        by a scatter.  A MATRIX_FREE matrix keeps its stencil class:
        the caller swaps the values of the operator detection verified,
        as in the JAX package."""
        if isinstance(values, torch.Tensor):
            v = values.to(device=self.device, dtype=self.dtype)
        else:
            v = to_tensor(np.asarray(values), self.device).to(self.dtype)
        if v.numel() != self.values.numel():
            raise ValueError(
                f"replace_values: {v.numel()} values for {self.nnz} "
                f"stored entries of shape {tuple(self.values.shape[1:])}"
            )
        v = v.reshape(self.values.shape).contiguous()
        maps = self._src_maps()
        rep = {"values": v, "diag": _gather_src(maps["diag"], v),
               "_host_csr": (self._host_csr[0], self._host_csr[1], None)}
        if self.has_dia:
            rep["dia_vals"] = _gather_src(maps["dia"], v)
        if self.has_matrix_free:
            rep["mf_coefs"] = _gather_src(self.mf_src, v)
        if self.has_dense:
            rep["dense"] = torch.zeros_like(self.dense).index_put_(
                (self.row_ids.long(), self.col_indices.long()), v,
                accumulate=True)
        if self.has_ell:
            rep["ell_vals"] = _gather_src(maps["ell"], v)
            if self.sell is not None:
                rep["sell"] = dataclasses.replace(
                    self.sell, vals=_gather_src(maps["sell"], v))
        return self._propagate_structure_memo(
            dataclasses.replace(self, **rep))

    def replace_values_batched(self, values) -> "SparseMatrix":
        """A batched view of B instances of this scalar matrix's
        structure (the serve layer's groups), one row of ``values`` (B,
        nnz) each, in CSR order: the index arrays are shared, and
        ``values`` (B, nnz), ``diag`` (B, n_rows), the DIA planes (B, nd,
        n_rows), the slot-major ELL values (B, w, n_rows), the sliced
        ELL values (B, stored; its index arrays and plan shared) and
        ``dense`` (B, n_rows, n_cols) are refilled on the device through
        the same source maps as :meth:`replace_values` (a scatter for
        dense), so each instance's arrays are what ``replace_values``
        gives it.  A matrix with the sliced layout gives a view with
        that layout alone: its batched SpMVs take only ``sell``, so the
        view has no slot-major ``ell_cols`` / ``ell_vals`` (``has_ell``
        stays true).  The view keeps no host triple; ``spmv`` takes it
        with x (B, n_cols).  Not for block or MATRIX_FREE matrices."""
        if self.block_size != 1 or self.has_matrix_free or self.batch:
            raise NotImplementedError(
                "replace_values_batched: scalar matrices without the "
                "MATRIX_FREE format only, and not a batched view")
        if isinstance(values, torch.Tensor):
            v = values.to(device=self.device, dtype=self.dtype)
        else:
            v = to_tensor(np.asarray(values), self.device).to(self.dtype)
        if v.dim() != 2 or v.shape[1] != self.nnz:
            raise ValueError(
                f"replace_values_batched: values {tuple(v.shape)} for "
                f"{self.nnz} stored entries; expected (B, nnz)")
        v = v.contiguous()
        B = int(v.shape[0])
        maps = self._src_maps()
        rep = {"values": v, "diag": _gather_src_batched(maps["diag"], v),
               "batch": B,
               "_host_csr": (self._host_csr[0], self._host_csr[1], None)}
        if self.has_dia:
            rep["dia_vals"] = _gather_src_batched(maps["dia"], v)
        if self.has_dense:
            m, k = self.dense.shape
            flat = (self.row_ids.long() * k + self.col_indices.long())
            rep["dense"] = torch.zeros(
                (B, m * k), dtype=v.dtype, device=v.device
            ).index_add_(1, flat, v).reshape(B, m, k)
        if self.sell is not None:
            rep["sell"] = dataclasses.replace(
                self.sell, vals=_gather_src_batched(maps["sell"], v))
            rep["ell_cols"] = rep["ell_vals"] = None
        elif self.has_ell:
            rep["ell_vals"] = _gather_src_batched(maps["ell"], v)
        return self._propagate_structure_memo(
            dataclasses.replace(self, **rep))

    def astype(self, dtype) -> "SparseMatrix":
        """The same matrix with values of ``dtype`` (torch.bfloat16,
        float32 or float64, or a numpy dtype or name of one), every
        format cast on the device: the CSR values, ``diag``, the DIA
        planes, the slot-major and sliced ELL values (the sliced
        layout's permutation and offsets kept, its plan too but for
        bf16, which takes one lane a row: ``ops/ell.py``), ``dense`` and
        the MATRIX_FREE coefficients (the JAX package's ``astype``).
        Returns ``self`` where the dtype already matches.  The index
        arrays, the stencil class and ``replace_values``' source maps
        (``_src``) are shared, so a cast matrix still takes new
        values.  Its host triple casts on the host where numpy has the
        dtype and reads back from the device (as float32) for bf16."""
        dt = torch_dtype(dtype)
        if dt == self.dtype:
            return self
        ro, ci, v = self._host_csr
        if v is not None and dt != torch.bfloat16:
            v = v.astype(host_dtype(dt))
        else:
            v = None
        rep = {"values": self.values.to(dt), "diag": self.diag.to(dt),
               "_host_csr": (ro, ci, v)}
        for name in ("dia_vals", "mf_coefs", "dense", "ell_vals"):
            t = getattr(self, name)
            if t is not None:
                rep[name] = t.to(dt)
        if self.sell is not None:
            rep["sell"] = dataclasses.replace(
                self.sell, vals=self.sell.vals.to(dt),
                lanes=1 if dt == torch.bfloat16 else self.sell.lanes)
        return self._propagate_structure_memo(
            dataclasses.replace(self, **rep))

    def _src_maps(self) -> dict:
        """Source maps of :meth:`replace_values` on the device: for each
        slot of ``diag``, the DIA planes and the slot-major and sliced
        ELL arrays, the CSR index of the first entry stored there (-1:
        none).  Derived from the index arrays on the first call and
        shared with every matrix ``replace_values`` derives."""
        if self._src is not None:
            return self._src
        n, nnz, dev = self.n_rows, self.nnz, self.device
        rows = self.row_ids.long()
        cols = self.col_indices.long()
        maps = {}
        on_diag = cols == rows
        maps["diag"] = _first_src(n, rows[on_diag],
                                  torch.nonzero(on_diag).reshape(-1))
        entries = torch.arange(nnz, dtype=torch.int64, device=dev)
        if self.has_dia:
            k = torch.searchsorted(self.dia_offsets_dev.long(), cols - rows)
            maps["dia"] = _first_src(
                len(self.dia_offsets) * n, k * n + rows, entries
            ).reshape(len(self.dia_offsets), n)
        if self.ell_cols is not None:
            w = int(self.ell_cols.shape[0])
            slot = entries - self.row_offsets.long()[rows]
            maps["ell"] = _first_src(w * n, slot * n + rows,
                                     entries).reshape(w, n)
            S = self.sell
            if S is not None:
                pos = rows
                if S.rows is not None:
                    inv = torch.empty(n, dtype=torch.int64, device=dev)
                    inv[S.rows.long()] = torch.arange(
                        n, dtype=torch.int64, device=dev)
                    pos = inv[rows]
                at = (S.offsets[pos // SELL_C] + slot * SELL_C
                      + pos % SELL_C)
                maps["sell"] = _first_src(S.stored, at, entries)
        self._src = maps
        return maps

    # ---- host conversions -----------------------------------------------

    def host_csr(self):
        """Read-only scipy CSR view of the host triple the matrix was
        built from (no device copy).  Callers must not mutate it.  A
        block matrix gives its scalar expansion (a new CSR, every entry
        of every block stored, through scipy's BSR), as the JAX
        package's does."""
        import scipy.sparse as sps

        ro, ci, v = self._host
        b = self.block_size
        if b == 1:
            return sps.csr_matrix(
                (v, ci, ro), shape=(self.n_rows, self.n_cols), copy=False
            )
        return sps.bsr_matrix(
            (v, ci, ro), shape=(self.n_rows * b, self.n_cols * b)
        ).tocsr()

    def to_scipy(self):
        """Mutable scipy CSR copy (the scalar expansion of a block
        matrix, which :meth:`host_csr` builds anew)."""
        import scipy.sparse as sps

        if self.block_size != 1:
            return self.host_csr()
        ro, ci, v = self._host
        return sps.csr_matrix(
            (v.copy(), ci.copy(), ro.copy()),
            shape=(self.n_rows, self.n_cols),
        )

    def to_dense(self):
        return np.asarray(self.to_scipy().todense())


# ---------------------------------------------------------------------------
# host helpers (copies of the JAX package's numpy code)


def _first_src(n_slots, slot, entry):
    """(n_slots,) int32 map: the least of the CSR indices ``entry``
    whose slot is ``slot``, -1 for a slot no entry fills (the JAX
    package's first-occurrence rule, which its host builders apply with
    ``np.minimum.at``)."""
    nnz_end = torch.iinfo(torch.int64).max
    src = torch.full((n_slots,), nnz_end, dtype=torch.int64,
                     device=slot.device)
    src.scatter_reduce_(0, slot, entry, "amin")
    return torch.where(src == nnz_end, -1, src).to(torch.int32)


def _gather_src(src, values):
    """``values`` gathered into a layout through a source map, 0 where
    the map holds -1 (the JAX package's ``_gather_src``)."""
    v = values[src.clamp(min=0)]
    mask = (src >= 0).reshape(src.shape + (1,) * (values.dim() - 1))
    return torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                            device=v.device))


def _gather_src_batched(src, values):
    """:func:`_gather_src` of each row of ``values`` (B, nnz): (B,) +
    ``src.shape``."""
    v = values[:, src.clamp(min=0)]
    return torch.where(src >= 0, v, torch.zeros((), dtype=v.dtype,
                                                device=v.device))


def sparsity_fingerprint(row_offsets, col_indices, n_rows, n_cols,
                         block_size=1) -> str:
    """Hash of a CSR sparsity pattern from host arrays (the JAX
    package's ``sparsity_fingerprint``): blake2b over the shape, the
    block size, nnz and the int32 index arrays, so an int64 and an
    int32 upload of one pattern collide."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(
        np.asarray(
            [n_rows, n_cols, block_size, len(col_indices)], dtype=np.int64
        ).tobytes()
    )
    h.update(np.ascontiguousarray(row_offsets, dtype=np.int32).tobytes())
    h.update(np.ascontiguousarray(col_indices, dtype=np.int32).tobytes())
    return h.hexdigest()


def _row_ids_np(row_offsets, n_rows):
    return np.repeat(
        np.arange(n_rows, dtype=np.int32), np.diff(row_offsets)
    )


def _entries_unique(row_ids, col_indices) -> bool:
    """No (row, column) pair repeats: every row's columns strictly
    increase (the sorted CSR of an upload; ``row_ids`` never decrease).
    False as well when a row is not sorted."""
    if col_indices.shape[0] < 2:
        return True
    return bool(np.all((col_indices[1:] > col_indices[:-1])
                       | (row_ids[1:] != row_ids[:-1])))


def _extract_diag_np(row_offsets, col_indices, values, n_rows):
    """(n_rows,) or, for (nnz, b, b) block values, (n_rows, b, b)."""
    diag = np.zeros((n_rows,) + values.shape[1:], dtype=values.dtype)
    row_ids = _row_ids_np(row_offsets, n_rows)
    hit = col_indices == row_ids
    if _entries_unique(row_ids, col_indices):
        # one entry a position: the sum below is 0 + v, an assignment
        # (the + 0 keeps its +0.0 for a -0.0)
        diag[row_ids[hit]] = values[hit] + values.dtype.type(0)
    else:
        # sum duplicates, matching the DIA/ELL/CSR SpMV paths
        np.add.at(diag, row_ids[hit], values[hit])
    return diag


def _build_ell_np(row_offsets, col_indices, values, n_rows, w):
    """Row-major (n_rows, w) ELL arrays ((n_rows, w, b, b) values for
    blocks), as the JAX package builds them; the caller transposes to
    the port's slot-major layout."""
    ell_cols = np.zeros((n_rows, w), dtype=np.int32)
    ell_vals = np.zeros((n_rows, w) + values.shape[1:], dtype=values.dtype)
    row_ids = _row_ids_np(row_offsets, n_rows)
    pos = np.arange(col_indices.shape[0], dtype=np.int64) - row_offsets[
        row_ids
    ].astype(np.int64)
    ell_cols[row_ids, pos] = col_indices
    ell_vals[row_ids, pos] = values
    return ell_cols, ell_vals


# the windows sliced ELL may sort rows in (1: no sorting)
SELL_SIGMAS = (1, 128, 1024)


def sell_order_np(row_lens, sigma):
    """Sorted position -> row: rows ordered by length, longest first,
    within consecutive windows of ``sigma`` rows (stable, so rows of one
    length keep their order); None for ``sigma`` 1."""
    if sigma == 1:
        return None
    n = row_lens.shape[0]
    window = np.arange(n, dtype=np.int64) // sigma
    return np.lexsort((-row_lens.astype(np.int64), window)).astype(np.int32)


def sell_widths_np(row_lens, order):
    """Width of each 32-row slice of the rows in sorted ``order``."""
    lens = row_lens if order is None else row_lens[order]
    n_slices = -(-lens.shape[0] // SELL_C)
    padded = np.zeros(n_slices * SELL_C, dtype=np.int64)
    padded[:lens.shape[0]] = lens
    return padded.reshape(n_slices, SELL_C).max(axis=1)


def sell_stream_bytes(widths, n_rows, itemsize, sigma):
    """Bytes the sliced kernel streams besides x and y: a column index
    and a value for every stored slot, each slice's offset and width,
    and the row permutation when rows are sorted."""
    return (int(widths.sum()) * SELL_C * (4 + itemsize)
            + 12 * widths.shape[0] + (4 * n_rows if sigma > 1 else 0))


# warps that keep the card's memory system busy on a gather kernel
# (132 SMs x 32); a matrix with fewer slices gives each row more lanes
_SELL_FILL_WARPS = 4096


def sell_lanes(widths):
    """Lanes the kernel gives each row: 1 where the slices alone give
    ``_SELL_FILL_WARPS`` warps, else doubled (to 8 at most) until they
    do, as long as each lane keeps a slot of the mean slice width."""
    n = widths.shape[0]
    mean = float(widths.mean()) if n else 0.0
    lanes = 1
    while lanes < 8 and n * lanes < _SELL_FILL_WARPS \
            and mean >= 2 * lanes:
        lanes *= 2
    return lanes


# a wider window scatters the rows of a slice over more of the matrix,
# so their x gathers and y writes touch more lines: it is taken only
# where it streams this many times fewer bytes than the narrower one
SELL_WINDOW_GAIN = 1.25


def sell_plan_np(row_lens, itemsize, limit=None, sigmas=SELL_SIGMAS):
    """The sliced layout's window: of ``sigmas`` whose layouts stream
    fewer bytes than ``limit`` (None: no limit), the smallest that
    streams at most ``SELL_WINDOW_GAIN`` times the fewest bytes of any.
    Returns ``(bytes, sigma, order, widths)``, or None where no window
    is under ``limit``."""
    n = row_lens.shape[0]
    plans = []
    for sigma in sorted(sigmas):
        order = sell_order_np(row_lens, sigma)
        widths = sell_widths_np(row_lens, order)
        nbytes = sell_stream_bytes(widths, n, itemsize, sigma)
        if limit is None or nbytes < limit:
            plans.append((nbytes, sigma, order, widths))
    if not plans:
        return None
    least = min(p[0] for p in plans)
    return next(p for p in plans if p[0] <= SELL_WINDOW_GAIN * least)


def _build_sell_np(row_offsets, col_indices, values, n_rows, w,
                   sigmas=SELL_SIGMAS, always=False):
    """Sliced ELL arrays of a CSR matrix (``ops/ell.SlicedEll``'s
    layout) as numpy arrays in a dict, with the plan (sigma, lanes).
    None where every window would stream as many bytes as the
    slot-major arrays' ``n_rows * w`` slots or more (every slice as wide
    as the widest row), unless ``always``."""
    row_lens = np.diff(row_offsets).astype(np.int64)
    itemsize = values.dtype.itemsize
    plan = sell_plan_np(
        row_lens, itemsize,
        None if always else n_rows * w * (4 + itemsize), sigmas)
    if plan is None:
        return None
    _, sigma, order, widths = plan
    offsets = np.zeros(widths.shape[0] + 1, dtype=np.int64)
    np.cumsum(widths * SELL_C, out=offsets[1:])
    # sorted position of every row, then the slot of every entry
    pos = np.arange(n_rows, dtype=np.int64)
    if order is not None:
        pos[order] = np.arange(n_rows, dtype=np.int64)
    row_ids = _row_ids_np(row_offsets, n_rows)
    slot = np.arange(col_indices.shape[0], dtype=np.int64) - row_offsets[
        row_ids
    ].astype(np.int64)
    p = pos[row_ids]
    at = offsets[p // SELL_C] + slot * SELL_C + p % SELL_C
    cols = np.zeros(offsets[-1], dtype=np.int32)
    vals = np.zeros(offsets[-1], dtype=values.dtype)
    cols[at] = col_indices
    vals[at] = values
    return {"cols": cols, "vals": vals, "offsets": offsets,
            "widths": widths.astype(np.int32), "rows": order,
            "n_rows": int(n_rows), "sigma": sigma,
            "lanes": sell_lanes(widths)}


def sliced_ell(host, device):
    """:class:`SlicedEll` on ``device`` from a dict of
    :func:`_build_sell_np`, or None for None."""
    if host is None:
        return None
    return SlicedEll(
        **{k: None if host[k] is None else to_tensor(host[k], device)
           for k in ("cols", "vals", "offsets", "widths", "rows")},
        n_rows=host["n_rows"], sigma=host["sigma"], lanes=host["lanes"],
    )


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
    idx = np.arange(col_indices.shape[0], dtype=np.int32)
    if _entries_unique(row_ids, col_indices):
        # one entry a position: the scatters below reduce to
        # assignments (0 + v keeps add.at's +0.0 for a -0.0), without
        # ufunc.at's per-element cost
        dia_vals[k, row_ids] = values + values.dtype.type(0)
        dia_src = np.full((uniq.shape[0], n), -1, dtype=np.int32)
        dia_src[k, row_ids] = idx
        return tuple(int(o) for o in uniq), dia_vals, dia_src
    # add (not assign): duplicate (row,col) entries must sum, matching
    # the ELL/CSR SpMV paths
    np.add.at(dia_vals, (k, row_ids), values)
    # unbuffered minimum: FIRST occurrence wins
    sentinel = np.iinfo(np.int32).max
    dia_src = np.full((uniq.shape[0], n), sentinel, dtype=np.int32)
    np.minimum.at(dia_src, (k, row_ids), idx)
    dia_src[dia_src == sentinel] = -1
    return tuple(int(o) for o in uniq), dia_vals, dia_src
