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
    arrays at the first ``replace_values`` and shared by every matrix
    derived from it (``_src``), so a matrix whose values never change
    holds none.  Only the stencil's map (``mf_src``, at most ``nd x L``
    entries) is kept from detection.  The host triple of a derived
    matrix reads its values back from the device once, when first
    asked for (``host_csr``, ``to_scipy``, the smoothers' setups).
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
        return self.ell_cols is not None

    @property
    def _host(self) -> tuple:
        """The host CSR triple ``(row_offsets, col_indices, values)``;
        the values of a matrix made by :meth:`replace_values` are read
        back from the device the first time (one read, counted as a
        setup sync inside a setup)."""
        ro, ci, v = self._host_csr
        if v is None:
            from amgx_tpu_torch.core.profiling import count_setup_sync

            count_setup_sync()
            v = self.values.detach().cpu().numpy()
            self._host_csr = (ro, ci, v)
        return self._host_csr

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

        mf_meta = mf_coefs = mf_src = None
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
                    mf_meta, mf_coefs, mf_src = det
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
                sell = _build_sell_np(row_offsets, col_indices, values,
                                      n_rows, w)

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
            sell=sliced_ell(sell, dev),
            mf_src=put(mf_src),
            _host_csr=(row_offsets, col_indices, values),
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

    # ---- value updates (structure reuse) -------------------------------

    def replace_values(self, values) -> "SparseMatrix":
        """A matrix of the same structure and formats with new CSR
        ``values`` (the JAX package's ``replace_values``, reference
        ``AMGX_matrix_replace_coefficients``).  ``values`` is a tensor
        or array of ``nnz`` entries in CSR order; it is taken to this
        matrix's device and dtype.  Every format is refilled on the
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
        if v.dim() > 1 and v.numel() != self.nnz:
            raise NotImplementedError(
                "replace_values: block values are not ported yet "
                "(ROADMAP.md, queue A: block matrices and reduced "
                "precision)"
            )
        v = v.reshape(-1).contiguous()
        if v.shape[0] != self.nnz:
            raise ValueError(
                f"replace_values: {v.shape[0]} values for {self.nnz} "
                "stored entries"
            )
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
        return dataclasses.replace(self, **rep)

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
        if self.has_ell:
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
    return torch.where(src >= 0, v, torch.zeros((), dtype=v.dtype,
                                                device=v.device))


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
