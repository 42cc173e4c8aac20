"""ELL SpMV: the CUDA kernels of ``csrc/ell_spmv.cu`` and their plain
versions.

Counterpart of the JAX package's ``ops/pallas_well.py`` (windowed-ELL
Pallas kernel) and the XLA gather path in ``ops/spmv.py``.  The TPU's
1024-row tiles, lane interleave and column windows are not carried
over.  Two layouts, two kernels:

  * slot-major ELL, ``(w, n_rows)`` (``ell_spmv``): every row padded to
    the matrix-wide width.  Matrices whose rows all need that width
    (the aggregation transfers) keep it;
  * sliced, row-sorted ELL (SELL-C-sigma, :class:`SlicedEll`,
    ``sell_spmv``): rows in slices of 32, each slice padded only to its
    own longest row, rows ordered by length within windows of sigma
    rows.  ``SparseMatrix.from_csr`` builds it beside the slot-major
    arrays where it moves fewer bytes (``core/matrix.py``), and SpMV
    then takes it.

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
raises.

``launches`` counts ``ell_spmv`` kernel launches and ``sell_launches``
those of ``sell_spmv`` (never plain-version calls); reset them by
assigning 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from amgx_tpu_torch.ops import kernels

launches = 0
sell_launches = 0

# rows per slice: one warp's worth, so one warp's loads of one slot are
# 32 neighbouring entries
SELL_C = 32

_FN = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}
_SELL_FN = {torch.float32: "sell_spmv_f32", torch.float64: "sell_spmv_f64"}


def ell_spmv_plain(ell_cols, ell_vals, x):
    """y_i = sum_s ell_vals[s, i] * x[ell_cols[s, i]] in slot order from
    +0.0; square or rectangular."""
    w, n = ell_vals.shape
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for s in range(w):
        y = y + ell_vals[s] * x[ell_cols[s]]
    return y


def ell_spmv(ell_cols, ell_vals, x):
    """y = A @ x for a slot-major ELL matrix: ``ell_cols`` int32 and
    ``ell_vals`` of shape (w, n_rows), ``x`` (n_cols,)."""
    global launches
    if x.device.type == "cpu":
        return ell_spmv_plain(ell_cols, ell_vals, x)
    if ell_vals.dim() != 2 or ell_cols.shape != ell_vals.shape \
            or x.dim() != 1:
        raise ValueError(
            f"ell_spmv: cols {tuple(ell_cols.shape)}, vals "
            f"{tuple(ell_vals.shape)}, x {tuple(x.shape)}"
        )
    w, n = ell_vals.shape
    if w > 0 and x.shape[0] == 0:
        raise ValueError("ell_spmv: stored entries but an empty x")
    _check_cuda("ell_spmv", x, (ell_cols, ell_vals))
    if ell_vals.dtype != x.dtype or x.dtype not in _FN:
        raise NotImplementedError(
            f"ell_spmv: dtypes {ell_vals.dtype}/{x.dtype}; the kernel "
            "takes float32 or float64"
        )
    if ell_cols.dtype != torch.int32:
        raise ValueError(f"ell_spmv: cols must be int32, got {ell_cols.dtype}")
    if not (ell_cols.is_contiguous() and ell_vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_spmv: inputs must be contiguous")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    fn = getattr(kernels.library("ell_spmv"), _FN[x.dtype])
    rc = fn(ell_cols.data_ptr(), ell_vals.data_ptr(), w, x.data_ptr(),
            y.data_ptr(), n, kernels.stream_handle(x.device))
    kernels.check_launch("ell_spmv", rc)
    launches += 1
    return y


@dataclasses.dataclass(eq=False)
class SlicedEll:
    """Sliced, row-sorted ELL (SELL-C-sigma) of an n_rows-row matrix.

    Slice k holds the rows at sorted positions 32k .. 32k+31 (positions
    past n_rows are empty padding rows).  Its ``widths[k]`` slots are
    stored slot-major from ``offsets[k]``: the entry of slot s of the
    row at lane l lies at ``offsets[k] + 32 s + l``.  Each row keeps its
    CSR entry order in slots 0, 1, ...; slots past its length hold
    column 0 and value 0.  ``rows[p]`` is the matrix row at sorted
    position p (None when ``sigma`` is 1: no reordering).

    cols (stored,) int32, vals (stored,), offsets (n_slices + 1,)
    int64, widths (n_slices,) int32, rows (n_rows,) int32 or None.
    ``sigma`` is the window rows were sorted in, ``lanes`` the lanes
    the kernel gives each row (1, 2, 4 or 8): the launch plan, fixed at
    upload.  ``SparseMatrix.replace_values`` refills ``vals`` through a
    source map over the stored slots (the CSR index of each, -1 for a
    padding slot, which stays 0), derived on the device from the index
    arrays and this layout on its first call; the plan is kept.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    offsets: torch.Tensor
    widths: torch.Tensor
    rows: Optional[torch.Tensor]
    n_rows: int
    sigma: int
    lanes: int

    @property
    def n_slices(self) -> int:
        return int(self.widths.shape[0])

    @property
    def stored(self) -> int:
        return int(self.vals.shape[0])

    def nbytes(self) -> int:
        """Device bytes of the sliced arrays."""
        ts = (self.cols, self.vals, self.offsets, self.widths, self.rows)
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None)


def sell_spmv_plain(S: SlicedEll, x):
    """y = A x from the sliced arrays: each row sums its slice's stored
    slots in slot order from +0.0 (padding slots inside the slice
    included, none past the slice's width).  For finite x this equals
    :func:`ell_spmv_plain` on the slot-major arrays bit for bit (the
    slots it skips add +0.0 or -0.0 there).  Where x holds an inf or a
    NaN, a row shorter than the matrix-wide width no longer picks up
    0 * x[0] = NaN from the padding slots this layout does not store."""
    ns = S.n_slices
    dev = x.device
    lane = torch.arange(SELL_C, device=dev, dtype=torch.int64)
    k = torch.arange(ns, device=dev, dtype=torch.int64).repeat_interleave(
        SELL_C)
    base = S.offsets[:-1][k] + lane.repeat(ns)
    wk = S.widths[k]
    acc = torch.zeros(ns * SELL_C, dtype=x.dtype, device=dev)
    width = int(S.widths.max()) if ns else 0
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    for s in range(width):
        live = wk > s
        idx = torch.where(live, base + SELL_C * s, 0)
        acc = acc + torch.where(live, S.vals[idx] * x[S.cols[idx]], zero)
    acc = acc[:S.n_rows]
    if S.rows is None:
        return acc
    y = torch.empty(S.n_rows, dtype=x.dtype, device=dev)
    y[S.rows.long()] = acc
    return y


def sell_spmv(S: SlicedEll, x):
    """y = A @ x for a matrix in sliced ELL, ``x`` (n_cols,): on the
    card the ``sell_spmv`` kernel with the plan ``S.lanes``."""
    global sell_launches
    if x.device.type == "cpu":
        return sell_spmv_plain(S, x)
    if x.dim() != 1 or S.cols.shape != S.vals.shape \
            or S.offsets.shape[0] != S.n_slices + 1 \
            or S.n_slices * SELL_C < S.n_rows \
            or (S.rows is not None and S.rows.shape != (S.n_rows,)):
        raise ValueError(
            f"sell_spmv: cols {tuple(S.cols.shape)}, vals "
            f"{tuple(S.vals.shape)}, {S.n_slices} slices for {S.n_rows} "
            f"rows, x {tuple(x.shape)}"
        )
    if S.stored > 0 and x.shape[0] == 0:
        raise ValueError("sell_spmv: stored entries but an empty x")
    ts = [S.cols, S.vals, S.offsets, S.widths]
    if S.rows is not None:
        ts.append(S.rows)
    _check_cuda("sell_spmv", x, ts)
    if S.vals.dtype != x.dtype or x.dtype not in _SELL_FN:
        raise NotImplementedError(
            f"sell_spmv: dtypes {S.vals.dtype}/{x.dtype}; the kernel "
            "takes float32 or float64"
        )
    if (S.cols.dtype, S.offsets.dtype, S.widths.dtype) != (
            torch.int32, torch.int64, torch.int32) or (
            S.rows is not None and S.rows.dtype != torch.int32):
        raise ValueError("sell_spmv: cols, widths and rows must be int32, "
                         "offsets int64")
    if S.lanes not in (1, 2, 4, 8):
        raise ValueError(f"sell_spmv: {S.lanes} lanes a row")
    if not all(t.is_contiguous() for t in [*ts, x]):
        raise ValueError("sell_spmv: inputs must be contiguous")
    y = torch.empty(S.n_rows, dtype=x.dtype, device=x.device)
    if S.n_rows == 0:
        return y
    fn = getattr(kernels.library("ell_spmv"), _SELL_FN[x.dtype])
    rc = fn(S.cols.data_ptr(), S.vals.data_ptr(), S.offsets.data_ptr(),
            S.widths.data_ptr(),
            None if S.rows is None else S.rows.data_ptr(),
            S.n_slices, S.lanes, x.data_ptr(), y.data_ptr(), S.n_rows,
            kernels.stream_handle(x.device))
    kernels.check_launch("sell_spmv", rc)
    sell_launches += 1
    return y


def _check_cuda(name, x, tensors):
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensors on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
