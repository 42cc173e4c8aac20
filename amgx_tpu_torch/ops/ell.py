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

Dtypes, as in ``ops/dia.py``: y has the promoted dtype of the values
and x, and the plain versions compute in it with torch's promotion
(bf16 in bf16).  ``ell_spmv`` is built for (f32, f32), (f64, f64),
(bf16, bf16), (bf16, f32) and (f32, f64): the transfers of a
reduced-precision hierarchy, whose level-0 restriction meets the
finer residual under ``level_dtype_policy`` COARSE; ``sell_spmv`` for
(f32, f32), (f64, f64), (bf16, bf16), (bf16, f32) and (f32, f64), the
last two for unstructured matrices in the C API's mixed modes (dFBI,
dDFI / dIFI).  bf16 values take one lane a row only, so that their sums
run in the plain version's order (``csrc/dtypes.cuh``).  Both kernels,
and both batched ones, are also built for the complex modes' (c64,
c64), (c128, c128) and (c64, c128) (dCCI, dZZI, dZCI; the batched ones
for one dtype), held to the plain versions' torch complex products
within a tolerance.

The serve layer's batched entries take B instances of one structure,
values batched or shared by every instance, in f32 and f64:
``sell_spmv_batched`` for a matrix with the sliced layout (a batched
view keeps its template's, ``SparseMatrix.replace_values_batched``),
each instance's y ``sell_spmv``'s bit for bit; ``ell_spmv_batched``
for the slot-major rest (the batch a grid axis of the ``ell_spmv``
kernel).

``launches`` counts ``ell_spmv`` kernel launches, ``sell_launches``
those of ``sell_spmv``, ``batched_launches`` those of
``ell_spmv_batched`` and ``sell_batched_launches`` those of
``sell_spmv_batched`` (never plain-version calls), ``variant_launches``
all four per entry point; reset them by assigning 0 and an empty dict.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from amgx_tpu_torch.ops import kernels

launches = 0
sell_launches = 0
batched_launches = 0
sell_batched_launches = 0
variant_launches: dict = {}

# rows per slice: one warp's worth, so one warp's loads of one slot are
# 32 neighbouring entries
SELL_C = 32
# the most instances a tile of the batched sliced kernel takes
# (``kMaxTile`` in ``csrc/ell_spmv.cu``): its copy of x holds the batch
# rounded up to a multiple of it
SELL_BATCH_TILE_MAX = 16



def ell_spmv_plain(ell_cols, ell_vals, x):
    """y_i = sum_s ell_vals[s, i] * x[ell_cols[s, i]] in slot order from
    +0.0; square or rectangular."""
    w, n = ell_vals.shape
    y = torch.zeros(n, dtype=torch.promote_types(ell_vals.dtype, x.dtype),
                    device=x.device)
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
    entry = kernels.entry_point("ell_spmv", ell_vals.dtype, x.dtype)
    if entry is None:
        raise NotImplementedError(
            f"ell_spmv: dtypes {ell_vals.dtype}/{x.dtype}; the kernel "
            "takes float32, float64, bfloat16, complex64 or complex128 "
            "values with x of their dtype, bfloat16 values with float32 "
            "x, float32 values with float64 x, or complex64 values with "
            "complex128 x"
        )
    if ell_cols.dtype != torch.int32:
        raise ValueError(f"ell_spmv: cols must be int32, got {ell_cols.dtype}")
    if not (ell_cols.is_contiguous() and ell_vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_spmv: inputs must be contiguous")
    y = torch.empty(n, dtype=torch.promote_types(ell_vals.dtype, x.dtype),
                    device=x.device)
    if n == 0:
        return y
    fn = getattr(kernels.library("ell_spmv"), entry)
    rc = fn(ell_cols.data_ptr(), ell_vals.data_ptr(), w, x.data_ptr(),
            y.data_ptr(), n, kernels.stream_handle(x.device))
    kernels.check_launch("ell_spmv", rc)
    launches += 1
    variant_launches[entry] = variant_launches.get(entry, 0) + 1
    return y


def ell_spmv_batched_plain(ell_cols, ell_vals, x):
    """:func:`ell_spmv_plain` over a leading batch dimension: ``x`` (B,
    m), ``ell_vals`` (B, w, n) or (w, n) shared by every instance; each
    instance's rows sum in slot order from +0.0."""
    w, n = ell_cols.shape
    y = torch.zeros(x.shape[:-1] + (n,),
                    dtype=torch.promote_types(ell_vals.dtype, x.dtype),
                    device=x.device)
    for s in range(w):
        y = y + ell_vals[..., s, :] * x[..., ell_cols[s]]
    return y


def ell_spmv_batched(ell_cols, ell_vals, x):
    """y = A_b @ x_b for B instances of one slot-major ELL structure
    (the serve layer's groups): ``ell_cols`` (w, n_rows) int32 shared,
    ``ell_vals`` (B, w, n_rows) or (w, n_rows) shared by every instance
    (AMG's transfers), ``x`` (B, n_cols).  On the card the
    ``ell_spmv_batched`` kernel (f32, f64, c64, c128), each instance's y
    :func:`ell_spmv`'s bit for bit."""
    global batched_launches
    if x.dim() != 2 or ell_cols.dim() != 2 \
            or ell_vals.shape[-2:] != ell_cols.shape \
            or ell_vals.dim() not in (2, 3) \
            or (ell_vals.dim() == 3 and ell_vals.shape[0] != x.shape[0]):
        raise ValueError(
            f"ell_spmv_batched: cols {tuple(ell_cols.shape)}, vals "
            f"{tuple(ell_vals.shape)}, x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ell_spmv_batched_plain(ell_cols, ell_vals, x)
    w, n = ell_cols.shape
    B, m = x.shape
    if w > 0 and m == 0:
        raise ValueError("ell_spmv_batched: stored entries but an empty x")
    _check_cuda("ell_spmv_batched", x, (ell_cols, ell_vals))
    entry = (kernels.entry_point("ell_spmv_batched", ell_vals.dtype,
                                 x.dtype) if ell_vals.dtype == x.dtype
             else None)
    if entry is None:
        raise NotImplementedError(
            f"ell_spmv_batched: dtypes {ell_vals.dtype}/{x.dtype}; the "
            "kernel takes float32, float64, complex64 or complex128 values "
            "with x of their dtype")
    if ell_cols.dtype != torch.int32:
        raise ValueError(
            f"ell_spmv_batched: cols must be int32, got {ell_cols.dtype}")
    if not (ell_cols.is_contiguous() and ell_vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_spmv_batched: inputs must be contiguous")
    if not 1 <= B <= 65535:
        raise ValueError(f"ell_spmv_batched: batch {B} outside 1..65535")
    y = torch.empty((B, n), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    fn = getattr(kernels.library("ell_spmv"), entry)
    rc = fn(ell_cols.data_ptr(), ell_vals.data_ptr(), w, x.data_ptr(),
            y.data_ptr(), n, m, B, int(ell_vals.dim() == 2),
            kernels.stream_handle(x.device))
    kernels.check_launch("ell_spmv_batched", rc)
    batched_launches += 1
    variant_launches[entry] = variant_launches.get(entry, 0) + 1
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

    cols (stored,) int32, vals (stored,) (a batched view's: (B,
    stored), its structure shared), offsets (n_slices + 1,) int64,
    widths (n_slices,) int32, rows (n_rows,) int32 or None.
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
        return int(self.vals.shape[-1])

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
    0 * x[0] = NaN from the padding slots this layout does not store.
    Leading dimensions of ``x`` (and of ``S.vals``, a batched view's)
    are a batch, each instance summed as alone."""
    ns = S.n_slices
    dev = x.device
    lane = torch.arange(SELL_C, device=dev, dtype=torch.int64)
    k = torch.arange(ns, device=dev, dtype=torch.int64).repeat_interleave(
        SELL_C)
    base = S.offsets[:-1][k] + lane.repeat(ns)
    wk = S.widths[k]
    dt = torch.promote_types(S.vals.dtype, x.dtype)
    acc = torch.zeros(x.shape[:-1] + (ns * SELL_C,), dtype=dt, device=dev)
    width = int(S.widths.max()) if ns else 0
    zero = torch.zeros((), dtype=dt, device=dev)
    for s in range(width):
        live = wk > s
        idx = torch.where(live, base + SELL_C * s, 0)
        acc = acc + torch.where(live, S.vals[..., idx] * x[..., S.cols[idx]],
                                zero)
    acc = acc[..., :S.n_rows]
    if S.rows is None:
        return acc
    y = torch.empty(x.shape[:-1] + (S.n_rows,), dtype=dt, device=dev)
    y[..., S.rows.long()] = acc
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
    entry = kernels.entry_point("sell_spmv", S.vals.dtype, x.dtype)
    if entry is None:
        raise NotImplementedError(
            f"sell_spmv: dtypes {S.vals.dtype}/{x.dtype}; the kernel "
            "takes float32, float64, bfloat16, complex64 or complex128 "
            "values with x of their dtype, bfloat16 values with float32 "
            "x, float32 values with float64 x, or complex64 values with "
            "complex128 x"
        )
    if (S.cols.dtype, S.offsets.dtype, S.widths.dtype) != (
            torch.int32, torch.int64, torch.int32) or (
            S.rows is not None and S.rows.dtype != torch.int32):
        raise ValueError("sell_spmv: cols, widths and rows must be int32, "
                         "offsets int64")
    if S.lanes not in (1, 2, 4, 8) or (
            S.lanes != 1 and S.vals.dtype == torch.bfloat16):
        raise ValueError(f"sell_spmv: {S.lanes} lanes a row for "
                         f"{S.vals.dtype} (bfloat16 takes 1)")
    if not all(t.is_contiguous() for t in [*ts, x]):
        raise ValueError("sell_spmv: inputs must be contiguous")
    y = torch.empty(S.n_rows, dtype=x.dtype, device=x.device)
    if S.n_rows == 0:
        return y
    fn = getattr(kernels.library("ell_spmv"), entry)
    rc = fn(S.cols.data_ptr(), S.vals.data_ptr(), S.offsets.data_ptr(),
            S.widths.data_ptr(),
            None if S.rows is None else S.rows.data_ptr(),
            S.n_slices, S.lanes, x.data_ptr(), y.data_ptr(), S.n_rows,
            kernels.stream_handle(x.device))
    kernels.check_launch("sell_spmv", rc)
    sell_launches += 1
    variant_launches[entry] = variant_launches.get(entry, 0) + 1
    return y


# the plain batched version: ``sell_spmv_plain`` takes ``x`` (B, m) and
# ``S.vals`` (B, stored) or (stored,) shared by every instance itself
sell_spmv_batched_plain = sell_spmv_plain


def sell_spmv_batched(S: SlicedEll, x):
    """y = A_b @ x_b for B instances of one sliced ELL structure (the
    serve layer's groups): ``S.vals`` (B, stored) or (stored,) shared by
    every instance (AMG's transfers), ``x`` (B, n_cols).  On the card
    the ``sell_spmv_batched`` kernel (f32, f64, c64, c128) with the plan
    ``S.lanes``, each instance's y :func:`sell_spmv`'s bit for bit."""
    global sell_batched_launches
    if x.dim() != 2 or S.vals.dim() not in (1, 2) \
            or S.cols.shape[0] != S.vals.shape[-1] \
            or (S.vals.dim() == 2 and S.vals.shape[0] != x.shape[0]) \
            or S.offsets.shape[0] != S.n_slices + 1 \
            or S.n_slices * SELL_C < S.n_rows \
            or (S.rows is not None and S.rows.shape != (S.n_rows,)):
        raise ValueError(
            f"sell_spmv_batched: cols {tuple(S.cols.shape)}, vals "
            f"{tuple(S.vals.shape)}, {S.n_slices} slices for {S.n_rows} "
            f"rows, x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return sell_spmv_plain(S, x)
    B, m = x.shape
    if S.stored > 0 and m == 0:
        raise ValueError("sell_spmv_batched: stored entries but an empty x")
    ts = [S.cols, S.vals, S.offsets, S.widths]
    if S.rows is not None:
        ts.append(S.rows)
    _check_cuda("sell_spmv_batched", x, ts)
    entry = (kernels.entry_point("sell_spmv_batched", S.vals.dtype, x.dtype)
             if S.vals.dtype == x.dtype else None)
    if entry is None:
        raise NotImplementedError(
            f"sell_spmv_batched: dtypes {S.vals.dtype}/{x.dtype}; the "
            "kernel takes float32, float64, complex64 or complex128 values "
            "with x of their dtype")
    if (S.cols.dtype, S.offsets.dtype, S.widths.dtype) != (
            torch.int32, torch.int64, torch.int32) or (
            S.rows is not None and S.rows.dtype != torch.int32):
        raise ValueError("sell_spmv_batched: cols, widths and rows must be "
                         "int32, offsets int64")
    if S.lanes not in (1, 2, 4, 8):
        raise ValueError(f"sell_spmv_batched: {S.lanes} lanes a row")
    if not all(t.is_contiguous() for t in [*ts, x]):
        raise ValueError("sell_spmv_batched: inputs must be contiguous")
    if not 1 <= B <= 65535:
        raise ValueError(f"sell_spmv_batched: batch {B} outside 1..65535")
    y = torch.empty((B, S.n_rows), dtype=x.dtype, device=x.device)
    if S.n_rows == 0:
        return y
    # the kernel's instance-minor copy of x, the batch in tiles
    scratch = torch.empty(-(-B // SELL_BATCH_TILE_MAX) * SELL_BATCH_TILE_MAX
                          * m, dtype=x.dtype, device=x.device)
    fn = getattr(kernels.library("ell_spmv"), entry)
    rc = fn(S.cols.data_ptr(), S.vals.data_ptr(), S.offsets.data_ptr(),
            S.widths.data_ptr(),
            None if S.rows is None else S.rows.data_ptr(),
            S.n_slices, S.lanes, x.data_ptr(), y.data_ptr(), S.n_rows, m,
            S.stored, B, int(S.vals.dim() == 1), scratch.data_ptr(),
            kernels.stream_handle(x.device))
    kernels.check_launch("sell_spmv_batched", rc)
    sell_batched_launches += 1
    variant_launches[entry] = variant_launches.get(entry, 0) + 1
    return y


def _check_cuda(name, x, tensors):
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensors on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
