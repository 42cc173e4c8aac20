"""Sparse matrix-vector product (reference multiply, src/multiply.cu).

Dispatch order, as in the JAX package's ``ops/spmv.py``: MATRIX_FREE
-> DIA -> dense -> ELL -> CSR.

  * MATRIX_FREE: the ``stencil_spmv`` CUDA kernel on the card for a
    constant stencil, stock torch ops for an axis-separable one
    (``ops/stencil.py``);
  * DIA: the ``dia_spmv`` CUDA kernel on the card (``ops/dia.py``);
  * dense: ``torch.matmul`` (the JAX package leaves it to XLA), both
    operands taken to their promoted dtype first: ``torch.matmul`` does
    not promote;
  * ELL: the ``sell_spmv`` CUDA kernel on the card where the matrix
    has its sliced layout, else the slot-major ``ell_spmv`` one
    (``ops/ell.py``);
  * CSR: gather per entry + :func:`segment_sum` over the row offsets,
    which sums each row in entry order on both devices, so repeated
    products on the card agree bit for bit (``index_add_`` would sum
    with atomics there, in an order that changes from run to run).

Block matrices (``block_size`` b > 1) take :func:`_spmv_block`, stock
torch ops as the JAX package's XLA ``einsum`` (no Pallas kernel there):
a block-ELL matrix gathers x as (w, n, b), multiplies each of its
(w, n, b, b) blocks with its slice of x in one batched b x b product
(the blocks are read in place, no copy) and sums over the slots;
otherwise each CSR block multiplies its gathered slice of x and
:func:`segment_sum` sums the (nnz, b) products of each block row.

On CPU tensors the stencil, DIA and ELL wrappers take their plain
versions (an ELL matrix with a sliced layout takes the sliced one).
Every branch returns the dtype the JAX package's returns: the
promoted dtype of the matrix values and x (bf16 with bf16 x, f32 with
bf16 values and f32 x, ...).

Batched products (the serve layer's groups of same-structure systems):
x of shape (B, n_cols) with a batched view of A
(``SparseMatrix.replace_values_batched``, values with a leading B) or
with a matrix shared by every instance (AMG's transfers) gives y (B,
n_rows), through :func:`_spmv_batched`: the ``dia_spmv_batched``
kernel on the card, ``sell_spmv_batched`` where the matrix has its
sliced layout, else ``ell_spmv_batched``, a batched
``torch.matmul`` for dense (the JAX package leaves it to XLA) and the
CSR products of each instance through :func:`segment_sum` (the
unbatched path's row order; ``csr_products`` counts them).  Scalar
matrices only; MATRIX_FREE has no batched form.

``op_pass_counter`` mirrors the JAX package's counter of the same name:
every SpMV with a square operator records one pass while a counter is
active, so running one cycle under it counts the cycle's passes.
``csr_products`` counts the CSR products on CUDA tensors (stock torch
ops, no hand-written kernel) as the kernel wrappers count their
launches; reset it by assigning 0.
"""

from __future__ import annotations

import torch

from amgx_tpu_torch.ops.blas import make_site_counter
from amgx_tpu_torch.ops.dia import dia_spmv, dia_spmv_batched
from amgx_tpu_torch.ops.ell import (
    ell_spmv,
    ell_spmv_batched,
    sell_spmv,
    sell_spmv_batched,
)
from amgx_tpu_torch.ops.stencil import stencil_spmv

record_op_pass, op_pass_counter = make_site_counter("op_pass")

csr_products = 0


def spmv(A, x, n_rows: int | None = None):
    """y = A @ x for flat x of ``n_cols * block_size``; ``n_rows``
    keeps a leading window of that many (block) rows of y."""
    if A.is_square:
        record_op_pass()
    if A.batch or x.dim() == 2:
        y = _spmv_batched(A, x)
        if n_rows is not None and n_rows != A.n_rows:
            y = y[..., :n_rows]
        return y
    b = A.block_size
    if b == 1:
        y = _spmv_scalar(A, x)
    else:
        y = _spmv_block(A, x.reshape(A.n_cols, b)).reshape(-1)
    if n_rows is not None and n_rows != A.n_rows:
        y = y[:n_rows * b]
    return y


def _spmv_scalar(A, x):
    global csr_products
    if A.has_matrix_free:
        return stencil_spmv(A, x)
    if A.has_dia:
        return dia_spmv(A.dia_vals, A.dia_offsets, x)
    if A.has_dense:
        dt = torch.promote_types(A.dense.dtype, x.dtype)
        return torch.matmul(A.dense.to(dt), x.to(dt))
    if A.has_ell:
        if A.sell is not None:
            return sell_spmv(A.sell, x)
        return ell_spmv(A.ell_cols, A.ell_vals, x)
    if x.device.type == "cuda":
        csr_products += 1
    return segment_sum(A.values * x[A.col_indices], A.row_offsets)


def _spmv_batched(A, x):
    """(B, n_rows) products of a batched view of A (or of A shared by
    every instance) with x (B, n_cols)."""
    global csr_products
    if x.dim() != 2 or (A.batch and x.shape[0] != A.batch):
        raise ValueError(
            f"batched spmv: x {tuple(x.shape)} for a batch of {A.batch}")
    if A.block_size != 1 or A.has_matrix_free:
        raise NotImplementedError(
            "batched spmv: scalar matrices without the MATRIX_FREE format "
            "only (ROADMAP.md, queue A: serving tier)")
    if A.has_dia:
        return dia_spmv_batched(A.dia_vals, A.dia_offsets, x)
    if A.has_dense:
        dt = torch.promote_types(A.dense.dtype, x.dtype)
        d, xd = A.dense.to(dt), x.to(dt)
        if A.batch:
            return torch.matmul(d, xd.unsqueeze(-1)).squeeze(-1)
        return torch.matmul(xd, d.T)
    if A.has_ell:
        if A.sell is not None:
            return sell_spmv_batched(A.sell, x)
        return ell_spmv_batched(A.ell_cols, A.ell_vals, x)
    if x.device.type == "cuda":
        csr_products += 1
    contrib = A.values * x[:, A.col_indices]
    return segment_sum(contrib.T.contiguous(), A.row_offsets).T.contiguous()


def _spmv_block(A, x2d):
    """(n_rows, b) product of a block matrix with x as (n_cols, b)."""
    if A.has_ell:
        w, n, b, _ = A.ell_vals.shape
        prod = torch.bmm(A.ell_vals.reshape(w * n, b, b),
                         x2d[A.ell_cols].reshape(w * n, b, 1))
        return prod.reshape(w, n, b).sum(dim=0)
    contrib = torch.bmm(A.values, x2d[A.col_indices].unsqueeze(2))
    return segment_sum(contrib.squeeze(2), A.row_offsets)


def segment_sum(x, offsets):
    """Sums of the segments ``x[offsets[i]:offsets[i + 1]]``, each
    summed in order from +0.0, so the result repeats bit for bit.  The
    data goes in as one column: ``torch.segment_reduce`` then runs one
    thread per segment on the card, where 1-D data takes CUB's
    segmented reduce, a block per segment, an order of magnitude slower
    on short rows (``PERF.md``).  Complex data goes in as its (real,
    imaginary) column pair, which ``segment_reduce`` takes where it
    takes no complex dtype.  A 2-D ``x`` sums its rows segment by
    segment, column by column."""
    if x.is_complex():
        return torch.view_as_complex(segment_sum(torch.view_as_real(x),
                                                 offsets))
    if x.dim() > 1:
        return torch.segment_reduce(x, "sum", offsets=offsets, unsafe=True)
    return torch.segment_reduce(x.unsqueeze(1), "sum", offsets=offsets,
                                unsafe=True).squeeze(1)


def residual(A, b, x):
    """r = b - A x."""
    return b - spmv(A, x)
