"""Sparse matrix-vector product (reference multiply, src/multiply.cu).

Dispatch order, as in the JAX package's ``ops/spmv.py``: MATRIX_FREE
-> DIA -> dense -> ELL -> CSR.

  * MATRIX_FREE: the ``stencil_spmv`` CUDA kernel on the card for a
    constant stencil, stock torch ops for an axis-separable one
    (``ops/stencil.py``);
  * DIA: the ``dia_spmv`` CUDA kernel on the card (``ops/dia.py``);
  * dense: ``torch.matmul`` (the JAX package leaves it to XLA);
  * ELL: the ``ell_spmv`` CUDA kernel on the card (``ops/ell.py``);
  * CSR: gather per entry + :func:`segment_sum` over the row offsets,
    which sums each row in entry order on both devices, so repeated
    products on the card agree bit for bit (``index_add_`` would sum
    with atomics there, in an order that changes from run to run).

On CPU tensors the stencil, DIA and ELL wrappers take their plain
versions.

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
from amgx_tpu_torch.ops.dia import dia_spmv
from amgx_tpu_torch.ops.ell import ell_spmv
from amgx_tpu_torch.ops.stencil import stencil_spmv

record_op_pass, op_pass_counter = make_site_counter("op_pass")

csr_products = 0


def spmv(A, x, n_rows: int | None = None):
    """y = A @ x; ``n_rows`` keeps a leading row window of y."""
    if A.is_square:
        record_op_pass()
    y = _spmv_scalar(A, x)
    if n_rows is not None and n_rows != A.n_rows:
        y = y[:n_rows]
    return y


def _spmv_scalar(A, x):
    global csr_products
    if A.has_matrix_free:
        return stencil_spmv(A, x)
    if A.has_dia:
        return dia_spmv(A.dia_vals, A.dia_offsets_dev, x)
    if A.has_dense:
        return torch.matmul(A.dense, x)
    if A.has_ell:
        return ell_spmv(A.ell_cols, A.ell_vals, x)
    if x.device.type == "cuda":
        csr_products += 1
    return segment_sum(A.values * x[A.col_indices], A.row_offsets)


def segment_sum(x, offsets):
    """Sums of the segments ``x[offsets[i]:offsets[i + 1]]``, each
    summed in order from +0.0, so the result repeats bit for bit.  The
    data goes in as one column: ``torch.segment_reduce`` then runs one
    thread per segment on the card, where 1-D data takes CUB's
    segmented reduce, a block per segment, an order of magnitude slower
    on short rows (``PERF.md``).  Complex data goes in as its (real,
    imaginary) column pair, which ``segment_reduce`` takes where it
    takes no complex dtype."""
    if x.is_complex():
        return torch.view_as_complex(torch.segment_reduce(
            torch.view_as_real(x), "sum", offsets=offsets, unsafe=True))
    return torch.segment_reduce(x.unsqueeze(1), "sum", offsets=offsets,
                                unsafe=True).squeeze(1)


def residual(A, b, x):
    """r = b - A x."""
    return b - spmv(A, x)
