"""Sparse matrix-vector product (reference multiply, src/multiply.cu).

Dispatch order, as in the JAX package's ``ops/spmv.py``: MATRIX_FREE
-> DIA -> dense -> ELL -> CSR.

  * MATRIX_FREE: the ``stencil_spmv`` CUDA kernel on the card for a
    constant stencil, stock torch ops for an axis-separable one
    (``ops/stencil.py``);
  * DIA: the ``dia_spmv`` CUDA kernel on the card (``ops/dia.py``);
  * dense: ``torch.matmul`` (the JAX package leaves it to XLA);
  * ELL: the ``ell_spmv`` CUDA kernel on the card (``ops/ell.py``);
  * CSR: gather per entry + ``index_add_`` over the row ids.

On CPU tensors the stencil, DIA and ELL wrappers take their plain
versions.

``op_pass_counter`` mirrors the JAX package's counter of the same name:
every SpMV with a square operator records one pass while a counter is
active, so running one cycle under it counts the cycle's passes.
"""

from __future__ import annotations

import torch

from amgx_tpu_torch.ops.blas import make_site_counter
from amgx_tpu_torch.ops.dia import dia_spmv
from amgx_tpu_torch.ops.ell import ell_spmv
from amgx_tpu_torch.ops.stencil import stencil_spmv

record_op_pass, op_pass_counter = make_site_counter("op_pass")


def spmv(A, x, n_rows: int | None = None):
    """y = A @ x; ``n_rows`` keeps a leading row window of y."""
    if A.is_square:
        record_op_pass()
    y = _spmv_scalar(A, x)
    if n_rows is not None and n_rows != A.n_rows:
        y = y[:n_rows]
    return y


def _spmv_scalar(A, x):
    if A.has_matrix_free:
        return stencil_spmv(A, x)
    if A.has_dia:
        return dia_spmv(A.dia_vals, A.dia_offsets_dev, x)
    if A.has_dense:
        return torch.matmul(A.dense, x)
    if A.has_ell:
        return ell_spmv(A.ell_cols, A.ell_vals, x)
    contrib = A.values * x[A.col_indices]
    y = torch.zeros(A.n_rows, dtype=contrib.dtype, device=x.device)
    return y.index_add_(0, A.row_ids, contrib)


def residual(A, b, x):
    """r = b - A x."""
    return b - spmv(A, x)
