"""Jacobi-family smoothers (reference block_jacobi_solver.cu, the
default smoother; jacobi_l1_solver.cu): x += omega * D^-1 (b - A x).
Each sweep is one SpMV and an elementwise update; BLOCK_JACOBI on a
block matrix inverts its b x b diagonal blocks at setup and applies
them as a batched product, JACOBI_L1 runs on the scalar expansion (as
in the JAX package)."""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.core.matrix import (
    _extract_diag_np,
    _row_ids_np,
    to_tensor,
)
from amgx_tpu_torch.ops.diagonal import (
    apply_dinv,
    invert_diag,
    invert_diag_batched,
    reciprocal_np,
    scalarized,
)
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import register_solver


class _DiagSmootherBase(Solver):
    """Shared x += omega * Dinv r machinery; subclasses set params to
    (A, Dinv)."""

    def make_residual_step(self):
        omega = self.relaxation_factor
        # block size of the operator in params (JACOBI_L1 scalarizes at
        # setup, so self.A.block_size may differ)
        b_sz = self._params[0].block_size

        def rstep(params, b, x, r):
            _, dinv = params
            return x + omega * apply_dinv(dinv, r, b_sz)

        return rstep

    def make_apply(self):
        # zero-guess first sweep simplifies to omega*Dinv b; later
        # sweeps are full steps (reference smooth_with_0_initial_guess)
        step = self.make_step()
        omega = self.relaxation_factor
        b_sz = self._params[0].block_size
        iters = max(self.max_iters, 1)

        def apply(params, r):
            _, dinv = params
            z = omega * apply_dinv(dinv, r, b_sz)
            for _ in range(iters - 1):
                z = step(params, r, z)
            return z

        return apply


@register_solver("BLOCK_JACOBI")
class BlockJacobiSolver(_DiagSmootherBase):
    """x += omega * D^{-1} (b - A x); D = (block) diagonal."""

    def _setup_impl(self, A):
        self._params = (A, invert_diag(A))

    def make_batch_params(self):
        """Batched views of the operator and the inverse of each
        instance's diagonal (1 where it is 0, as :func:`invert_diag`),
        on the device; scalar matrices only."""
        A0 = self._params[0]
        if A0.block_size != 1:
            return None

        def fn(t, v):
            A = t.replace_values_batched(v)
            return A, invert_diag_batched(A.diag)

        return A0, fn


@register_solver("JACOBI_L1")
class JacobiL1Solver(_DiagSmootherBase):
    """L1-Jacobi: d_i = |a_ii| + sum_{j != i} |a_ij| guarantees convergence
    for any symmetric A (reference jacobi_l1_solver.cu)."""

    def _setup_impl(self, A):
        A = scalarized(A, "JACOBI_L1")
        indptr, cols, vals = A._host
        row_ids = _row_ids_np(indptr, A.n_rows)
        offdiag = np.zeros(A.n_rows, dtype=np.abs(vals).dtype)
        np.add.at(offdiag, row_ids, np.abs(vals) * (cols != row_ids))
        diag = _extract_diag_np(indptr, cols, vals, A.n_rows)
        d = np.abs(diag) + offdiag
        self._params = (
            A, to_tensor(reciprocal_np(d).astype(vals.dtype),
                         A.device).to(A.dtype)
        )

    def make_batch_params(self):
        """Batched views of the operator and each instance's L1
        diagonal: the |a_ij| of each row's off-diagonal entries summed
        in entry order (``segment_sum``, the order of the setup's
        ``np.add.at``) plus |a_ii|, inverted as :func:`reciprocal_np`.
        None for a block matrix (scalarized at setup: the values no
        longer map one to one onto the operator)."""
        from amgx_tpu_torch.ops.spmv import segment_sum

        A0 = self._params[0]
        if A0 is not self.A:
            return None

        def fn(t, v):
            A = t.replace_values_batched(v)
            off = (t.col_indices != t.row_ids).to(A.dtype)
            av = torch.abs(A.values) * off
            offd = segment_sum(av.T.contiguous(), t.row_offsets).T
            return A, invert_diag_batched(torch.abs(A.diag) + offd)

        return A0, fn
