"""Operators (reference include/operators/operator.h:14-57; the JAX
package's ``core/operator.py``): what solvers and eigensolvers apply.

  MatrixOperator   wraps a SparseMatrix: apply = SpMV;
  ShiftedOperator  A - sigma I without forming the shifted matrix
                   (reference shifted_operator.h);
  SolveOperator    apply = an inner solver's zero-guess run, an
                   approximate inverse (reference solve_operator.h:15-38).

Each has ``apply(x)`` on a tensor (or a numpy array, taken to the
operator's device) and ``as_fn()`` returning ``(params, fn)`` with
``fn(params, x) -> y``, as a solver's ``make_apply`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.ops.spmv import spmv


def _on(device, x):
    """``x`` as a tensor on ``device`` (numpy arrays are copied there)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class Operator:
    shape = (0, 0)

    def apply(self, x):
        raise NotImplementedError

    def as_fn(self):
        """``(params, fn)`` with ``fn(params, x) -> y``."""
        raise NotImplementedError


class MatrixOperator(Operator):
    def __init__(self, A):
        self.A = A
        self.shape = A.shape

    def apply(self, x):
        return spmv(self.A, _on(self.A.device, x))

    def as_fn(self):
        return self.A, lambda A, x: spmv(A, x)


class ShiftedOperator(Operator):
    """(A - sigma I) x without forming the shifted matrix."""

    def __init__(self, A, sigma: float):
        self.A = A
        self.sigma = float(sigma)
        self.shape = A.shape

    def apply(self, x):
        x = _on(self.A.device, x)
        return spmv(self.A, x) - self.sigma * x

    def as_fn(self):
        sigma = self.sigma
        return self.A, lambda A, x: spmv(A, x) - sigma * x


class SolveOperator(Operator):
    """apply(x) = (approximately) A^{-1} x by an inner solver's
    zero-guess run (its ``make_apply``)."""

    def __init__(self, solver):
        self.solver = solver
        A = solver.A
        self.shape = A.shape if A is not None else (0, 0)

    def apply(self, x):
        return self.solver.make_apply()(self.solver.apply_params(),
                                        _on(self.solver.device, x))

    def as_fn(self):
        return self.solver.apply_params(), self.solver.make_apply()
