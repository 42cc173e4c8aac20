"""Multicolor Kaczmarz row-projection smoother (reference
kaczmarz_solver.cu; the JAX package's ``solvers/kaczmarz.py``).

Update for row i: x += a_i^T (b_i - a_i x) / ||a_i||^2, one colour at a
time so that the rows of a colour update together:
delta_c = mask_c * r / rownorm2;  x += omega * A^T delta_c.
A^T is uploaded at setup as a matrix of its own, so it takes the same
formats (and kernels) as A: the transpose of a DIA operator is DIA.  A
sweep is 2 x colours SpMVs.
"""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.core.matrix import SparseMatrix, to_tensor
from amgx_tpu_torch.ops.coloring import color_matrix
from amgx_tpu_torch.ops.diagonal import scalarized
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import register_solver


@register_solver("KACZMARZ")
class KaczmarzSolver(Solver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.scheme = str(cfg.get("matrix_coloring_scheme", scope))
        self.deterministic = bool(cfg.get("determinism_flag", scope))
        self.coloring_needed = bool(
            cfg.get("kaczmarz_coloring_needed", scope)
        )

    def _setup_impl(self, A):
        A = scalarized(A, self.registry_name)
        sp = A.host_csr()
        At = SparseMatrix.from_scipy(sp.T.tocsr().astype(sp.dtype),
                                     device=A.device)
        rownorm2 = np.asarray(sp.multiply(sp).sum(axis=1)).ravel()
        rownorm2 = np.where(rownorm2 > 0, rownorm2, 1.0)
        if self.coloring_needed:
            colors = color_matrix(A, self.scheme, self.deterministic,
                                  cfg=self.cfg, scope=self.scope)
        else:
            colors = np.zeros(A.n_rows, dtype=np.int32)
        self.num_colors = int(colors.max()) + 1
        self._params = (A, At, to_tensor(1.0 / rownorm2, A.device),
                        to_tensor(colors, A.device))

    def make_step(self):
        omega = self.relaxation_factor
        ncol = self.num_colors

        def step(params, b, x):
            A, At, inv_rn2, colors = params
            for c in range(ncol):
                r = b - spmv(A, x)
                delta = torch.where(colors == c, r * inv_rn2,
                                    torch.zeros((), dtype=r.dtype,
                                                device=r.device))
                x = x + omega * spmv(At, delta)
            return x

        return step
