"""CF-Jacobi smoother (reference cf_jacobi_solver.cu; the JAX package's
``solvers/cf_jacobi.py``): Jacobi sweeps ordered by a coarse/fine
splitting, per ``cf_smoothing_mode``: 0 C points then F points, 1 F
then C.

As in the JAX package, the smoother computes its own splitting at setup
(PMIS on AHAT strength with the ``strength_threshold`` and
``max_row_sum`` of its own scope), from the port's ``amg/classical.py``.
A sweep is two masked half-sweeps on the device, one SpMV each.
"""

from __future__ import annotations

import torch

from amgx_tpu_torch.amg.classical import pmis_select, strength_ahat
from amgx_tpu_torch.ops.diagonal import invert_diag, scalarized
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import register_solver


@register_solver("CF_JACOBI")
class CFJacobiSolver(Solver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.mode = int(cfg.get("cf_smoothing_mode", scope))
        self.theta = float(cfg.get("strength_threshold", scope))
        self.max_row_sum = float(cfg.get("max_row_sum", scope))

    def _setup_impl(self, A):
        A = scalarized(A, self.registry_name)
        S = strength_ahat(A.host_csr(), self.theta, self.max_row_sum)
        is_c = torch.from_numpy(pmis_select(S) == 1).to(A.device)
        self._params = (A, invert_diag(A), is_c)

    def make_step(self):
        omega = self.relaxation_factor
        first_coarse = self.mode == 0

        def half_sweep(params, b, x, mask):
            A, dinv, _ = params
            r = b - spmv(A, x)
            return torch.where(mask, x + omega * dinv * r, x)

        def step(params, b, x):
            _, _, is_c = params
            m1, m2 = (is_c, ~is_c) if first_coarse else (~is_c, is_c)
            x = half_sweep(params, b, x, m1)
            return half_sweep(params, b, x, m2)

        return step
