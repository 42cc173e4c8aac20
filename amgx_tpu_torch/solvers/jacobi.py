"""Block-Jacobi smoother for scalar matrices (reference
block_jacobi_solver.cu, the default smoother): x += omega * D^-1 (b - A x).
Each sweep is one SpMV and an elementwise update."""

from __future__ import annotations

from amgx_tpu_torch.ops.diagonal import apply_dinv, invert_diag, scalarized
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import register_solver


@register_solver("BLOCK_JACOBI")
class BlockJacobiSolver(Solver):
    """x += omega * D^{-1} (b - A x); D = diagonal."""

    def _setup_impl(self, A):
        A = scalarized(A, "BLOCK_JACOBI")
        self._params = (A, invert_diag(A))

    def make_residual_step(self):
        omega = self.relaxation_factor

        def rstep(params, b, x, r):
            _, dinv = params
            return x + omega * apply_dinv(dinv, r)

        return rstep

    def make_apply(self):
        # zero-guess first sweep simplifies to omega*Dinv b; later
        # sweeps are full steps (reference smooth_with_0_initial_guess)
        step = self.make_step()
        omega = self.relaxation_factor
        iters = max(self.max_iters, 1)

        def apply(params, r):
            _, dinv = params
            z = omega * apply_dinv(dinv, r)
            for _ in range(iters - 1):
                z = step(params, r, z)
            return z

        return apply
