"""Krylov solvers: PCG and CG (reference pcg_solver.cu, cg_solver.cu).

Each iteration is a function over (params, b, x, extra) with
``extra[0]`` the current residual; scalars (rho, alpha, beta) stay
0-dim tensors on the device, so an iteration syncs with the host only
where the monitored loop reads the residual norm.  The preconditioner
is the nested solver's ``make_apply`` over ``params[1]``.  NOSOLVER as
preconditioner disables preconditioning (reference
pcg_solver.cu:21-29).
"""

from __future__ import annotations

import torch

from amgx_tpu_torch.ops.blas import dot
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import (
    SolverRegistry,
    make_nested,
    register_solver,
)


def resolve_preconditioner(cfg, scope, device):
    """The preconditioner named in config, or None for NOSOLVER."""
    name, pscope = cfg.get_scoped("preconditioner", scope)
    if name == "NOSOLVER":
        return None
    return make_nested(SolverRegistry.get(name)(cfg, pscope, device=device))


class KrylovSolver(Solver):
    uses_preconditioner = True

    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.precond = (
            resolve_preconditioner(cfg, scope, self.device)
            if self.uses_preconditioner
            else None
        )

    def _setup_impl(self, A):
        if self.precond is not None:
            self.precond.setup(A)
            self._params = (A, self.precond.apply_params())
        else:
            self._params = (A, None)

    def _make_M(self):
        """fn(Mp, r) -> z; identity when unpreconditioned."""
        if self.precond is None:
            return lambda Mp, r: r
        return self.precond.make_apply()

    def _make_init(self):
        raise NotImplementedError

    def _make_iter(self):
        raise NotImplementedError

    def make_solve(self):
        init = self._make_init()
        iterate = self._make_iter()
        norm_of = self.make_norm()
        monitored = self.monitor_residual

        def solve(params, b, x0):
            extra0 = init(params, b, x0)
            if not monitored:
                x, extra = x0, extra0
                for _ in range(self.max_iters):
                    x, extra = iterate(params, b, x, extra)
                return self._fixed_result(x, b, self.max_iters)

            def body(x, extra):
                x, extra = iterate(params, b, x, extra)
                return x, extra, norm_of(extra[0])

            return self._monitored_loop(
                norm_of(extra0[0]), body, b, x0, extra0
            )

        return solve

    def make_apply(self):
        """Fixed-iteration zero-guess run (nested-solver usage)."""
        init = self._make_init()
        iterate = self._make_iter()
        iters = max(self.max_iters, 1)

        def apply(params, r):
            x = torch.zeros_like(r)
            extra = init(params, r, x)
            for _ in range(iters):
                x, extra = iterate(params, r, x, extra)
            return x

        return apply

    def make_smooth(self):
        init = self._make_init()
        iterate = self._make_iter()

        def smooth(params, b, x, sweeps):
            extra = init(params, b, x)
            for _ in range(sweeps):
                x, extra = iterate(params, b, x, extra)
            return x

        return smooth


@register_solver("PCG")
class PCGSolver(KrylovSolver):
    """Preconditioned conjugate gradient (reference pcg_solver.cu)."""

    def _make_init(self):
        M = self._make_M()

        def init(params, b, x):
            A, Mp = params
            r = b - spmv(A, x)
            z = M(Mp, r)
            return (r, z, dot(r, z))

        return init

    def _make_iter(self):
        M = self._make_M()

        def iterate(params, b, x, extra):
            A, Mp = params
            r, p, rho = extra
            q = spmv(A, p)
            pq = dot(p, q)
            zero = torch.zeros((), dtype=pq.dtype, device=pq.device)
            # exact breakdown (converged mid fixed-iteration run) must
            # be a no-op, not 0/0 = NaN
            alpha = torch.where(pq != 0, rho / pq, zero)
            x = x + alpha * p
            r = r - alpha * q
            z = M(Mp, r)
            rho_new = dot(r, z)
            beta = torch.where(rho != 0, rho_new / rho, zero)
            p = z + beta * p
            return x, (r, p, rho_new)

        return iterate


@register_solver("CG")
class CGSolver(PCGSolver):
    """Unpreconditioned CG (reference cg_solver.cu)."""

    uses_preconditioner = False
