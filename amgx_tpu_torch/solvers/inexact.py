"""Inexact coarse solver (the JAX package's ``solvers/inexact.py``).

``coarse_solver=INEXACT`` replaces the dense factorization of the
coarsest level by a fixed-sweep run of ``inexact_coarse_solver``
(default OPT_POLYNOMIAL; SSTEP_PCG for a Krylov coarse solve).  The
sweep budget grows with the cycle depth and is capped by
``max_coarse_iters``:

    sweeps = min(max_coarse_iters, 4 + 2 * cycle_depth)

(the AMG setup sets ``cycle_depth`` to the level count before the
coarse solver's setup).  The class delegates everything to the inner
solver, its resetup included.
"""

from __future__ import annotations

from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.krylov import KrylovSolver
from amgx_tpu_torch.solvers.registry import (
    SolverRegistry,
    make_nested,
    register_solver,
)


@register_solver("INEXACT")
class InexactCoarseSolver(Solver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        method, mscope = cfg.get_scoped("inexact_coarse_solver", scope)
        self.method = str(method).upper()
        self.inner = make_nested(
            SolverRegistry.get(self.method)(cfg, mscope, device=self.device)
        )
        # A Krylov inner keeps a preconditioner only when its own,
        # dedicated scope sets one: one inherited from the default or
        # the outer scope (the flat-config layout, where
        # "preconditioner" names the outer solver's AMG) would build
        # hierarchies on the coarsest level without bound
        explicit_precond = (
            mscope not in (scope, "default")
            and (mscope, "preconditioner") in cfg.items()
        )
        if (
            isinstance(self.inner, KrylovSolver)
            and self.inner.precond is not None
            and not explicit_precond
        ):
            self.inner.precond = None
        self.max_coarse_iters = max(
            int(cfg.get("max_coarse_iters", scope)), 1
        )
        # the hierarchy depth the budget is linked to; the AMG setup
        # sets it before the coarse solver's setup
        self.cycle_depth = 1

    def sweep_budget(self) -> int:
        """CG steps or sweeps of one coarse solve."""
        return min(self.max_coarse_iters, 4 + 2 * max(self.cycle_depth, 1))

    def _setup_impl(self, A):
        # max_iters counts inner steps for every solver family (SSTEP_PCG
        # counts outers of iterations_scale steps: round up to whole
        # outers)
        scale = max(int(self.inner.iterations_scale), 1)
        self.inner.max_iters = max(-(-self.sweep_budget() // scale), 1)
        self.inner.setup(A)
        self._params = self.inner.apply_params()

    def _resetup_impl(self, A) -> bool:
        self.inner.resetup(A)
        self._params = self.inner.apply_params()
        return True

    def operator_of(self, params):
        return self.inner.operator_of(params)

    def make_apply(self):
        return self.inner.make_apply()

    def make_smooth(self):
        return self.inner.make_smooth()

    def make_step(self):
        return self.inner.make_step()

    def make_residual_step(self):
        return self.inner.make_residual_step()

    def make_solve(self):
        return self.inner.make_solve()
