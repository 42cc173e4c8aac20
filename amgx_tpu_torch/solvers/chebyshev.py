"""Chebyshev iteration (reference cheb_solver.cu, chebyshev_poly.cu; the
JAX package's ``solvers/chebyshev.py``).

One step applies an order-k Chebyshev polynomial in the preconditioned
operator M^{-1}A over the eigenvalue interval [lmin, lmax], k SpMVs a
step.  The preconditioner is the nested 'preconditioner' solver when
configured (JACOBI_L1 in AmgX's AMG_CLASSICAL_AGGRESSIVE_CHEB_L1_TRUNC),
otherwise plain Jacobi D^{-1}.

Interval: ``chebyshev_lambda_estimate_mode`` 3 takes the user's
``cheby_max_lambda`` / ``cheby_min_lambda``; the other modes estimate
lmax by 20 steps of power iteration on M^{-1}A at setup, from the JAX
package's start vector (``default_rng(0)`` in the real dtype), and take
lmax = 1.1 x the estimate, lmin = ``cheby_min_lambda`` x lmax.  The 20
steps run on the device and the estimate is read once, after the last.

Spectral-bound cache (the JAX package's): a values-only ``resetup``
keeps the cached lmax / lmin and rebuilds only the preconditioner state,
counting the resetups served off the cache in ``bound_staleness``; the
``reestimate_eigs`` knob re-runs the power iteration every Nth resetup
(0: never).  AMG resetups its surviving level smoothers, so the cache
rides a hierarchy's values-only resetup too.  Not ported (ROADMAP.md,
queue A6/A7): export/import and the batched rebuild.
"""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.core.matrix import to_tensor
from amgx_tpu_torch.ops.diagonal import invert_diag, scalarized
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import register_solver

# power-iteration steps of the lmax estimate
POWER_STEPS = 20


@register_solver("CHEBYSHEV")
class ChebyshevSolver(Solver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.order = int(cfg.get("chebyshev_polynomial_order", scope))
        self.lambda_mode = int(
            cfg.get("chebyshev_lambda_estimate_mode", scope)
        )
        self.user_max = float(cfg.get("cheby_max_lambda", scope))
        self.user_min = float(cfg.get("cheby_min_lambda", scope))
        # resetups served off the cached window since the last power
        # iteration, and the knob forcing one every Nth (0: never)
        self.reestimate_eigs = int(cfg.get("reestimate_eigs", scope))
        self.bound_staleness = 0
        self._resetups_since_estimate = 0
        from amgx_tpu_torch.solvers.krylov import resolve_preconditioner

        # NOSOLVER (or nothing configured in scope) -> Jacobi default
        name, _ = cfg.get_scoped("preconditioner", scope)
        self.precond = (
            resolve_preconditioner(cfg, scope, self.device)
            if cfg.has("preconditioner", scope) and name != "NOSOLVER"
            else None
        )

    def _make_M(self):
        if self.precond is None:
            return lambda Mp, r: Mp * r  # Mp is dinv
        return self.precond.make_apply()

    def _setup_impl(self, A):
        if self.precond is not None:
            self.precond.setup(A)
            Mp = self.precond.apply_params()
        else:
            A = scalarized(A, self.registry_name)
            Mp = invert_diag(A)
        # reference cheb_solver.cu:153-216: mode 3 takes the user's
        # cheby_max/min_lambda verbatim; the other modes estimate lmax
        if self.lambda_mode == 3:
            lmax, lmin = self.user_max, self.user_min
        else:
            lmax = 1.1 * self._estimate_lambda_max(A, self._make_M(), Mp)
            lmin = self.user_min * lmax  # ratio semantics, default 0.125
        self.lmax, self.lmin = float(lmax), float(lmin)
        self.bound_staleness = 0
        self._resetups_since_estimate = 0
        self._params = (A, Mp)

    def _resetup_impl(self, A):
        """Values-only refresh with the cached spectral window: the
        preconditioner state is rebuilt, the power iteration re-runs
        only on the ``reestimate_eigs`` cadence."""
        if self.precond is not None:
            self.precond.resetup(A)
            Mp = self.precond.apply_params()
        else:
            A = scalarized(A, self.registry_name)
            A0 = self._params[0]
            if A.n_rows != A0.n_rows or A.nnz != A0.nnz:
                return False
            Mp = invert_diag(A)
        if self.lambda_mode != 3:
            self._resetups_since_estimate += 1
            if (
                self.reestimate_eigs > 0
                and self._resetups_since_estimate >= self.reestimate_eigs
            ):
                lmax = 1.1 * self._estimate_lambda_max(A, self._make_M(), Mp)
                self.lmax = float(lmax)
                self.lmin = float(self.user_min * lmax)
                self.bound_staleness = 0
                self._resetups_since_estimate = 0
            else:
                self.bound_staleness += 1
        self._params = (A, Mp)
        return True

    def _estimate_lambda_max(self, A, M, Mp, iters=POWER_STEPS, seed=0):
        """Power iteration on M^{-1}A: ``iters`` steps on the device,
        one read of the last norm."""
        rng = np.random.default_rng(seed)
        rdt = np.zeros((), str(A.dtype).replace("torch.", "")).real.dtype
        v = to_tensor(rng.standard_normal(A.n_rows).astype(rdt),
                      A.device).to(A.dtype)
        lam = None
        for _ in range(iters):
            w = M(Mp, spmv(A, v))
            lam = torch.linalg.vector_norm(w)
            v = w / torch.clamp(lam, min=1e-30)
        return max(float(lam) if lam is not None else 1.0, 1e-12)

    def make_step(self):
        k = max(self.order, 1)
        theta = (self.lmax + self.lmin) / 2.0
        delta = max((self.lmax - self.lmin) / 2.0, 1e-30)
        sigma = theta / delta
        M = self._make_M()

        def step(params, b, x):
            A, Mp = params
            rho_old = 1.0 / sigma
            r = b - spmv(A, x)
            d = M(Mp, r) / theta
            x = x + d
            for _ in range(k - 1):
                rho = 1.0 / (2.0 * sigma - rho_old)
                r = b - spmv(A, x)
                d = rho * rho_old * d + (2.0 * rho / delta) * M(Mp, r)
                x = x + d
                rho_old = rho
            return x

        return step


@register_solver("CHEBYSHEV_POLY")
class ChebyshevPolySolver(ChebyshevSolver):
    """Polynomial-smoother registration alias (reference
    chebyshev_poly.cu)."""
