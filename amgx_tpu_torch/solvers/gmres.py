"""GMRES / FGMRES with restarts (reference gmres_solver.cu,
fgmres_solver.cu; the JAX package's ``solvers/gmres.py``).

Structure: restart cycles of Arnoldi with modified Gram-Schmidt and
Givens rotations.  The vectors (the basis V, FGMRES's preconditioned
vectors Z) and the MGS dots and updates stay on the device, the dots
as 0-dim tensors.  The Hessenberg matrix H, the rotated right-hand
side g and the rotations (cs, sn) are a few dozen scalars: they live
on the host in the solve's dtype, as the reference keeps its Givens
step on the host (fgmres_solver.cu:233-250).  Each Arnoldi step reads
its new Hessenberg column back in one copy, and that read is also the
step's convergence check: the monitored norm is the implicit residual
|g[j+1]|, not a true residual.  The j x j triangular system of each
restart is solved on the host.

GMRES is left-preconditioned (Krylov space of M A, residual M(b - A x));
FGMRES is flexible right-preconditioned, storing the preconditioned
vectors Z_j so the preconditioner may change between iterations.
Complex dtypes use conjugated MGS projections and the unitary Givens
scheme; real dtypes recover the classical formulas exactly.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.base import (
    DIVERGED,
    FAILED,
    NOT_CONVERGED,
    SUCCESS,
    SolveResult,
    _real_np_dtype,
    host_norm,
)
from amgx_tpu_torch.solvers.krylov import KrylovSolver
from amgx_tpu_torch.solvers.registry import register_solver


def _np_dtype(t):
    return np.dtype(str(t.dtype).replace("torch.", ""))


def dot(x, y):
    """<x, y>, conjugated on x: the products of the Arnoldi process,
    which (as in the JAX package) are not ``ops/blas`` reduction or
    ``dot_breakdown`` sites."""
    return torch.vdot(x, y) if x.is_complex() else torch.dot(x, y)


def _vec_norm(v):
    """sqrt(real <v, v>) as a 0-dim real tensor on the device."""
    return torch.sqrt(dot(v, v).real)


@register_solver("FGMRES")
class FGMRESSolver(KrylovSolver):
    flexible = True

    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.restart = int(cfg.get("gmres_n_restart", scope))
        # reference fgmres_solver.cu:235-241: gmres_krylov_dim > 0 caps
        # the Krylov basis below the restart length
        kdim = int(cfg.get("gmres_krylov_dim", scope))
        if kdim > 0:
            self.restart = min(self.restart, kdim)

    def make_solve(self):
        return self._build_solve(self.max_iters, self.monitor_residual)

    def _build_solve(self, max_iters, monitored):
        M = self._make_M()
        m = self.restart
        flexible = self.flexible
        conv_check = self._conv_check if monitored else (lambda *a: False)
        rel_div = self.rel_div_tolerance

        def status_of(nrm, ini, mx):
            status = SUCCESS if conv_check(nrm, ini, mx) else NOT_CONVERGED
            if rel_div > 0 and np.any(nrm > rel_div * ini):
                status = DIVERGED
            if not np.all(np.isfinite(nrm)):
                status = FAILED
            return status

        def solve(params, b, x0):
            A, Mp = params
            n = b.shape[0]
            dt, rdt = _np_dtype(b), _real_np_dtype(b)

            def precond_resid(x):
                r = b - spmv(A, x)
                return r if flexible else M(Mp, r)

            hist = np.full((max_iters + 1, 1), np.nan, rdt)
            r = precond_resid(x0)
            beta_t = _vec_norm(r)
            nrm0 = host_norm(beta_t).astype(rdt, copy=False)
            hist[0] = nrm0
            status = (
                SUCCESS if conv_check(nrm0, nrm0, nrm0) else NOT_CONVERGED
            )
            x, it, mx, beta = x0, 0, nrm0, nrm0[0]
            one = torch.ones((), dtype=beta_t.dtype, device=b.device)
            V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
            Z = torch.zeros((m, n), dtype=b.dtype, device=b.device) \
                if flexible else None
            restarts = faults.loop()
            while status == NOT_CONVERGED and it < max_iters:
                with restarts:
                    if it > 0:
                        # a restart: the first cycle reuses r0 and its norm
                        r = precond_resid(x)
                        beta_t = _vec_norm(r)
                        beta = host_norm(beta_t)[0]
                    V[0] = r / torch.where(beta_t > 0, beta_t, one)
                    H = np.zeros((m + 1, m), dt)
                    g = np.zeros(m + 1, dt)
                    g[0] = beta
                    cs = np.ones(m, dt)
                    sn = np.zeros(m, dt)
                    j = 0
                    arnoldi = faults.loop()
                    while j < m and status == NOT_CONVERGED and it < max_iters:
                        with arnoldi:
                            if flexible:
                                z = M(Mp, V[j])
                                Z[j] = z
                                w = spmv(A, z)
                            else:
                                w = M(Mp, spmv(A, V[j]))
                            # modified Gram-Schmidt over i <= j; the dots
                            # stay on the device (conjugated projection for
                            # complex)
                            hs = []
                            for i in range(j + 1):
                                h = dot(V[i], w)
                                w = w - h * V[i]
                                hs.append(h)
                            hlast = _vec_norm(w)
                            V[j + 1] = w / torch.where(hlast > 0, hlast, one)
                            # the step's one read: the new Hessenberg column
                            hcol = np.zeros(m + 1, dt)
                            hcol[: j + 2] = torch.stack(
                                hs + [hlast.to(w.dtype)]
                            ).cpu().numpy()
                            # apply the existing Givens rotations, unitary form
                            # [[c, s], [-conj(s), conj(c)]]
                            for i in range(j):
                                t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                                u = (-np.conj(sn[i]) * hcol[i]
                                     + np.conj(cs[i]) * hcol[i + 1])
                                hcol[i], hcol[i + 1] = t, u
                            hj, hj1 = hcol[j], hcol[j + 1]
                            denom = np.sqrt(
                                np.real(hj * np.conj(hj))
                                + np.real(hj1 * np.conj(hj1))
                            )
                            if not denom > 0:
                                denom = rdt.type(1)
                            # G = [[conj(hj), conj(hj1)], [-hj1, hj]] / denom
                            # maps (hj, hj1) -> (denom, 0)
                            cs[j] = np.conj(hj) / denom
                            sn[j] = np.conj(hj1) / denom
                            hcol[j], hcol[j + 1] = denom, 0
                            gj = g[j]
                            g[j] = cs[j] * gj
                            g[j + 1] = -np.conj(sn[j]) * gj
                            H[:, j] = hcol
                            # the implicit residual |g[j+1]|
                            nrm = np.abs(g[j + 1 : j + 2]).astype(
                                rdt, copy=False)
                            j += 1
                            it += 1
                            hist[it] = nrm
                            mx = np.maximum(mx, nrm)
                            status = status_of(nrm, nrm0, mx)
                    # the j x j upper-triangular system of this cycle
                    y = scipy.linalg.solve_triangular(
                        H[:j, :j], g[:j], lower=False, check_finite=False
                    ).astype(dt, copy=False)
                    basis = Z if flexible else V
                    x = x + torch.matmul(
                        torch.from_numpy(y).to(b.device), basis[:j]
                    )
            if not monitored:
                status = SUCCESS
            return SolveResult(
                x=x, iters=it, status=status,
                final_norm=hist[min(it, max_iters)], initial_norm=nrm0,
                history=hist,
            )

        return solve

    def make_apply(self):
        """Nested-solver usage: fixed max_iters iterations, unmonitored."""
        solve = self._build_solve(max(self.max_iters, 1), monitored=False)

        def apply(params, r):
            return solve(params, r, torch.zeros_like(r)).x

        return apply

    def make_smooth(self):
        """sweeps GMRES iterations (restarting as needed), unmonitored —
        honors the base contract fn(params, b, x, sweeps)."""
        cache = {}

        def smooth(params, b, x, sweeps):
            if sweeps not in cache:
                cache[sweeps] = self._build_solve(sweeps, monitored=False)
            return cache[sweeps](params, b, x).x

        return smooth


@register_solver("GMRES")
class GMRESSolver(FGMRESSolver):
    flexible = False
