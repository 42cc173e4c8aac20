"""Jacobi-Davidson eigensolver (reference
jacobi_davidson_eigensolver.cu; the JAX package's
``eigensolvers/jacobi_davidson.py``).

Symmetric JD for the extreme eigenpair: expand a search space V by
approximate solutions of the projected correction equation

    (I - u u^T)(A - theta I)(I - u u^T) t = -r,   t orthogonal to u

from a few CG steps; Rayleigh-Ritz on V gives the Ritz pair, and a
full space restarts from the best Ritz vector.  The correction CG keeps
its scalars on the device (``torch.where`` guards, as ``jnp.where``
does), so it makes no host read; V is a list of vectors, each product
with it one SpMV a vector.
"""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.eigensolvers.algorithms import apply_columns
from amgx_tpu_torch.eigensolvers.base import (
    EigenResult,
    EigenSolver,
    register_eigensolver,
)
from amgx_tpu_torch.ops.spmv import spmv


def _correction_cg(A, theta, u, r, iters=8):
    """The projected correction equation, approximately, by ``iters``
    CG steps from t = 0."""

    def proj(v):
        return v - torch.dot(u, v) * u

    def op(v):
        return proj(spmv(A, proj(v)) - theta * proj(v))

    t = torch.zeros_like(r)
    res = proj(-r)
    p = res
    rho = torch.dot(res, res)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    for _ in range(iters):
        q = op(p)
        pq = torch.dot(p, q)
        alpha = torch.where(pq != 0, rho / pq, zero)
        t = t + alpha * p
        res = res - alpha * q
        rho_new = torch.dot(res, res)
        beta = torch.where(rho != 0, rho_new / rho, zero)
        p = res + beta * p
        rho = rho_new
    return t


def _ritz(A, V):
    """(Vm, H) for the basis ``V`` (a list of vectors): Vm the (m, n)
    stack, H = Vm A Vm^T symmetrized on the host."""
    Vm = torch.stack(V)
    H = (Vm @ apply_columns(A, Vm.T)).cpu().numpy()
    return Vm, (H + H.T) / 2.0


@register_eigensolver("JACOBI_DAVIDSON")
class JacobiDavidsonEigenSolver(EigenSolver):
    def _solve_impl(self, x0=None) -> EigenResult:
        A = self.A
        n = A.n_rows
        dtype = self._np_dtype()
        m_max = max(self.subspace_size, 8)
        largest = self.which != "smallest"
        rng = np.random.default_rng(17)
        v = x0 if x0 is not None else rng.standard_normal(n).astype(dtype)
        v = np.asarray(v)
        V = [self._to_dev(v / np.linalg.norm(v))]
        res = np.inf
        it = 0
        for it in range(1, self.max_iters + 1):
            Vm, H = _ritz(A, V)
            evals, evecs = np.linalg.eigh(H)
            j = -1 if largest else 0
            theta = float(evals[j])
            u = Vm.T @ self._to_dev(np.ascontiguousarray(evecs[:, j]))
            u = u / torch.linalg.vector_norm(u)
            r = spmv(A, u) - theta * u
            res = float(torch.linalg.vector_norm(r)) / max(abs(theta), 1e-30)
            if res < self.tolerance:
                break
            if len(V) >= m_max:  # thick restart with the best Ritz vector
                V = [u]
            t = _correction_cg(A, theta, u, r)
            # t orthogonalized against the space
            Vm = torch.stack(V)
            t = t - Vm.T @ (Vm @ t)
            nrm = float(torch.linalg.vector_norm(t))
            if nrm < 1e-12:
                t = self._to_dev(rng.standard_normal(n).astype(dtype))
                t = t - Vm.T @ (Vm @ t)
                nrm = float(torch.linalg.vector_norm(t))
            V.append(t / nrm)
        # the k best Ritz pairs of the final space
        Vm, H = _ritz(A, V)
        evals, evecs = np.linalg.eigh(H)
        order = np.argsort(evals)[::-1] if largest else np.argsort(evals)
        k = min(max(self.wanted_count, 1), len(evals))
        lam = evals[order[:k]]
        X = Vm.T @ self._to_dev(np.ascontiguousarray(evecs[:, order[:k]]))
        return EigenResult(
            eigenvalues=lam, eigenvectors=X, iterations=it,
            converged=res < self.tolerance, residual=res,
        )
