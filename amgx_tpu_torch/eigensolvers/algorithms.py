"""Eigensolver algorithms (reference single_iteration_eigensolver.cu,
subspace_iteration_eigensolver.cu, lanczos_eigensolver.cu,
arnoldi_eigensolver.cu, lobpcg_eigensolver.cu; the JAX package's
``eigensolvers/algorithms.py``).

The products, QR and projections run on the solver's device; the small
dense eigenproblems (tridiagonal, Hessenberg, Ritz) on the host, the
split the reference makes with its LAPACK bridge.  Start vectors and
bases are the JAX package's numpy draws (``default_rng(7 / 11 / 13)``),
moved to the device.  The host reads are the JAX package's, less the
ones it makes to hand a vector between steps: a power step reads only
on its check iterations, inverse iteration reads the Rayleigh quotient
once an outer iteration (v stays on the device between inner solves),
Lanczos reads beta once a step (alpha stays on the device until the
Ritz problem), Arnoldi reads each entry of H.  Where the JAX package
maps ``spmv`` over the columns of a block (SUBSPACE_ITERATION, LOBPCG),
each column is one SpMV here, one kernel launch on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.eigensolvers.base import (
    EigenResult,
    EigenSolver,
    host_vector,
    register_eigensolver,
)
from amgx_tpu_torch.ops.spmv import spmv


def apply_columns(A, V):
    """A V for an (n, m) block: one SpMV a column."""
    return torch.stack(
        [spmv(A, V[:, j].contiguous()) for j in range(V.shape[1])], dim=1
    )


@register_eigensolver("POWER_ITERATION", "SINGLE_ITERATION", "PAGERANK",
                      "INVERSE_ITERATION")
class SingleIterationEigenSolver(EigenSolver):
    """The power-iteration family (reference
    single_iteration_eigensolver.cu):
      * which=largest: power iteration on A (- shift I);
      * which=smallest / INVERSE_ITERATION: inverse iteration by an inner
        linear solver (the 'solver' parameter's scope), on A - shift I
        when ``eig_shift`` is set (shift-invert);
      * PAGERANK: power iteration on the damped column-stochastic Google
        matrix d P + (1 - d) t 1^T (reference pagerank_operator.h), with
        dangling columns' mass sent along the teleport vector t (the
        uniform one, or ``personalization`` normalized).
    """

    def _setup_impl(self, A):
        if self.requested_name == "PAGERANK":
            self.which = "pagerank"
        self._inner = None
        self.check_freq = max(
            int(self.cfg.get("eig_convergence_check_freq", self.scope)), 1
        )
        if (
            self.which == "smallest"
            or self.requested_name == "INVERSE_ITERATION"
        ):
            from amgx_tpu_torch.core.matrix import SparseMatrix
            from amgx_tpu_torch.solvers.registry import (
                create_solver,
                make_nested,
            )

            solve_A = A
            if self.shift != 0.0:
                # shift-invert: iterate on (A - sigma I)^{-1}, the
                # shifted matrix formed on the host as the JAX package
                # forms it (reference ShiftedOperator)
                import scipy.sparse as sps

                sp = A.to_scipy()
                solve_A = SparseMatrix.from_scipy(
                    (sp - self.shift * sps.eye_array(sp.shape[0])).tocsr(),
                    device=self.device,
                )
            self._inner = make_nested(
                create_solver(self.cfg, self.scope, device=self.device))
            self._inner.setup(solve_A)
        if self.which == "pagerank":
            import scipy.sparse as sps

            from amgx_tpu_torch.core.matrix import SparseMatrix

            # column-normalized |A| is the link matrix; a column with no
            # out-links is dangling
            sp = A.to_scipy()
            colsum = np.asarray(np.abs(sp).sum(axis=0)).ravel()
            self._dangling = self._to_dev((colsum == 0).astype(np.float64))
            colsum = np.where(colsum > 0, colsum, 1.0)
            self._google = SparseMatrix.from_scipy(
                (abs(sp) @ sps.diags_array(1.0 / colsum)).tocsr(),
                device=self.device,
            )
            pers = getattr(self, "personalization", None)
            if pers is not None:
                pers = np.abs(np.asarray(pers, dtype=np.float64))
                tot = pers.sum()
                self._teleport = self._to_dev(
                    pers / (tot if tot > 0 else 1.0))
            else:
                self._teleport = torch.full(
                    (A.n_rows,), 1.0 / A.n_rows, dtype=torch.float64,
                    device=self.device)

    def _start(self, x0):
        n = self.A.n_rows
        return self._to_dev(
            x0 if x0 is not None else host_vector(n, self._np_dtype(), 7))

    def _solve_impl(self, x0=None) -> EigenResult:
        if self.which == "pagerank":
            return self._pagerank()
        if self._inner is not None:
            return self._inverse(self._start(x0))
        return self._power(self._start(x0))

    def _pagerank(self) -> EigenResult:
        G = self._google
        d = self.damping
        dt = G.dtype
        dang = self._dangling.to(dt)
        tele = self._teleport.to(dt)
        # the Perron vector from the teleport distribution
        v = tele
        res = np.inf
        it = 0
        for it in range(1, self.max_iters + 1):
            dangling_mass = torch.dot(dang, v)
            w = d * (spmv(G, v) + dangling_mass * tele) + (
                1.0 - d) * torch.sum(v) * tele
            w = w / torch.sum(torch.abs(w))
            if it % self.check_freq == 0:
                res = float(torch.max(torch.abs(w - v)))
                if res < self.tolerance:
                    v = w
                    break
            v = w
        return EigenResult(
            eigenvalues=np.array([1.0]), eigenvectors=v[:, None],
            iterations=it, converged=res < self.tolerance, residual=res,
        )

    def _inverse(self, v) -> EigenResult:
        """v <- normalize(A^{-1} v), lambda the Rayleigh quotient on A."""
        A = self.A
        lam = 0.0
        res = np.inf
        it = 0
        for it in range(1, self.max_iters + 1):
            w = self._inner.solve(v).x
            w = w / torch.linalg.vector_norm(w)
            lam_new = float(torch.dot(w, spmv(A, w)))
            res = abs(lam_new - lam)
            lam = lam_new
            v = w
            if res < self.tolerance * max(abs(lam), 1.0):
                break
        return EigenResult(
            eigenvalues=np.array([lam]), eigenvectors=v[:, None],
            iterations=it,
            converged=res < self.tolerance * max(abs(lam), 1.0),
            residual=res,
        )

    def _power(self, v) -> EigenResult:
        A = self.A
        shift = self.shift
        lam = 0.0
        res = np.inf
        it = 0
        for it in range(1, self.max_iters + 1):
            w = spmv(A, v)
            if shift != 0.0:
                w = w - shift * v
            lam_t = torch.dot(v, w)
            rnorm_t = torch.linalg.vector_norm(w - lam_t * v)
            v = w / torch.linalg.vector_norm(w)
            if it % self.check_freq == 0 or it == self.max_iters:
                lam = float(lam_t)
                res = float(rnorm_t) / max(abs(lam), 1e-30)
                if res < self.tolerance:
                    break
        return EigenResult(
            eigenvalues=np.array([lam + shift]), eigenvectors=v[:, None],
            iterations=it, converged=res < self.tolerance, residual=res,
        )


def _order(evals, largest):
    return np.argsort(evals)[::-1] if largest else np.argsort(evals)


@register_eigensolver("SUBSPACE_ITERATION")
class SubspaceIterationEigenSolver(EigenSolver):
    """Block power iteration with QR and Rayleigh-Ritz (reference
    subspace_iteration_eigensolver.cu)."""

    def _solve_impl(self, x0=None) -> EigenResult:
        A = self.A
        n = A.n_rows
        k = max(self.wanted_count, 1)
        m = max(self.subspace_size, k + 2)
        rng = np.random.default_rng(11)
        V = self._to_dev(rng.standard_normal((n, m)).astype(self._np_dtype()))
        V, _ = torch.linalg.qr(V)
        largest = self.which == "largest"
        res = np.inf
        lam = np.zeros(k)
        evecs = order = None
        it = 0
        for it in range(1, self.max_iters + 1):
            Q, _ = torch.linalg.qr(apply_columns(A, V))
            H = (Q.T @ apply_columns(A, Q)).cpu().numpy()
            V = Q
            evals, evecs = np.linalg.eigh((H + H.T) / 2.0)
            order = _order(evals, largest)
            lam = evals[order[:k]]
            # residual of the leading Ritz pair (eigenvalue-change
            # criteria converge prematurely)
            x1 = V @ self._to_dev(np.ascontiguousarray(evecs[:, order[0]]))
            rvec = spmv(A, x1) - lam[0] * x1
            res = float(torch.linalg.vector_norm(rvec)) / max(
                abs(lam[0]), 1e-30)
            if res < self.tolerance:
                break
        X = V @ self._to_dev(np.ascontiguousarray(evecs[:, order[:k]]))
        return EigenResult(
            eigenvalues=lam, eigenvectors=X, iterations=it,
            converged=res < self.tolerance, residual=res,
        )


@register_eigensolver("LANCZOS")
class LanczosEigenSolver(EigenSolver):
    """Symmetric Lanczos with full reorthogonalization (reference
    lanczos_eigensolver.cu); the tridiagonal Ritz problem on the host.
    The basis is one (m + 1, n) tensor filled row by row."""

    def _solve_impl(self, x0=None) -> EigenResult:
        import scipy.linalg as sla

        A = self.A
        n = A.n_rows
        m = min(self._krylov_dim(), n)
        v = self._to_dev(
            x0 if x0 is not None else host_vector(n, self._np_dtype(), 7))
        V = torch.empty((m + 1, n), dtype=v.dtype, device=self.device)
        V[0] = v
        alphas, betas = [], []
        beta = 0.0
        j = 0
        for j in range(m):
            w = spmv(A, V[j])
            if j > 0:
                w = w - beta * V[j - 1]
            alpha = torch.dot(V[j], w)
            w = w - alpha * V[j]
            # full reorthogonalization against the basis so far
            Vm = V[:j + 1]
            w = w - Vm.T @ (Vm @ w)
            beta = float(torch.linalg.vector_norm(w))
            alphas.append(alpha)
            if beta < 1e-14:
                break
            betas.append(beta)
            V[j + 1] = w / beta
        alphas = torch.stack(alphas).cpu().numpy()
        m_used = len(alphas)
        T_evals, T_evecs = sla.eigh_tridiagonal(
            alphas, np.array(betas[: m_used - 1]))
        k = max(self.wanted_count, 1)
        order = _order(T_evals, self.which == "largest")
        lam = T_evals[order[:k]]
        X = V[:m_used].T @ self._to_dev(
            np.ascontiguousarray(T_evecs[:, order[:k]]))
        # residual of the leading pair
        x1 = X[:, 0] / torch.linalg.vector_norm(X[:, 0])
        r = spmv(A, x1.contiguous()) - lam[0] * x1
        res = float(torch.linalg.vector_norm(r)) / max(abs(lam[0]), 1e-30)
        return EigenResult(
            eigenvalues=lam, eigenvectors=X, iterations=m_used,
            converged=res < self.tolerance, residual=res,
        )


@register_eigensolver("ARNOLDI")
class ArnoldiEigenSolver(EigenSolver):
    """Arnoldi for nonsymmetric spectra (reference
    arnoldi_eigensolver.cu); the Hessenberg eigenproblem on the host."""

    def _solve_impl(self, x0=None) -> EigenResult:
        A = self.A
        n = A.n_rows
        m = min(self._krylov_dim(), n)
        v = self._to_dev(
            x0 if x0 is not None else host_vector(n, self._np_dtype(), 7))
        V = [v]
        H = np.zeros((m + 1, m))
        for j in range(m):
            w = spmv(A, V[j])
            for i in range(j + 1):
                H[i, j] = float(torch.dot(V[i], w))
                w = w - H[i, j] * V[i]
            H[j + 1, j] = float(torch.linalg.vector_norm(w))
            if H[j + 1, j] < 1e-14:
                m = j + 1
                break
            V.append(w / H[j + 1, j])
        evals, evecs = np.linalg.eig(H[:m, :m])
        k = max(self.wanted_count, 1)
        order = np.argsort(np.abs(evals))
        order = order[::-1] if self.which == "largest" else order
        lam = evals[order[:k]]
        Vm = torch.stack(V[:m]).T
        C = self._to_dev(np.ascontiguousarray(evecs[:, order[:k]]))
        if C.is_complex():
            # a complex pair among the wanted Ritz values
            Vm = Vm.to(C.dtype)
        else:
            C = C.to(Vm.dtype)
        X = Vm @ C
        x1 = X[:, 0] / torch.linalg.vector_norm(X[:, 0])
        r = spmv(A, x1.real.contiguous()) - (lam[0] * x1).real
        res = float(torch.linalg.vector_norm(r)) / max(abs(lam[0]), 1e-30)
        return EigenResult(
            eigenvalues=lam, eigenvectors=X, iterations=m,
            converged=res < self.tolerance, residual=res,
        )


@register_eigensolver("LOBPCG")
class LOBPCGEigenSolver(EigenSolver):
    """LOBPCG for extreme eigenpairs of SPD matrices (reference
    lobpcg_eigensolver.cu); Rayleigh-Ritz on the [X R P] basis."""

    def _solve_impl(self, x0=None) -> EigenResult:
        A = self.A
        n = A.n_rows
        k = max(self.wanted_count, 1)
        rng = np.random.default_rng(13)
        X = self._to_dev(np.linalg.qr(
            rng.standard_normal((n, k)).astype(self._np_dtype()))[0])
        largest = self.which == "largest"
        P = None
        lam = np.zeros(k)
        res = np.inf
        it = 0
        for it in range(1, self.max_iters + 1):
            AX = apply_columns(A, X)
            lam_m = torch.diag(X.T @ AX)
            R = AX - X * lam_m
            lam_h = lam_m.cpu().numpy()
            res = float(torch.max(torch.linalg.vector_norm(R, dim=0))) / max(
                float(np.max(np.abs(lam_h))), 1e-30)
            if res < self.tolerance:
                lam = lam_h
                break
            basis = [X, R] + ([P] if P is not None else [])
            # the trial basis, orthonormalized
            S, _ = torch.linalg.qr(torch.cat(basis, dim=1))
            G = (S.T @ apply_columns(A, S)).cpu().numpy()
            evals, evecs = np.linalg.eigh((G + G.T) / 2.0)
            order = _order(evals, largest)
            C = self._to_dev(np.ascontiguousarray(evecs[:, order[:k]]))
            X_new = S @ C
            P = X_new - X @ (X.T @ X_new)
            X = X_new
            lam = evals[order[:k]]
        return EigenResult(
            eigenvalues=np.asarray(lam), eigenvectors=X, iterations=it,
            converged=res < self.tolerance, residual=res,
        )
