"""Polynomial smoothers (reference polynomial_solver.cu,
kpz_polynomial_solver.cu; the JAX package's ``solvers/polynomial.py``).

POLYNOMIAL: truncated Neumann series in the Jacobi-preconditioned
operator, z = sum_{k<order} (I - D^{-1}A)^k D^{-1} r.
KPZ_POLYNOMIAL: the Kraus-Pillwein-Zikatanov three-term recurrence over
[smax / kpz_mu, smax], smax = ||A||_inf from column sums at setup.
OPT_POLYNOMIAL: the fourth-kind Chebyshev smoother over [0, lmax] with
Lottes' optimized weights (arxiv 2202.08830, Table 1), lmax from
CHEBYSHEV's power iteration.  All three are chains of SpMVs and vector
updates on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.ops.diagonal import (
    invert_diag,
    invert_diag_batched,
    scalarized,
)
from amgx_tpu_torch.ops.spmv import segment_sum, spmv
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.chebyshev import ChebyshevSolver
from amgx_tpu_torch.solvers.registry import register_solver


@register_solver("POLYNOMIAL")
class PolynomialSolver(Solver):
    order_param = "kpz_order"

    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.order = max(int(cfg.get(self.order_param, scope)), 1)

    def _setup_impl(self, A):
        A = scalarized(A, self.registry_name)
        self._params = (A, invert_diag(A))

    def make_batch_params(self):
        """Batched views of the operator and each instance's inverted
        Jacobi diagonal; None for a block matrix (scalarized at
        setup)."""
        A0 = self._params[0]
        if A0 is not self.A:
            return None

        def fn(t, v):
            A = t.replace_values_batched(v)
            return A, invert_diag_batched(A.diag)

        return A0, fn

    def make_residual_step(self):
        order = self.order
        omega = self.relaxation_factor

        def rstep(params, b, x, r):
            A, dinv = params
            # z_m = sum_{k<=m} (I - Dinv A)^k Dinv r, built incrementally
            z = dinv * r
            for _ in range(order - 1):
                z = z - dinv * spmv(A, z) + dinv * r
            return x + omega * z

        return rstep


def _kpz_window(smax, mu, sqrt):
    """KPZ's spectral window over [smax / mu, smax]: (smu0, smu1,
    delta, beta, chi), for a float smax with ``np.sqrt`` at setup or a
    (B, 1) tensor with ``torch.sqrt`` in the batch rebuild."""
    smin = smax / mu
    smu0, smu1 = 1.0 / smax, 1.0 / smin
    skappa = sqrt(smax / smin)
    delta = (skappa - 1.0) / (skappa + 1.0)
    beta = (sqrt(smu0) + sqrt(smu1)) ** 2
    chi = 4.0 * smu0 * smu1 / beta
    return smu0, smu1, delta, beta, chi


@register_solver("KPZ_POLYNOMIAL")
class KPZPolynomialSolver(PolynomialSolver):
    """KPZ smoother (reference kpz_polynomial_solver.cu:154-219): the
    scalars (delta, beta, chi) derive from smax = ||A||_inf and smin =
    smax / kpz_mu at setup, as 0-dim tensors in the values' dtype."""

    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.mu = max(int(cfg.get("kpz_mu", scope)), 2)

    def _setup_impl(self, A):
        A = scalarized(A, self.registry_name)
        # ||A||_inf via column abs-sums (reference transposes and takes
        # the max row sum, kpz_polynomial_solver.cu:100-111)
        # (on a copy: scipy's abs sums duplicate entries in place, and
        # the view shares the matrix's host arrays)
        smax = float(np.abs(A.host_csr().copy()).sum(axis=0).max())
        smax = smax if smax > 0 else 1.0
        coef = tuple(
            torch.tensor(v, dtype=A.dtype, device=A.device)
            for v in _kpz_window(smax, self.mu, np.sqrt)
        )
        self._params = (A, coef)

    def make_batch_params(self):
        """Batched views of the operator and each instance's spectral
        window: smax the largest column abs-sum of its values (summed
        column by column in entry order over a column-sorted
        permutation shared by the batch), the five scalars derived
        from it in float64 as at setup and held as (B, 1) tensors in
        the values' dtype."""
        A0 = self._params[0]
        if A0 is not self.A:
            return None
        cols = A0.col_indices.long()
        perm = torch.argsort(cols, stable=True)
        col_offsets = torch.searchsorted(
            cols[perm], torch.arange(A0.n_cols + 1, device=cols.device))
        mu = self.mu

        def fn(t, v):
            A, perm, col_offsets = t[0].replace_values_batched(v), t[1], t[2]
            colsum = segment_sum(torch.abs(A.values)[:, perm].T.contiguous(),
                                 col_offsets)
            smax = colsum.amax(dim=0).to(torch.float64).reshape(-1, 1)
            smax = torch.where(smax > 0, smax, torch.ones_like(smax))
            return A, tuple(c.to(A.dtype)
                            for c in _kpz_window(smax, mu, torch.sqrt))

        return (A0, perm, col_offsets), fn

    def make_residual_step(self):
        order = max(self.order, 1)

        def rstep(params, b, x, r):
            A, (smu0, smu1, delta, beta, chi) = params
            # reference smooth_1x1: v0 = (smu0+smu1)/2 * r;
            # v = beta/2 * r - smu0*smu1 * A r; then the recurrence
            v0 = (smu0 + smu1) * 0.5 * r
            v = beta * 0.5 * r - smu0 * smu1 * spmv(A, r)
            for _ in range(2, order + 1):
                sn = chi * (r - spmv(A, v)) + delta * delta * (v - v0)
                v0 = v
                v = v + sn
            return x + v

        return rstep


# Optimized accumulation weights beta_k of the degree-K fourth-kind
# Chebyshev smoother (Lottes, arxiv 2202.08830, Table 1)
_OPT_FOURTH_KIND_WEIGHTS = {
    1: (1.12500000000000,),
    2: (1.02387287570313, 1.26408905371085),
    3: (1.00842544782028, 1.08867839208730, 1.33753125909618),
    4: (1.00391310427285, 1.04035811188593, 1.14863498546254,
        1.38268869241000),
    5: (1.00212930146164, 1.02173711549260, 1.07872433192603,
        1.19810065292663, 1.41322542791682),
    6: (1.00128517255940, 1.01304293035233, 1.04678215124113,
        1.11616489419675, 1.23829020218444, 1.43524297106744),
}


def opt_fourth_kind_weights(order: int):
    """Optimal beta weights for a degree-``order`` fourth-kind
    Chebyshev smoother; degrees beyond the table take the unweighted
    (beta = 1) fourth-kind polynomial."""
    w = _OPT_FOURTH_KIND_WEIGHTS.get(int(order))
    if w is None:
        return (1.0,) * int(order)
    return w


@register_solver("OPT_POLYNOMIAL")
class OptPolynomialSolver(ChebyshevSolver):
    """Optimal-weight fourth-kind Chebyshev smoother of degree
    ``chebyshev_polynomial_order``: CHEBYSHEV's setup (lmax by power
    iteration), a fourth-kind sweep over [0, lmax], k SpMVs a sweep
    with the residual it is given."""

    def make_residual_step(self):
        k = max(self.order, 1)
        betas = opt_fourth_kind_weights(k)
        rho = self.lmax
        M = self._make_M()

        def rstep(params, b, x, r):
            A, Mp = params
            # Lottes alg. 2/3: the auxiliary d/r recurrence is the
            # unweighted fourth-kind iteration; the optimized betas
            # only reweight the corrections accumulated into x
            d = (4.0 / (3.0 * rho)) * M(Mp, r)
            for j in range(1, k + 1):
                x = x + betas[j - 1] * d
                if j == k:
                    break
                r = r - spmv(A, d)
                d = ((2.0 * j - 1.0) / (2.0 * j + 3.0)) * d + (
                    (8.0 * j + 4.0) / ((2.0 * j + 3.0) * rho)
                ) * M(Mp, r)
            return x

        return rstep

    # the generic residual-step wrapper, not CHEBYSHEV's first-kind step
    make_step = Solver.make_step
