"""Equation scalers (reference src/scalers/: DIAGONAL_SYMMETRIC,
BINORMALIZATION, NBINORMALIZATION; hooked in Solver::setup/solve,
solver.cu:667-676).  A copy of the JAX package's host numpy/scipy
module.

A scaler computes row and column scaling vectors at setup; the solver
then works on As = Dr A Dc, the right-hand side is scaled before the
solve (b -> Dr b) and the solution unscaled after (x -> Dc x).  For
symmetric scalings Dr == Dc.
"""

from __future__ import annotations

import numpy as np


class Scaler:
    """Computes (left, right) positive scaling vectors."""

    def compute(self, Asp):
        raise NotImplementedError


class DiagonalSymmetricScaler(Scaler):
    """As = D^{-1/2} A D^{-1/2} (reference diagonal_symmetric_scaler.cu)."""

    def compute(self, Asp):
        d = np.abs(Asp.diagonal())
        s = 1.0 / np.sqrt(np.where(d > 0, d, 1.0))
        return s, s


class BinormalizationScaler(Scaler):
    """Symmetric binormalization (Livne-Golub): u > 0 with u_i (B u)_i
    = 1 for B = |A|.^2 by the damped iteration u <- sqrt(u / (B u)),
    then D = diag(sqrt(u)).  Symmetric, so SPD systems stay SPD."""

    def __init__(self, iters: int = 50):
        self.iters = iters

    def compute(self, Asp):
        B = Asp.copy().tocsr()
        B.data = np.abs(B.data) ** 2
        # symmetrize the weight graph so the iteration is well-defined
        # for mildly nonsymmetric A as well
        B = ((B + B.T) * 0.5).tocsr()
        u = 1.0 / np.maximum(np.asarray(B.sum(axis=1)).ravel(), 1e-300)
        for _ in range(self.iters):
            Bu = B @ u
            u = np.sqrt(u / np.where(Bu > 0, Bu, 1.0))
        s = np.sqrt(u)
        return s, s


class NBinormalizationScaler(Scaler):
    """Nonsymmetric binormalization (reference nbinormalization.cu):
    with B = A.^2, alternately x = cols ./ (B y) and y = rows ./ (B' x);
    Dr = diag(sqrt|x|), Dc = diag(sqrt|y|) equalize the row and column
    2-norms of Dr A Dc."""

    def __init__(self, iters: int = 50, tolerance: float = 1e-10):
        self.iters = iters
        self.tolerance = tolerance

    def compute(self, Asp):
        B = Asp.copy().tocsr()
        B.data = B.data.astype(np.float64) ** 2
        rows, cols = B.shape
        Bt = B.T.tocsr()
        x = np.ones(rows)
        y = np.ones(cols)
        sum1, sum2 = float(cols), float(rows)
        beta = B @ y

        def _rms(resid, denom):
            return np.sqrt(np.mean(resid**2)) / denom

        for _ in range(self.iters):
            x = sum1 / np.where(beta > 0, beta, 1.0)
            gamma = Bt @ x
            # residuals against fresh products of the other side's stale
            # iterate (structurally zero rows/cols count as satisfied)
            std2 = _rms(
                np.where(gamma > 0, y * gamma - sum2, 0.0), sum2
            )
            y = sum2 / np.where(gamma > 0, gamma, 1.0)
            beta = B @ y
            std1 = _rms(
                np.where(beta > 0, x * beta - sum1, 0.0), sum1
            )
            if np.hypot(std1, std2) < self.tolerance:
                break
        return np.sqrt(np.abs(x)), np.sqrt(np.abs(y))


_SCALERS = {
    "DIAGONAL_SYMMETRIC": DiagonalSymmetricScaler,
    "BINORMALIZATION": BinormalizationScaler,
    "NBINORMALIZATION": NBinormalizationScaler,
}


def create_scaler(name: str):
    name = name.upper()
    if name in ("", "NONE"):
        return None
    try:
        return _SCALERS[name]()
    except KeyError:
        raise KeyError(
            f"unknown scaler {name!r}; known: {sorted(_SCALERS)}"
        ) from None
