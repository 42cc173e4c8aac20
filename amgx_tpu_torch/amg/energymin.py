"""Energy-minimization AMG (reference src/energymin/**: EM interpolator
with classical-style selection, energymin_amg_level.cu:184-205).

Approach (round 5, matching the reference EM structure): classical C/F
selection (CR default / PMIS), then per-coarse-column LOCAL energy
minimization — each column is the locally-ideal interpolation
-A[F_c,F_c]^{-1} A[F_c,c] over its strong F-neighbour pattern (the
reference's dense local Aij solves, em.cu:189-867) — followed by the
constant-preservation projection and a few sweeps of constrained
steepest descent on trace(P^T A P) (the global coupling the reference
resolves with its Ma Lagrange system).

A copy of the JAX package's ``amg/energymin.py`` (host numpy/scipy).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from amgx_tpu_torch.amg.classical import (
    pmis_select,
    strength_ahat,
)


def _em_local_columns(Asp: sps.csr_matrix, S, cf) -> sps.csr_matrix:
    """Column-wise local energy minimization (the structure of the
    reference EM interpolator, energymin/interpolators/em.cu:189-867:
    per coarse point, extract the dense local block over the column's
    F-row pattern, invert, and form the column): for coarse point c
    with pattern rows F_c (strong F neighbours of c),

        P[F_c, j] = -A[F_c, F_c]^{-1} A[F_c, c],   P[c, j] = 1

    — the locally-ideal interpolation column.  The reference couples
    overlapping columns through its Ma Lagrange system; here the
    coupling is handled by the constraint projection + energy descent
    polish in :func:`energymin_interpolation`."""
    n = Asp.shape[0]
    cmap = np.cumsum(cf) - 1
    nc = int(cf.sum())
    Ssym = ((S + S.T) > 0).tocsr()
    A = Asp.tocsr()
    rows_out, cols_out, vals_out = [], [], []
    c_rows = np.nonzero(cf == 1)[0]
    rows_out.append(c_rows)
    cols_out.append(cmap[c_rows])
    vals_out.append(np.ones(len(c_rows)))
    for c in c_rows:
        nb = Ssym.indices[Ssym.indptr[c]: Ssym.indptr[c + 1]]
        Fc = nb[(cf[nb] == 0)]
        if not len(Fc):
            continue
        Aloc = A[Fc][:, Fc].toarray()
        rhs = -np.asarray(A[Fc][:, [c]].todense()).ravel()
        try:
            x = np.linalg.solve(
                Aloc + 1e-14 * np.eye(len(Fc)), rhs)
        except np.linalg.LinAlgError:
            continue
        rows_out.append(Fc)
        cols_out.append(np.full(len(Fc), cmap[c]))
        vals_out.append(x)
    P = sps.csr_matrix(
        (
            np.concatenate(vals_out),
            (np.concatenate(rows_out), np.concatenate(cols_out)),
        ),
        shape=(n, nc),
    )
    P.sum_duplicates()
    # constraint projection: rescale F rows to preserve constants
    rs = np.asarray(P.sum(axis=1)).ravel()
    scale = np.where((cf == 0) & (rs != 0),
                     1.0 / np.where(rs != 0, rs, 1.0), 1.0)
    P = (sps.diags_array(scale) @ P).tocsr()
    P.sort_indices()
    return P


def _energy_descent(Asp, cf, P, sweeps, omega):
    """Constrained steepest descent on trace(P^T A P) restricted to
    P's sparsity pattern, constant preservation invariant."""
    pattern = (P != 0).astype(np.float64).tocsr()
    row_nnz = np.asarray(pattern.sum(axis=1)).ravel()
    diag = Asp.diagonal()
    dinv = 1.0 / np.where(diag != 0, diag, 1.0)
    # constant across sweeps: F-row scaled operator
    M = (
        sps.diags_array((cf == 0).astype(np.float64) * dinv) @ Asp
    ).tocsr()
    for _ in range(sweeps):
        # damped Jacobi step on the energy gradient, F rows only,
        # restricted to the sparsity pattern
        G = (M @ P).multiply(pattern)
        # project out the per-row mean so row sums (constant
        # preservation) are invariant by construction — post-hoc
        # rescaling would cancel the update on low-entry rows
        gmean = np.asarray(G.sum(axis=1)).ravel() / np.where(
            row_nnz > 0, row_nnz, 1.0
        )
        G = (G - pattern.multiply(gmean[:, None])).tocsr()
        P = (P - omega * G).tocsr()
    P.sum_duplicates()
    P.sort_indices()
    return P


def energymin_interpolation(Asp: sps.csr_matrix, S, cf,
                            sweeps: int = 4,
                            omega: float = 0.7) -> sps.csr_matrix:
    """EM interpolation: locally-ideal columns (reference dense local
    Aij solves) polished by constrained energy descent; a D1-seeded
    descent serves as the safety net — the lower-energy candidate
    wins (the reference resolves the column coupling exactly with its
    Ma Lagrange system; the descent approximates it, so neither seed
    dominates on every problem)."""
    from amgx_tpu_torch.amg.classical import direct_interpolation

    if (cf == 0).sum() == 0 or int(cf.sum()) == 0:
        return _em_local_columns(Asp, S, cf)
    cands = []
    P_loc = _em_local_columns(Asp, S, cf)
    if P_loc.nnz:
        cands.append(_energy_descent(Asp, cf, P_loc, sweeps, omega))
    P_d1 = direct_interpolation(Asp, S, cf)
    if P_d1.nnz:
        cands.append(_energy_descent(Asp, cf, P_d1, sweeps, omega))
    if not cands:
        return P_loc
    # trace(P^T A P) without materializing the coarse operator
    energies = [
        float(P.multiply(Asp @ P).sum()) for P in cands
    ]
    return cands[int(np.argmin(energies))]


def build_energymin_level(Asp, cfg, scope):
    """One energymin level (reference energymin_amg_level.cu).  Honors
    the same strength/selector/truncation config keys as the classical
    path."""
    from amgx_tpu_torch.amg.classical import (
        aggressive_pmis_select,
        cr_select,
        hmis_select,
        rs_select,
        strength_all,
        truncate_interp,
    )

    theta = float(cfg.get("strength_threshold", scope))
    max_row_sum = float(cfg.get("max_row_sum", scope))
    strength = str(cfg.get("strength", scope)).upper()
    # the energymin path has its own selector param (reference
    # energymin_amg_level.cu reads energymin_selector, default CR);
    # an explicitly-set generic selector still wins for compatibility
    # with configs that predate the dedicated key
    if cfg.has("selector", scope):
        selector = str(cfg.get("selector", scope)).upper()
    else:
        selector = str(cfg.get("energymin_selector", scope)).upper()
    em_interp = str(cfg.get("energymin_interpolator", scope)).upper()
    if em_interp not in ("EM", ""):
        import warnings

        warnings.warn(
            f"energymin_interpolator {em_interp!r}: only EM is "
            "implemented; using EM"
        )
    trunc = float(cfg.get("interp_truncation_factor", scope))
    max_el = int(cfg.get("interp_max_elements", scope))

    S = (
        strength_all(Asp)
        if strength == "ALL"
        else strength_ahat(Asp, theta, max_row_sum)
    )
    if selector in ("AGGRESSIVE_PMIS", "AGGRESSIVE_HMIS"):
        cf = aggressive_pmis_select(S)
    elif selector == "CR":
        # reference energymin default: compatible relaxation (cr.cu)
        cf = cr_select(S, Asp)
    elif selector == "RS":
        cf = rs_select(S)
    elif selector == "HMIS":
        cf = hmis_select(S)
    else:
        cf = pmis_select(S)
    P = energymin_interpolation(Asp, S, cf)
    P = truncate_interp(P, trunc, max_el)
    R = P.T.tocsr()
    Ac = (R @ Asp @ P).tocsr()
    Ac.sum_duplicates()
    Ac.sort_indices()
    return P, R, Ac
