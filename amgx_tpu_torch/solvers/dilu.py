"""Multicolor DILU and multicolor ILU(k) smoothers, scalar (reference
multicolor_dilu_solver.cu, multicolor_ilu_solver.cu; the JAX package's
``solvers/dilu.py``).

DILU math: with coloring-induced ordering and E the DILU diagonal,

    E_i = a_ii - sum_{j in N(i), color(j) < color(i)} a_ij E_j^{-1} a_ji
    M   = (E + L) E^{-1} (E + U)

Apply M^{-1} r: forward color sweep solves (E+L) y = r, backward sweep
solves (E+U) z = E y.

ILU(k): exact LU factors on the level-k fill pattern (the pattern of
the sums of A^(j), j <= k + 1), eliminated colour pair by colour pair
on a colouring of the pattern graph, so that rows of one colour are
independent in the pattern.  L has a unit diagonal; the inverted pivots
(``udinv``) scale the backward sweep: M^{-1} r = U^{-1} L^{-1} r.

Both host setups are copies of the JAX package's (colours, rows per
colour, the E recurrence through W = A∘Aᵀ, the ILU elimination, the
per-colour compact ELL slices of L and U), so E, the ILU factors and
the slices are bit for bit the JAX package's.  On the device each
colour is one stage of stock torch ops over its compact slice (the
shape both smoothers share, ``_ColorSweepSmoother``): gather, multiply,
sum over the slot axis, scale, ``index_copy_`` into the colour's rows.
The colours partition the rows, so every write is unique and
deterministic, and one application touches each stored entry once.  The
JAX package's stacked, spill-padded ``fori_loop`` layout exists only to
bound XLA's compile time and is not carried over (with zero padding it
gives the same values).

Not ported: block matrices (``block_size > 1``, ROADMAP.md queue A4b).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from amgx_tpu_torch.core.matrix import (
    SparseMatrix,
    _extract_diag_np,
    _row_ids_np,
    to_tensor,
)
from amgx_tpu_torch.ops.coloring import color_matrix
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import register_solver


def color_ell_slices(Asp: sps.csr_matrix, rows_by_color):
    """Per-color compact ELL slices of a (masked) host CSR matrix.

    Returns list of (cols[nc, w], vals[nc, w]); colors with no stored
    entries get width-1 zero slices (the JAX package's
    ``_color_ell_slices``, scalar case).
    """
    out = []
    for rows_c in rows_by_color:
        sub = Asp[rows_c].tocsr()
        lens = np.diff(sub.indptr)
        w = max(int(lens.max()) if lens.size else 0, 1)
        cols = np.zeros((len(rows_c), w), dtype=np.int32)
        vals = np.zeros((len(rows_c), w), dtype=sub.data.dtype)
        rid = np.repeat(np.arange(len(rows_c)), lens)
        pos = np.arange(sub.indices.shape[0]) - sub.indptr[rid].astype(
            np.int64
        )
        cols[rid, pos] = sub.indices
        vals[rid, pos] = sub.data
        out.append((cols, vals))
    return out


def colored_rows(A, cfg, scope):
    """Colours of ``A`` under the coloring knobs of ``scope``
    (``matrix_coloring_scheme``, ``determinism_flag``, ...), and the
    rows of each colour (host numpy)."""
    colors = color_matrix(A, str(cfg.get("matrix_coloring_scheme", scope)),
                          bool(cfg.get("determinism_flag", scope)),
                          cfg=cfg, scope=scope)
    nc = int(colors.max()) + 1
    return colors, [np.nonzero(colors == c)[0] for c in range(nc)]


def index_tensor(a, device):
    """Host index array -> int64 tensor on ``device`` (the index type
    ``index_copy_`` takes)."""
    return to_tensor(np.asarray(a, dtype=np.int64), device)


def color_stages(rows_by_color, scale, Ls, Us, device):
    """Per colour on ``device``: (rows, scale[rows], L cols, L vals,
    U cols, U vals)."""
    return tuple(
        (
            index_tensor(rows_c, device), to_tensor(scale[rows_c], device),
            index_tensor(Lc, device), to_tensor(Lv, device),
            index_tensor(Uc, device), to_tensor(Uv, device),
        )
        for rows_c, (Lc, Lv), (Uc, Uv) in zip(rows_by_color, Ls, Us)
    )


def _unported_block(name):
    return NotImplementedError(
        f"{name}: block matrices (block_size > 1) are not ported yet "
        "(ROADMAP.md, queue A4b: block matrices)"
    )


class _ColorSweepSmoother(Solver):
    """Shared stationary-step shell of the per-colour sweep smoothers:
    subclasses provide ``_apply_M_inv(params, r)``."""

    def make_residual_step(self):
        omega = self.relaxation_factor

        def rstep(params, b, x, r):
            return x + omega * self._apply_M_inv(params, r)

        return rstep

    def make_apply(self):
        # zero-guess first sweep simplifies to omega * M^-1 r
        omega = self.relaxation_factor
        step = self.make_step()
        iters = max(self.max_iters, 1)

        def apply(params, r):
            z = omega * self._apply_M_inv(params, r)
            for _ in range(iters - 1):
                z = step(params, r, z)
            return z

        return apply


@register_solver("MULTICOLOR_DILU")
class MulticolorDILUSolver(_ColorSweepSmoother):
    def _setup_impl(self, A):
        if A.block_size != 1:
            raise _unported_block(self.registry_name)
        colors, rows_by_color = colored_rows(A, self.cfg, self.scope)
        self.num_colors = nc = len(rows_by_color)

        indptr, indices, vals = A._host
        n = A.n_rows
        row_ids = _row_ids_np(indptr, n)
        lower = colors[indices] < colors[row_ids]
        upper = colors[indices] > colors[row_ids]
        diag = _extract_diag_np(indptr, indices, vals, n)

        # ---- E factors ------------------------------------------------
        Asp = sps.csr_matrix((vals, indices, indptr), shape=(n, n))
        W = Asp.multiply(Asp.T).tocsr()  # w_ij = a_ij * a_ji
        E = diag.astype(vals.dtype).copy()
        for c in range(1, nc):
            rows_c = rows_by_color[c]
            if rows_c.size == 0:
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                einv = np.where((E != 0) & (colors < c), 1.0 / E, 0.0)
            E[rows_c] = diag[rows_c] - (W[rows_c] @ einv)
        E = np.where(E == 0, 1.0, E)
        einv_full = (1.0 / E).astype(vals.dtype)

        # ---- per-color ELL slices of L and U --------------------------
        # independent index copies: eliminate_zeros() compacts
        # indices/indptr in place and the two matrices must not share
        # them
        L = sps.csr_matrix(
            (np.where(lower, vals, 0.0), indices.copy(), indptr.copy()),
            (n, n),
        )
        U = sps.csr_matrix(
            (np.where(upper, vals, 0.0), indices.copy(), indptr.copy()),
            (n, n),
        )
        L.eliminate_zeros()
        U.eliminate_zeros()
        Ls = color_ell_slices(L.tocsr(), rows_by_color)
        Us = color_ell_slices(U.tocsr(), rows_by_color)

        # params[0] is the operator (base Solver convention)
        self._params = (
            A, color_stages(rows_by_color, einv_full, Ls, Us, self.device)
        )

    def _apply_M_inv(self, params, r):
        stages = params[1]
        y = torch.zeros_like(r)
        for rows, einv, Lc, Lv, _, _ in stages:
            s = torch.sum(Lv * y[Lc], dim=1)
            y.index_copy_(0, rows, (r[rows] - s) * einv)
        # backward in place: a colour's rows of y are read at its own
        # stage, before they are overwritten by z
        z = y
        for rows, einv, _, _, Uc, Uv in reversed(stages):
            s = torch.sum(Uv * z[Uc], dim=1)
            z.index_copy_(0, rows, z[rows] - einv * s)
        return z


@register_solver("MULTICOLOR_ILU")
class MulticolorILUSolver(_ColorSweepSmoother):
    """Multicolor ILU(k), scalar (reference multicolor_ilu_solver.cu):
    exact LU factors on the level-k fill pattern (``ilu_sparsity_level``)
    with unit-diagonal L and the inverted pivots in ``udinv``.  The
    factorization is the JAX package's, with one block row per scalar
    row: per colour, its rows are eliminated against each earlier
    colour in turn, using only the U part of the factored rows."""

    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.fill_level = int(cfg.get("ilu_sparsity_level", scope))

    def _setup_impl(self, A):
        if A.block_size != 1:
            raise _unported_block(self.registry_name)
        n = A.n_rows
        indptr, indices, vals = A._host
        Asp = sps.csr_matrix((vals, indices, indptr), shape=(n, n))
        Asp.sort_indices()

        # level-k fill pattern (reference csr_sparsity for ILU1)
        Sb = sps.csr_matrix(
            (np.ones(indices.shape[0], np.int8), indices.copy(),
             indptr.copy()),
            shape=(n, n),
        )
        patt = Sb.copy()
        for _ in range(max(self.fill_level, 0)):
            patt = ((patt @ Sb + patt) != 0).astype(np.int8).tocsr()
        patt.setdiag(1)
        patt.sort_indices()
        self.pattern_nnz = int(patt.nnz)

        # colour the PATTERN graph: rows of one colour are independent
        # in the fill pattern
        patt_mat = SparseMatrix.from_csr(
            patt.indptr, patt.indices, patt.data.astype(vals.dtype),
            accel_formats=(), validate=False, device="cpu",
        )
        colors, rows_by_color = colored_rows(patt_mat, self.cfg,
                                             self.scope)
        self.num_colors = ncol = len(rows_by_color)

        # numeric factorization by colour pairs; fill slots materialize
        # through the pattern-projected subtraction
        dtype = Asp.dtype
        rows_store = [None] * ncol
        u_store = [None] * ncol  # U part (columns of colour >= c)
        udinv = np.zeros((n, 1, 1), dtype=dtype)
        eye = np.eye(1, dtype=dtype)
        pattb = patt.astype(bool)
        for ci, rows_c in enumerate(rows_by_color):
            Rc = Asp[rows_c].tocsr()
            maskc = pattb[rows_c]
            for c2 in range(ci):
                rows_c2 = rows_by_color[c2]
                B = Rc[:, rows_c2].tocsr()
                if B.nnz == 0:
                    continue
                # scale by the factored colour's inverted pivots (the
                # JAX package's block_diag of 1 x 1 blocks: the same
                # matrix, built without a Python loop over the blocks)
                Dinv = sps.diags_array(udinv[rows_c2, 0, 0], format="csr")
                Lb = (B @ Dinv).tocsr()
                # elimination uses ONLY the U part of the factored rows:
                # their L values are factor entries, not residual values
                upd = (Lb @ u_store[c2]).multiply(maskc)
                Rc = (Rc - upd).tocsr()
                # replace the eliminated columns with l_ik
                lcoo = Lb.tocoo()
                emb = sps.csr_matrix(
                    (lcoo.data, (lcoo.row, rows_c2[lcoo.col])),
                    shape=Rc.shape,
                )
                sel = np.zeros(n, dtype=bool)
                sel[rows_c2] = True
                coo = Rc.tocoo()
                keep = ~sel[coo.col]
                Rc = sps.csr_matrix(
                    (coo.data[keep], (coo.row[keep], coo.col[keep])),
                    shape=Rc.shape,
                ) + emb
                Rc = Rc.tocsr()
            # pivots of this colour: each row's own diagonal entry
            cooD = Rc[:, rows_c].tocoo()
            on = cooD.row == cooD.col
            D = np.zeros((len(rows_c), 1, 1), dtype=dtype)
            D[cooD.row[on], 0, 0] = cooD.data[on]
            ok = np.abs(np.linalg.det(D)) > 1e-300
            D = np.where(ok[:, None, None], D, eye)
            udinv[rows_c] = np.linalg.inv(D)
            rows_store[ci] = Rc
            coo_u = Rc.tocoo()
            ukeep = (colors >= ci)[coo_u.col]
            u_store[ci] = sps.csr_matrix(
                (coo_u.data[ukeep], (coo_u.row[ukeep], coo_u.col[ukeep])),
                shape=Rc.shape,
            )
        # the factored rows in their original order
        full = sps.vstack(rows_store, format="csr")
        inv_order = np.argsort(np.concatenate(rows_by_color))
        fact = full[inv_order].tocsr()

        # split: unit L (colours <) and strict U (colours >); each row's
        # pivot lives in udinv
        coo = fact.tocoo()
        c_row, c_col = colors[coo.row], colors[coo.col]
        L = sps.csr_matrix((coo.data * (c_col < c_row), (coo.row, coo.col)),
                           shape=(n, n))
        U = sps.csr_matrix((coo.data * (c_col > c_row), (coo.row, coo.col)),
                           shape=(n, n))
        L.eliminate_zeros()
        U.eliminate_zeros()
        Ls = color_ell_slices(L.tocsr(), rows_by_color)
        Us = color_ell_slices(U.tocsr(), rows_by_color)
        self._params = (
            A, color_stages(rows_by_color, udinv.reshape(-1), Ls, Us,
                            self.device)
        )

    def _apply_M_inv(self, params, r):
        stages = params[1]
        # forward: L y = r (unit diagonal)
        y = torch.zeros_like(r)
        for rows, _, Lc, Lv, _, _ in stages:
            s = torch.sum(Lv * y[Lc], dim=1)
            y.index_copy_(0, rows, r[rows] - s)
        # backward in place: U z = y with the inverted pivots; a
        # colour's rows of y are read at its own stage, before they are
        # overwritten by z
        z = y
        for rows, udinv, _, _, Uc, Uv in reversed(stages):
            s = torch.sum(Uv * z[Uc], dim=1)
            z.index_copy_(0, rows, udinv * (z[rows] - s))
        return z
