"""Multicolor DILU smoother, scalar (reference
multicolor_dilu_solver.cu; the JAX package's ``solvers/dilu.py``).

DILU math: with coloring-induced ordering and E the DILU diagonal,

    E_i = a_ii - sum_{j in N(i), color(j) < color(i)} a_ij E_j^{-1} a_ji
    M   = (E + L) E^{-1} (E + U)

Apply M^{-1} r: forward color sweep solves (E+L) y = r, backward sweep
solves (E+U) z = E y.

The host setup is a copy of the JAX package's (colours, rows per
colour, the E recurrence through W = A∘Aᵀ, the per-colour compact ELL
slices of L and U), so E and the slices are bit for bit the JAX
package's.  On the device each colour is one stage of stock torch ops
over its compact slice: gather, multiply, sum over the slot axis,
scale by E^{-1}, ``index_copy_`` into the colour's rows.  The colours
partition the rows, so every write is unique and deterministic, and
one application touches each stored entry once.  The JAX package's
stacked, spill-padded ``fori_loop`` layout exists only to bound XLA's
compile time and is not carried over (with zero padding it gives the
same values).

Not ported: block matrices (``block_size > 1``, ROADMAP.md queue A4)
and MULTICOLOR_ILU.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from amgx_tpu_torch.core.matrix import (
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


@register_solver("MULTICOLOR_DILU")
class MulticolorDILUSolver(Solver):
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

    def _setup_impl(self, A):
        if A.block_size != 1:
            raise NotImplementedError(
                "MULTICOLOR_DILU: block matrices (block_size > 1) are not "
                "ported yet (ROADMAP.md, queue A4: block matrices and "
                "reduced precision)"
            )
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

        dev = self.device
        # params[0] is the operator (base Solver convention); per colour:
        # (rows, einv[rows], L cols, L vals, U cols, U vals)
        self._params = (
            A,
            tuple(
                (
                    index_tensor(rows_c, dev),
                    to_tensor(einv_full[rows_c], dev),
                    index_tensor(Lc, dev), to_tensor(Lv, dev),
                    index_tensor(Uc, dev), to_tensor(Uv, dev),
                )
                for rows_c, (Lc, Lv), (Uc, Uv)
                in zip(rows_by_color, Ls, Us)
            ),
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
