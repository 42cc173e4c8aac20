"""Multicolor DILU and multicolor ILU(k) smoothers, scalar and
block-native (reference multicolor_dilu_solver.cu,
multicolor_ilu_solver.cu; the JAX package's ``solvers/dilu.py``).

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
the slices are bit for bit the JAX package's.

Block matrices (``block_size`` b > 1) are native, as in the JAX
package: the block graph is coloured; DILU's E_i = a_ii - sum_lower
a_ij E_j^-1 a_ji is a b x b block, formed colour by colour with batched
products and inverted with ``np.linalg.inv``, and its sweeps multiply
(w, b, b) slices of blocks by gathered (w, b) slices of the vector (one
batched product and a sum over the slots); ILU(k) eliminates whole
block columns with the inverted pivot blocks on the scalar expansion
and its backward sweep applies the inverted pivot blocks.  On the device each
colour is one stage of stock torch ops over its compact slice (the
shape both smoothers share, ``_ColorSweepSmoother``): gather, multiply,
sum over the slot axis, scale, ``index_copy_`` into the colour's rows.
The colours partition the rows, so every write is unique and
deterministic, and one application touches each stored entry once.  The
JAX package's stacked, spill-padded ``fori_loop`` layout exists only to
bound XLA's compile time and is not carried over (with zero padding it
gives the same values).

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


def color_stages(rows_by_color, scales, Ls, Us, device):
    """Per colour on ``device``: (rows, its scale, L cols, L vals, U
    cols, U vals), ``scales`` one array a colour."""
    return tuple(
        (
            index_tensor(rows_c, device), to_tensor(scale, device),
            index_tensor(Lc, device), to_tensor(Lv, device),
            index_tensor(Uc, device), to_tensor(Uv, device),
        )
        for rows_c, scale, (Lc, Lv), (Uc, Uv) in zip(rows_by_color, scales,
                                                     Ls, Us)
    )


def block_color_slices(indptr, indices, vals, rows_by_color, b):
    """Per-colour ELL slices of block CSR arrays (vals (nnz, b, b)):
    (cols[nc, w], vals[nc, w, b, b]) with every stored block of each
    row, width-1 zero slices for empty colours (the JAX package's
    ``_block_color_slices``, vectorized)."""
    out = []
    lens_all = np.diff(indptr)
    for rows_c in rows_by_color:
        lens = lens_all[rows_c]
        w = max(int(lens.max()) if rows_c.size else 0, 1)
        cols = np.zeros((len(rows_c), w), dtype=np.int32)
        vv = np.zeros((len(rows_c), w, b, b), dtype=vals.dtype)
        rid = np.repeat(np.arange(len(rows_c)), lens)
        pos = np.arange(rid.shape[0]) - np.repeat(
            np.cumsum(lens) - lens, lens)
        src = np.repeat(indptr[rows_c].astype(np.int64), lens) + pos
        cols[rid, pos] = indices[src]
        vv[rid, pos] = vals[src]
        out.append((cols, vv))
    return out


def block_slice_product(vals, x2d, cols):
    """sum_w vals[:, w] @ x2d[cols[:, w]] for (nc, w, b, b) ``vals``:
    one batched b x b product over every slot, then the sum over the
    slots -> (nc, b)."""
    nc, w, b, _ = vals.shape
    prod = torch.bmm(vals.reshape(nc * w, b, b),
                     x2d[cols].reshape(nc * w, b, 1))
    return prod.reshape(nc, w, b).sum(dim=1)


def block_inverse_product(inv, v):
    """inv[i] @ v[i] for (nc, b, b) ``inv`` and (nc, b) ``v``."""
    return torch.bmm(inv, v.unsqueeze(2)).squeeze(2)


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
        self._block = A.block_size
        if A.block_size != 1:
            return self._setup_block(A)
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
            A, color_stages(rows_by_color,
                            [einv_full[r] for r in rows_by_color], Ls, Us,
                            self.device)
        )

    def _setup_block(self, A):
        """Block E factors and block slices (the JAX package's
        ``_setup_impl`` for b > 1, in its order of operations)."""
        b = A.block_size
        colors, rows_by_color = colored_rows(A, self.cfg, self.scope)
        self.num_colors = nc = len(rows_by_color)
        indptr, indices, vals = A._host
        n = A.n_rows
        row_ids = _row_ids_np(indptr, n)
        lower = colors[indices] < colors[row_ids]
        upper = colors[indices] > colors[row_ids]
        diag = _extract_diag_np(indptr, indices, vals, n)

        # E_i = a_ii - sum_lower a_ij Einv_j a_ji; (i, j) -> the slot of
        # (j, i) where it is stored, by one lexsorted search
        order = np.lexsort((indices, row_ids))
        key_s = (row_ids[order].astype(np.int64) * (n + 1)
                 + indices[order])
        tkey = indices.astype(np.int64) * (n + 1) + row_ids
        pos = np.searchsorted(key_s, tkey)
        ok = (pos < key_s.shape[0]) & (
            key_s[np.minimum(pos, len(key_s) - 1)] == tkey
        )
        trans_slot = np.where(ok, order[np.minimum(pos, len(order) - 1)],
                              -1)
        Einv = np.zeros((n, b, b), dtype=vals.dtype)
        E = diag.astype(vals.dtype).copy()
        eye = np.eye(b, dtype=vals.dtype)
        col_of_entry = colors[indices]
        row_of_entry = colors[row_ids]
        for c in range(nc):
            rows_c = rows_by_color[c]
            if rows_c.size == 0:
                continue
            if c > 0:
                # the entries of colour-c rows whose column colour is
                # lower and whose transpose is stored, all at once
                in_c = (
                    (row_of_entry == c)
                    & (col_of_entry < c)
                    & (trans_slot >= 0)
                    & (indices != row_ids)
                )
                if in_c.any():
                    ei = row_ids[in_c]
                    prod = np.einsum(
                        "nij,njk,nkl->nil",
                        vals[in_c],
                        Einv[indices[in_c]],
                        vals[np.maximum(trans_slot[in_c], 0)],
                    )
                    E[rows_c] = diag[rows_c]
                    np.add.at(E, ei, -prod)
            blk = E[rows_c]
            dets_ok = np.abs(np.linalg.det(blk)) > 1e-300
            safe = np.where(dets_ok[:, None, None], blk, eye)
            Einv[rows_c] = np.linalg.inv(safe)

        Ls = block_color_slices(
            indptr, indices, np.where(lower[:, None, None], vals, 0),
            rows_by_color, b)
        Us = block_color_slices(
            indptr, indices, np.where(upper[:, None, None], vals, 0),
            rows_by_color, b)
        self._params = (
            A, color_stages(rows_by_color, [Einv[r] for r in rows_by_color],
                            Ls, Us, self.device)
        )

    def _apply_M_inv(self, params, r):
        stages = params[1]
        if self._block > 1:
            return self._apply_block(stages, r.reshape(-1, self._block))
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

    @staticmethod
    def _apply_block(stages, r2):
        """The block sweeps on (n, b) vectors: forward (E + L) y = r,
        backward (E + U) z = E y."""
        y = torch.zeros_like(r2)
        for rows, einv, Lc, Lv, _, _ in stages:
            s = block_slice_product(Lv, y, Lc)
            y.index_copy_(0, rows, block_inverse_product(einv,
                                                         r2[rows] - s))
        z = y
        for rows, einv, _, _, Uc, Uv in reversed(stages):
            s = block_slice_product(Uv, z, Uc)
            z.index_copy_(0, rows, z[rows]
                          - block_inverse_product(einv, s))
        return z.reshape(-1)


@register_solver("MULTICOLOR_ILU")
class MulticolorILUSolver(_ColorSweepSmoother):
    """Multicolor ILU(k) (reference multicolor_ilu_solver.cu): exact LU
    factors on the level-k fill pattern (``ilu_sparsity_level``) of the
    block graph, with unit-diagonal L and the inverted pivots (b x b
    blocks for a block matrix) in ``udinv``.  The factorization is the
    JAX package's: the scalar expansion's rows of each colour are
    eliminated against each earlier colour in turn, whole block columns
    at a time, using only the U part of the factored rows."""

    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.fill_level = int(cfg.get("ilu_sparsity_level", scope))

    def _setup_impl(self, A):
        b = self._block = A.block_size
        n = A.n_rows  # block rows
        indptr, indices, vals = A._host
        Asp = A.to_scipy()  # a copy; the scalar expansion for b > 1
        Asp.sort_indices()

        # level-k fill pattern on the block graph (reference
        # csr_sparsity for ILU1)
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

        # colour the PATTERN graph: block rows of one colour are
        # independent in the fill pattern
        patt_mat = SparseMatrix.from_csr(
            patt.indptr, patt.indices, patt.data.astype(vals.dtype),
            accel_formats=(), validate=False, device="cpu",
        )
        colors, rows_by_color = colored_rows(patt_mat, self.cfg,
                                             self.scope)
        self.num_colors = ncol = len(rows_by_color)
        # scalar rows of each colour's block rows
        srows_by_color = [
            (r[:, None] * b + np.arange(b)[None, :]).reshape(-1)
            for r in rows_by_color
        ]
        ones_bb = np.ones((b, b), np.int8)

        # numeric factorization by colour pairs; fill slots materialize
        # through the pattern-projected subtraction
        dtype = Asp.dtype
        rows_store = [None] * ncol
        u_store = [None] * ncol  # U part (block columns of colour >= c)
        udinv = np.zeros((n, b, b), dtype=dtype)
        eye = np.eye(b, dtype=dtype)
        pattb = patt.astype(bool)
        N = n * b
        for ci, rows_c in enumerate(rows_by_color):
            sr = srows_by_color[ci]
            Rc = Asp[sr].tocsr()
            maskc = pattb[rows_c]
            if b > 1:
                maskc = sps.kron(maskc, ones_bb, format="csr")
            for c2 in range(ci):
                rows_c2 = rows_by_color[c2]
                sc2 = srows_by_color[c2]
                B = Rc[:, sc2].tocsr()
                if B.nnz == 0:
                    continue
                # block-column elimination: scale by the factored
                # colour's inverted pivot blocks
                Dinv = _block_diag_csr(udinv[rows_c2])
                Lb = (B @ Dinv).tocsr()
                # elimination uses ONLY the U part of the factored rows:
                # their L values are factor entries, not residual values
                upd = (Lb @ u_store[c2]).multiply(maskc)
                Rc = (Rc - upd).tocsr()
                # replace the eliminated block columns with l_ik
                lcoo = Lb.tocoo()
                emb = sps.csr_matrix(
                    (lcoo.data, (lcoo.row, sc2[lcoo.col])),
                    shape=Rc.shape,
                )
                sel = np.zeros(N, dtype=bool)
                sel[sc2] = True
                coo = Rc.tocoo()
                keep = ~sel[coo.col]
                Rc = sps.csr_matrix(
                    (coo.data[keep], (coo.row[keep], coo.col[keep])),
                    shape=Rc.shape,
                ) + emb
                Rc = Rc.tocsr()
            # pivot blocks of this colour: the entries of Rc in each
            # row's own diagonal block
            cooD = Rc[:, sr].tocoo()
            on = (cooD.row // b) == (cooD.col // b)
            D = np.zeros((len(rows_c), b, b), dtype=dtype)
            D[cooD.row[on] // b, cooD.row[on] % b, cooD.col[on] % b] = (
                cooD.data[on]
            )
            ok = np.abs(np.linalg.det(D)) > 1e-300
            D = np.where(ok[:, None, None], D, eye)
            udinv[rows_c] = np.linalg.inv(D)
            rows_store[ci] = Rc
            coo_u = Rc.tocoo()
            ukeep = (colors >= ci)[coo_u.col // b]
            u_store[ci] = sps.csr_matrix(
                (coo_u.data[ukeep], (coo_u.row[ukeep], coo_u.col[ukeep])),
                shape=Rc.shape,
            )
        # the factored rows in their original order
        full = sps.vstack(rows_store, format="csr")
        inv_order = np.argsort(np.concatenate(srows_by_color))
        fact = full[inv_order].tocsr()

        # split: unit L (block colours <) and strict U (block colours >);
        # each row's pivot block lives in udinv
        coo = fact.tocoo()
        c_row, c_col = colors[coo.row // b], colors[coo.col // b]
        L = sps.csr_matrix((coo.data * (c_col < c_row), (coo.row, coo.col)),
                           shape=(N, N))
        U = sps.csr_matrix((coo.data * (c_col > c_row), (coo.row, coo.col)),
                           shape=(N, N))
        L.eliminate_zeros()
        U.eliminate_zeros()
        Ls = color_ell_slices(L.tocsr(), srows_by_color)
        Us = color_ell_slices(U.tocsr(), srows_by_color)
        # each colour's inverted pivots: scalars by its rows, (m, b, b)
        # blocks by its block rows
        scales = [udinv[r].reshape(-1) if b == 1 else udinv[r]
                  for r in rows_by_color]
        self._params = (A, color_stages(srows_by_color, scales, Ls, Us,
                                        self.device))

    def _apply_M_inv(self, params, r):
        stages = params[1]
        b = self._block
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
            t = z[rows] - s
            if b == 1:
                zc = udinv * t
            else:
                zc = block_inverse_product(udinv, t.reshape(-1, b))
            z.index_copy_(0, rows, zc.reshape(-1))
        return z


def _block_diag_csr(blocks):
    """CSR of the block-diagonal matrix of the (m, b, b) ``blocks``;
    for b = 1 the diagonal of the scalars, for b > 1 every entry of
    every block stored, in the order ``sps.block_diag`` stores them
    (the JAX package's ``sps.block_diag(blocks, format="csr")``, without
    its Python loop over the blocks)."""
    m, b, _ = blocks.shape
    if b == 1:
        return sps.diags_array(blocks[:, 0, 0], format="csr")
    i, r, c = np.meshgrid(np.arange(m), np.arange(b), np.arange(b),
                          indexing="ij")
    return sps.coo_matrix(
        (blocks.reshape(-1), ((i * b + r).reshape(-1),
                              (i * b + c).reshape(-1))),
        shape=(m * b, m * b),
    ).asformat("csr")
