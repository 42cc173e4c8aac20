"""Classical Ruge-Stuben coarsening (reference src/classical/**, 12k LoC):
strength of connection (strength/ahat), PMIS/HMIS C/F selection
(selectors/pmis.cu), direct distance-1 interpolation (interpolators/
distance1.cu) with truncation, Galerkin RAP.

Host-side setup (numpy/scipy) with deterministic hashes (determinism is
structural here — no GPU races, SURVEY §5.2).  Interpolators: D1
(direct), D2 (standard distance-2, sign-restricted redistribution) and
MULTIPASS; selectors PMIS and two-stage aggressive PMIS
(aggressive_levels); unknown names fall back with a warning.

A copy of the JAX package's ``amg/classical.py`` (the same numpy and
scipy code, so both packages build the same levels bit for bit); the
torch counterpart of its device pipeline is ``amg/device_setup.py``.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sps

from amgx_tpu_torch.core.profiling import setup_fastpath_enabled, setup_phase


# ----------------------------------------------------------------------
# vectorized per-row reductions (the cold-setup fast path)
#
# ``np.ufunc.at`` is the single hottest line of classical setup (its
# unbuffered per-element loop runs at Python-adjacent speed); these
# helpers produce BITWISE-identical results through C-speed kernels:
#
#   * sums: ``np.bincount(weights=...)`` accumulates sequentially in
#     element order into an f64 accumulator — the exact operation
#     ``np.add.at`` performs on a zeroed f64 array (asserted by the
#     fast-vs-reference parity suite of the JAX package).
#   * maxima: max is exactly associative (no rounding), so
#     ``np.maximum.reduceat`` row segments equal the sequential
#     ``np.maximum.at`` accumulation for any grouping; casts commute
#     with max (monotone), so reducing in the value dtype and casting
#     the row result equals casting every element first.
#
# AMGX_TPU_TORCH_SETUP_FASTPATH=0 routes back to the ufunc.at reference
# forms.


def _row_sum(row_ids, weights, n):
    """Per-row sums grouped by ``row_ids`` — bitwise-identical to
    ``np.add.at`` on ``np.zeros(n)``."""
    if not setup_fastpath_enabled() or np.iscomplexobj(weights):
        out = np.zeros(
            n, dtype=weights.dtype if np.iscomplexobj(weights) else None
        )
        np.add.at(out, row_ids, weights)
        return out
    return np.bincount(row_ids, weights=weights, minlength=n)


def _row_max(vals, indptr, row_ids, init, out_dtype=None):
    """Per-row maxima over CSR-ordered ``vals`` — bitwise-identical to
    ``np.maximum.at`` on ``np.full(n, init, out_dtype)``.  ``indptr``
    and ``row_ids`` describe the same row grouping (the caller has
    both at hand)."""
    n = indptr.shape[0] - 1
    if out_dtype is None:
        out_dtype = vals.dtype
    if not setup_fastpath_enabled() or vals.shape[0] == 0:
        out = np.full(n, init, dtype=out_dtype)
        np.maximum.at(out, row_ids, vals)
        return out
    # reduceat over NON-EMPTY rows' start offsets only: consecutive
    # non-empty starts bound exactly one row's entries (empty rows
    # contribute none), and every start is < nnz so no segment is ever
    # clamped/truncated — naive indptr[:-1] clamping silently shortens
    # the last non-empty row's segment when trailing rows are empty
    nonempty = np.diff(indptr) > 0
    fill = np.asarray(init, dtype=vals.dtype)[()]
    out = np.full(n, fill, dtype=vals.dtype)
    out[nonempty] = np.maximum.reduceat(
        vals, indptr[:-1][nonempty].astype(np.int64)
    )
    return np.maximum(out, fill).astype(out_dtype, copy=False)


def strength_ahat(Asp: sps.csr_matrix, theta: float, max_row_sum: float,
                  return_flags: bool = False):
    """Strong-connection mask S (csr bool) — AHAT default
    (reference strength/ahat.cu): j strong for i iff
    -a_ij >= theta * max_k(-a_ik); falls back to |a_ij| for rows with no
    negative off-diagonals.  Rows whose row-sum ratio exceeds max_row_sum
    get no strong connections (weakened dependencies, core.cu
    'max_row_sum').

    ``return_flags`` additionally returns the per-A-entry strong mask
    (aligned with ``Asp.data``) so interpolators can skip the
    ``strong_entry_flags`` membership re-derivation."""
    n = Asp.shape[0]
    indptr, indices, data = Asp.indptr, Asp.indices, Asp.data
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    offdiag = indices != row_ids
    neg = np.where(offdiag, -data, 0.0)
    # per-row max of negative off-diagonals
    mneg = _row_max(neg, indptr, row_ids, 0.0, out_dtype=data.dtype)
    mabs = _row_max(
        np.where(offdiag, np.abs(data), 0.0), indptr, row_ids, 0.0,
        out_dtype=data.dtype,
    )
    use_abs = mneg <= 0
    thresh = np.where(use_abs, mabs, mneg) * theta
    val = np.where(use_abs[row_ids], np.abs(data), -data)
    # val > 0 (not thresh > 0) so theta = 0 means "all opposite-sign
    # connections strong" (reference strength_base.cu strict comparison)
    strong = offdiag & (val >= thresh[row_ids]) & (val > 0)

    if max_row_sum < 1.0 + 1e-12:
        diag = Asp.diagonal()
        rs = np.asarray(np.abs(Asp.sum(axis=1))).ravel()
        weak_rows = rs > max_row_sum * np.abs(np.where(diag != 0, diag, 1))
        strong &= ~weak_rows[row_ids]

    # copies: csr_matrix((data, indices, indptr)) shares the arrays, and
    # eliminate_zeros() mutates them in place — must not corrupt Asp.
    # shape is preserved (not forced square): the distributed builder
    # feeds rectangular owned-rows x (owned+halo) local blocks.
    S = sps.csr_matrix(
        (strong.astype(np.int8), indices.copy(), indptr.copy()),
        shape=Asp.shape,
    )
    S.eliminate_zeros()
    if return_flags:
        return S, strong
    return S


def strength_affinity(Asp: sps.csr_matrix, theta: float,
                      n_vectors: int = 4, n_iters: int = 4,
                      seed: int = 29) -> sps.csr_matrix:
    """AFFINITY strength (reference strength/affinity.cu, Livne-Brandt
    LAMG affinity): relax a few random vectors with Jacobi on A x = 0;
    connections whose relaxed values correlate are strong:

        c_ij = |<X_i, X_j>|^2 / (<X_i, X_i> <X_j, X_j>)

    over the affinity_vectors test vectors; j is strong for i when
    c_ij >= theta * max_k c_ik."""
    n = Asp.shape[0]
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n_vectors))
    # L1-Jacobi relaxation: unconditionally convergent for SPD operators
    # (plain damped Jacobi can amplify high-frequency modes when
    # lambda_max(D^-1 A) is large, corrupting the affinities)
    diag = np.abs(Asp.diagonal())
    offsum = np.asarray(abs(Asp).sum(axis=1)).ravel() - diag
    d_l1 = diag + offsum
    dinv = 1.0 / np.where(d_l1 != 0, d_l1, 1.0)
    for _ in range(n_iters):
        X = X - dinv[:, None] * (Asp @ X)
    coo = Asp.tocoo()
    off = coo.row != coo.col
    r, c = coo.row[off], coo.col[off]
    # accumulate per vector: keeps transients at (nnz,) instead of
    # materializing (nnz, n_vectors) gathers
    dot_rc = np.zeros(r.shape[0])
    for k in range(n_vectors):
        dot_rc += X[r, k] * X[c, k]
    num = dot_rc**2
    nrm2 = np.einsum("ik,ik->i", X, X)
    with np.errstate(divide="ignore", invalid="ignore"):
        aff = num / np.maximum(nrm2[r] * nrm2[c], 1e-300)
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, r, aff)
    strong = aff >= theta * np.maximum(rowmax[r], 1e-300)
    S = sps.csr_matrix(
        (strong.astype(np.int8), (r, c)), shape=(n, n)
    )
    S.eliminate_zeros()
    S.sort_indices()
    return S


def strength_all(Asp: sps.csr_matrix, return_flags: bool = False):
    """ALL: every off-diagonal is strong (reference strength ALL)."""
    n = Asp.shape[0]
    S = Asp.copy().tocsr()
    S.setdiag(0)
    S.eliminate_zeros()
    S.data = np.ones_like(S.data, dtype=np.int8)
    if return_flags:
        row_ids = np.repeat(np.arange(n), np.diff(Asp.indptr))
        flags = (Asp.indices != row_ids) & (Asp.data != 0)
        return S, flags
    return S


def strong_entry_flags(Asp: sps.csr_matrix,
                       S: sps.csr_matrix,
                       chunk_rows: int = 2_000_000) -> np.ndarray:
    """Membership flag per A entry: (i, j) in S's pattern.

    A general (row-aligned) membership test: chunked key build +
    chunk-local sort + searchsorted, replacing the old ``np.isin``
    over global int64 keys, whose internal sort peaked at tens of GB
    at 512^3 (the single-host OOM regime).  Workspace is bounded by
    ``chunk_rows`` worth of keys; neither matrix needs sorted
    within-row columns and S's pattern need not be a subset of A's."""
    indptr, indices = Asp.indptr, Asp.indices
    Sp, Si = S.indptr, S.indices
    n = indptr.shape[0] - 1
    ncol = np.int64(Asp.shape[1])
    out = np.zeros(indices.shape[0], dtype=bool)
    for r0 in range(0, n, chunk_rows):
        r1 = min(r0 + chunk_rows, n)
        a0, a1 = int(indptr[r0]), int(indptr[r1])
        s0, s1 = int(Sp[r0]), int(Sp[r1])
        if a1 == a0 or s1 == s0:
            continue
        arow = np.repeat(
            np.arange(r0, r1, dtype=np.int64),
            np.diff(indptr[r0: r1 + 1]).astype(np.int64),
        )
        akey = arow * ncol + indices[a0:a1]
        srow = np.repeat(
            np.arange(r0, r1, dtype=np.int64),
            np.diff(Sp[r0: r1 + 1]).astype(np.int64),
        )
        skey = np.sort(srow * ncol + Si[s0:s1])
        # np.sort: column order within rows is NOT guaranteed sorted
        # (distributed local blocks store owned-first then halo slots);
        # the sort is chunk-local, so workspace stays bounded
        pos = np.searchsorted(skey, akey)
        safe = np.minimum(pos, len(skey) - 1)
        out[a0:a1] = (pos < len(skey)) & (skey[safe] == akey)
    return out


def _hash_weights(n: int, seed: int = 0x9E3779B9) -> np.ndarray:
    """Deterministic pseudo-random tie-break weights in [0,1)."""
    idx = np.arange(n, dtype=np.uint64)
    z = (idx + np.uint64(seed)) * np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(31)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(29)
    return (z % np.uint64(1 << 30)).astype(np.float64) / float(1 << 30)


def pmis_select(S: sps.csr_matrix, seed: int = 0) -> np.ndarray:
    """PMIS C/F splitting (reference selectors/pmis.cu): parallel MIS on
    the symmetrized strength graph with weights = strong-transpose-degree
    + hash.  Returns int8 array: 1 = coarse, 0 = fine.

    Always deterministic: the hash weights are reproducible for a fixed
    seed, so the reference's determinism_flag distinction (deterministic
    vs GPU-race-dependent selection) does not arise here (SURVEY §5.2:
    determinism is structural here)."""
    n = S.shape[0]
    Ssym = ((S + S.T) > 0).astype(np.int8).tocsr()
    lam = np.asarray(S.T.sum(axis=1)).ravel().astype(np.float64)
    # hash weights are deterministic for a fixed seed either way; the
    # seed distinguishes independent selection stages
    rnd = _hash_weights(n, seed=seed)
    w = lam + rnd
    state = np.zeros(n, dtype=np.int8)  # 0 undecided, 1 C, -1 F
    # isolated vertices (no strong links at all) become fine points handled
    # by the interpolator as identity/zero rows
    iso = np.asarray(Ssym.sum(axis=1)).ravel() == 0
    state[iso] = 1  # isolated points must be coarse (nothing to interp from)
    coo = Ssym.tocoo()
    coo_row, coo_col = coo.row, coo.col
    fast = setup_fastpath_enabled()
    for _ in range(200):
        und = state == 0
        if not und.any():
            break
        # local max among undecided neighbours
        wu = np.where(und, w, -1.0)
        act = und[coo_row] & und[coo_col]
        if fast:
            # row-segmented reduceat over -1-filled inactive slots:
            # identical to the maximum.at accumulation (w >= 0, so the
            # -1.0 fill never wins over an active neighbour)
            nbmax = _row_max(
                np.where(act, wu[coo_col], -1.0), Ssym.indptr,
                coo_row, -1.0,
            )
        else:
            nbmax = np.full(n, -1.0)
            np.maximum.at(nbmax, coo_row[act], wu[coo_col[act]])
        new_c = und & (wu > nbmax)
        state[new_c] = 1
        # fine: undecided with a C neighbour
        cnb = (Ssym @ (state == 1).astype(np.int8)) > 0
        state[(state == 0) & cnb] = -1
    state[state == 0] = 1  # leftovers become coarse
    return (state == 1).astype(np.int8)


def rs_select(S: sps.csr_matrix) -> np.ndarray:
    """Classical Ruge-Stüben first-pass C/F splitting (reference
    selectors/rs.cu:315 markCoarseFinePoints_1x1): priority queue on
    the S^T degree measure with dynamic weight updates — pick the
    max-measure point as C, its strong dependents become F, and each
    F point's strong influences gain weight.  Host-side setup (the
    reference runs this on host too and copies back).  Ties break to
    the smallest index (rs.cu compare functor)."""
    import heapq

    n = S.shape[0]
    ST = S.T.tocsr()
    indptr, indices = S.indptr, S.indices
    st_ptr, st_idx = ST.indptr, ST.indices
    w = np.diff(st_ptr).astype(np.int64)  # |S^T_i|
    UNASSIGNED, COARSE, FINE = 0, 1, -1
    cf = np.zeros(n, dtype=np.int8)
    # isolated: no strong outgoing connections -> strong-fine
    iso = np.diff(indptr) == 0
    cf[iso] = FINE
    # zero-measure non-isolated points become F and bump the weights of
    # their strong influences (rs.cu initial pass)
    zero_m = (~iso) & (w == 0)
    for j in np.nonzero(zero_m)[0]:
        cf[j] = FINE
        for k in indices[indptr[j]: indptr[j + 1]]:
            if cf[k] == UNASSIGNED:
                w[k] += 1
    heap = [(-int(w[j]), j) for j in np.nonzero(cf == UNASSIGNED)[0]]
    heapq.heapify(heap)
    while heap:
        neg, i = heapq.heappop(heap)
        if cf[i] != UNASSIGNED or -neg != w[i]:
            continue  # stale entry
        cf[i] = COARSE
        w[i] = 0
        for j in st_idx[st_ptr[i]: st_ptr[i + 1]]:
            if cf[j] != UNASSIGNED:
                continue
            cf[j] = FINE
            for k in indices[indptr[j]: indptr[j + 1]]:
                if cf[k] == UNASSIGNED:
                    w[k] += 1
                    heapq.heappush(heap, (-int(w[k]), k))
    cf[cf == UNASSIGNED] = COARSE
    return (cf == COARSE).astype(np.int8)


def hmis_select(S: sps.csr_matrix) -> np.ndarray:
    """HMIS (reference selectors/hmis.cu): Ruge-Stüben first pass, then
    a PMIS cleanup over any points still undecided.  Single-process RS
    decides every point, so the PMIS stage is the distributed-boundary
    consistency step of the reference — a no-op here, kept for shape."""
    cf = rs_select(S)
    und = cf < 0  # rs_select returns a complete 0/1 split
    if und.any():  # pragma: no cover - defensive
        sub = pmis_select(S)
        cf = np.where(und, sub, cf)
    return cf


def cr_select(
    S: sps.csr_matrix,
    Asp: sps.csr_matrix,
    sweeps: int = 5,
    target_rate: float = 0.7,
    max_rounds: int = 10,
) -> np.ndarray:
    """Compatible-relaxation C/F splitting (reference selectors/cr.cu):
    start all-fine, run damped-Jacobi CR sweeps on the homogeneous
    F-point system, and promote the slowest-converging points to C
    until the CR rate drops below the target."""
    n = Asp.shape[0]
    rng = np.random.default_rng(42)
    cf = np.zeros(n, dtype=np.int8)
    d = Asp.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
    for _ in range(max_rounds):
        fmask = cf == 0
        if not fmask.any():
            break
        e = rng.standard_normal(n)
        e[~fmask] = 0.0
        e /= max(np.linalg.norm(e), 1e-30)
        prev = np.linalg.norm(e)
        rate = 0.0
        for _s in range(sweeps):
            r = -(Asp @ e)
            e = e + 0.7 * dinv * r
            e[~fmask] = 0.0
            cur = np.linalg.norm(e)
            rate = cur / max(prev, 1e-30)
            prev = cur
        if rate <= target_rate:
            break
        # candidates: F points with the largest persistent error
        score = np.abs(e)
        score[~fmask] = -1.0
        k = max(int(0.05 * n), 1)
        cand = np.argpartition(score, -k)[-k:]
        cand = cand[score[cand] > 0]
        if cand.size == 0:
            break
        # independent-set filter so new C points are not S-adjacent
        picked = []
        blocked = np.zeros(n, dtype=bool)
        for i in cand[np.argsort(-score[cand])]:
            if blocked[i]:
                continue
            picked.append(i)
            blocked[S.indices[S.indptr[i]: S.indptr[i + 1]]] = True
        cf[np.array(picked, dtype=np.int64)] = 1
    if not (cf == 1).any():
        return pmis_select(S)  # degenerate fallback
    # cleanup pass: every strongly-connected F point needs a C
    # neighbor or interpolation has nothing to draw from (the RS
    # second-pass invariant)
    Ssym = ((S + S.T) > 0).astype(np.int8).tocsr()
    for i in range(S.shape[0]):
        if cf[i]:
            continue
        nb = Ssym.indices[Ssym.indptr[i]: Ssym.indptr[i + 1]]
        if nb.size and not cf[nb].any():
            cf[i] = 1
    return cf


def aggressive_pmis_select(S: sps.csr_matrix) -> np.ndarray:
    """Two-stage aggressive coarsening (reference selectors
    AGGRESSIVE_PMIS/AGGRESSIVE_HMIS): PMIS on S, then a second PMIS among
    the stage-1 C points on the distance-2 strength graph S + S@S."""
    cf1 = pmis_select(S)
    c_idx = np.nonzero(cf1 == 1)[0]
    if c_idx.size <= 1:
        return cf1
    Sb = S.astype(bool).astype(np.int8)
    S2 = ((Sb + Sb @ Sb) > 0).astype(np.int8).tocsr()
    Sc = S2[c_idx][:, c_idx].tocsr()
    Sc.setdiag(0)
    Sc.eliminate_zeros()
    cf2 = pmis_select(Sc, seed=1)
    cf = np.zeros_like(cf1)
    cf[c_idx[cf2 == 1]] = 1
    return cf


def multipass_interpolation(Asp: sps.csr_matrix, S: sps.csr_matrix,
                            cf: np.ndarray,
                            max_passes: int = 10) -> sps.csr_matrix:
    """Multipass interpolation (reference interpolators/multipass.cu) for
    aggressive coarsening, where F points may lack direct strong C
    neighbours: in pass k, F points with strong *assigned* neighbours
    (C points or previously assigned F points) interpolate through their
    neighbours' interpolation rows:

        P_i = -(1/ã_ii) * sum_{j strong, assigned} a_ij * P_j
        ã_ii = a_ii + sum over non-interpolatory neighbours a_ik
    """
    n = Asp.shape[0]
    nc = int(cf.sum())
    cmap = np.cumsum(cf) - 1
    Sb = S.astype(bool)
    A_strong = Asp.multiply(Sb).tocsr()
    A_strong.setdiag(0.0)
    A_strong.eliminate_zeros()

    assigned = cf == 1
    c_rows = np.nonzero(assigned)[0]
    P = sps.csr_matrix(
        (np.ones(nc), (c_rows, cmap[c_rows])), shape=(n, nc)
    )

    diag = Asp.diagonal().astype(np.float64)
    row_total = np.asarray(Asp.sum(axis=1)).ravel() - diag

    for _ in range(max_passes):
        un = ~assigned
        if not un.any():
            break
        # unassigned rows whose strong-assigned pattern is nonzero
        pat = (abs(A_strong) @ assigned.astype(np.float64)) > 0
        ready = un & pat
        if not ready.any():
            break
        ridx = np.nonzero(ready)[0]
        # work proportional to the newly-ready rows only
        A_r = A_strong[ridx]
        A_sa = (A_r @ sps.diags_array(assigned.astype(np.float64))
                ).tocsr()
        strong_sum = np.asarray(A_sa.sum(axis=1)).ravel()
        atil = diag[ridx] + (row_total[ridx] - strong_sum)
        atil = np.where(atil != 0, atil, 1.0)
        W = sps.diags_array(-1.0 / atil) @ A_sa @ P
        Wcoo = W.tocoo()
        P = (P + sps.csr_matrix(
            (Wcoo.data, (ridx[Wcoo.row], Wcoo.col)), shape=(n, nc)
        )).tocsr()
        assigned = assigned.copy()
        assigned[ridx] = True
    P.sum_duplicates()
    P.sort_indices()
    return P


def direct_interpolation(Asp: sps.csr_matrix, S: sps.csr_matrix,
                         cf: np.ndarray,
                         strong_flag: np.ndarray | None = None,
                         ) -> sps.csr_matrix:
    """Distance-1 direct interpolation (reference interpolators/
    distance1.cu; hypre-style sign-split weights):

      C point i: P[i, cmap[i]] = 1
      F point i: P[i, cmap[j]] = -alpha(beta) * a_ij / a~_ii over strong C
                 neighbours j, with alpha = sum(neg a_i*)/sum(neg a_iC),
                 beta for positive entries; positive sums fold into the
                 diagonal when no positive C-connection exists.
    """
    n = Asp.shape[0]
    cmap = np.cumsum(cf) - 1  # coarse index for C points
    nc = int(cf.sum())
    indptr, indices, data = Asp.indptr, Asp.indices, Asp.data
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    offd = indices != row_ids

    # strong flag per A entry: membership of (i,j) in S's sparsity —
    # handed in by the strength stage when it knows them (AHAT/ALL),
    # else re-derived by the chunked searchsorted membership test
    if strong_flag is None:
        strong_flag = strong_entry_flags(Asp, S)

    is_C_col = cf[indices] == 1
    neg = data < 0
    pos = offd & (data > 0)

    sum_neg = _row_sum(row_ids, np.where(offd & neg, data, 0.0), n)
    sum_pos = _row_sum(row_ids, np.where(pos, data, 0.0), n)
    strongC = strong_flag & is_C_col
    sum_negC = _row_sum(row_ids, np.where(strongC & neg, data, 0.0), n)
    sum_posC = _row_sum(row_ids, np.where(strongC & pos, data, 0.0), n)

    diag = Asp.diagonal().astype(np.float64).copy()
    no_posC = sum_posC == 0
    diag = diag + np.where(no_posC, sum_pos, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(sum_negC != 0, sum_neg / sum_negC, 0.0)
        beta = np.where(sum_posC != 0, sum_pos / sum_posC, 0.0)
    diag = np.where(diag != 0, diag, 1.0)

    keep = strongC & (cf[row_ids] == 0)
    coef = np.where(data < 0, alpha[row_ids], beta[row_ids])
    pvals = -coef * data / diag[row_ids]
    rows_f = row_ids[keep]
    cols_f = cmap[indices[keep]]
    vals_f = pvals[keep]

    rows_c = np.nonzero(cf == 1)[0]
    cols_c = cmap[rows_c]
    vals_c = np.ones(rows_c.shape[0])

    P = sps.csr_matrix(
        (
            np.concatenate([vals_f, vals_c]),
            (
                np.concatenate([rows_f, rows_c]),
                np.concatenate([cols_f, cols_c]),
            ),
        ),
        shape=(n, nc),
    )
    P.sum_duplicates()
    P.sort_indices()
    return P


def standard_interpolation(Asp: sps.csr_matrix, S: sps.csr_matrix,
                           cf: np.ndarray) -> sps.csr_matrix:
    """Distance-2 'standard' interpolation (reference interpolators/
    distance2.cu; hypre BoomerAMG standard-interpolation formulation,
    M-matrix form):

      F point i, interpolatory set C_i^ext = C_i ∪ (∪_{k in F_i^s} C_k):
        w_ij = -( a_ij 1[j in C_i] +
                  sum_{k in F_i^s} a_ik * a_kj / d_ik ) / ã_ii
        d_ik = sum_{l in C_i^ext} a_kl      (redistribution denominator)
        ã_ii = a_ii + sum over weak neighbours a_ik
               + a_ik for F-strong k with d_ik = 0 (undistributable)

    Vectorized in sparse matrix algebra: the pair-dependent denominators
    d_ik are entries of (A_FC_ext @ T^T) sampled on the S_FF pattern.
    """
    n = Asp.shape[0]
    fmask = cf == 0
    cmask = cf == 1
    nc = int(cmask.sum())
    cmap = np.cumsum(cf) - 1

    fidx = np.nonzero(fmask)[0]
    nf = fidx.shape[0]
    if nf == 0:
        return sps.eye_array(n, format="csr")[:, cmask].tocsr()

    # strong pattern restricted to A's values
    Sb = S.astype(bool)
    A_strong = Asp.multiply(Sb).tocsr()

    # selector matrices
    If = sps.csr_matrix(
        (np.ones(nf), (np.arange(nf), fidx)), shape=(nf, n)
    )
    cidx = np.nonzero(cmask)[0]
    Ic = sps.csr_matrix(
        (np.ones(nc), (cidx, np.arange(nc))), shape=(n, nc)
    )

    AsFC = (If @ A_strong @ Ic).tocsr()          # strong F->C values
    AsFF = (If @ A_strong @ If.T).tocsr()        # strong F->F values
    AsFF.setdiag(0.0)
    AsFF.eliminate_zeros()
    A_FC = (If @ Asp @ Ic).tocsr()               # all F->C values

    # extended pattern T (binary): C_i ∪ C(F_i^s)
    SFCb = (AsFC != 0).astype(np.float64)
    SFFb = (AsFF != 0).astype(np.float64)
    T = ((SFCb + SFFb @ SFCb) != 0).astype(np.float64).tocsr()

    # redistribution uses only entries opposite in sign to the row's
    # diagonal (hypre-style sign restriction): positive off-diagonals in
    # coarse Galerkin operators otherwise produce wrong-signed weights
    # and non-convergent coarse smoothers
    diag_all = Asp.diagonal()
    fc = A_FC.tocoo()
    keep_neg = fc.data * diag_all[fidx][fc.row] < 0
    A_FC_neg = sps.csr_matrix(
        (np.where(keep_neg, fc.data, 0.0), (fc.row, fc.col)),
        shape=A_FC.shape,
    )
    A_FC_neg.eliminate_zeros()

    # denominators d_ik on the S_FF pattern: row k of A_FC_neg dotted
    # with T row i  ->  sample E = (A_FC_neg @ T^T)^T at S_FF entries
    E = (T @ A_FC_neg.T).tocsr()                 # E[i,k] = d_ik
    D = SFFb.multiply(E).tocsr()                 # masked to F_i^s edges

    sff = AsFF.tocoo()
    if sff.nnz:
        # align D entries with AsFF entries via fancy-index lookup
        Dcsr = D.tocsr()
        d_vals = np.asarray(Dcsr[sff.row, sff.col]).ravel()
        with np.errstate(divide="ignore", invalid="ignore"):
            b_vals = np.where(d_vals != 0, sff.data / d_vals, 0.0)
        B = sps.csr_matrix((b_vals, (sff.row, sff.col)), shape=(nf, nf))
    else:
        # no strong F-F links (e.g. after aggressive first stage)
        d_vals = np.zeros(0)
        B = sps.csr_matrix((nf, nf))

    # numerator: (A^s_FC + B @ A_FC_neg) masked to the extended pattern
    Wnum = (AsFC + B @ A_FC_neg).multiply(T).tocsr()

    # modified diagonal: a_ii + weak row sum + undistributable strong F
    diag = Asp.diagonal()[fidx]
    row_total = np.asarray(Asp.sum(axis=1)).ravel()[fidx] - Asp.diagonal()[
        fidx
    ]
    strong_sum = np.asarray(AsFC.sum(axis=1)).ravel() + np.asarray(
        AsFF.sum(axis=1)
    ).ravel()
    weak_sum = row_total - strong_sum
    undistributable = np.asarray(
        sps.csr_matrix(
            (np.where(d_vals == 0, sff.data, 0.0), (sff.row, sff.col)),
            shape=(nf, nf),
        ).sum(axis=1)
    ).ravel()
    atil = diag + weak_sum + undistributable
    atil = np.where(atil != 0, atil, 1.0)

    # scale rows of Wnum by -1/atil
    Wnum = sps.diags_array(-1.0 / atil) @ Wnum

    # assemble P: C rows identity, F rows = Wnum
    Wcoo = Wnum.tocoo()
    rows = np.concatenate([fidx[Wcoo.row], cidx])
    cols = np.concatenate([Wcoo.col, cmap[cidx]])
    vals = np.concatenate([Wcoo.data, np.ones(nc)])
    P = sps.csr_matrix((vals, (rows, cols)), shape=(n, nc))
    P.sum_duplicates()
    P.sort_indices()
    return P


def truncate_interp(P: sps.csr_matrix, trunc_factor: float,
                    max_elements: int) -> sps.csr_matrix:
    """Interpolation truncation (reference truncate.cu + interp_max_elements):
    drop entries below trunc_factor*max|row| and/or keep the max_elements
    largest per row; surviving entries are rescaled to preserve row sums."""
    if (trunc_factor >= 1.0 and max_elements < 0) or P.nnz == 0:
        return P
    P = P.tocsr()
    n = P.shape[0]
    indptr, indices, data = P.indptr, P.indices, P.data
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    absd = np.abs(data)
    keep = np.ones(len(data), dtype=bool)
    if trunc_factor < 1.0:
        rmax = _row_max(absd, indptr, row_ids, 0.0,
                        out_dtype=np.float64)
        keep &= absd >= trunc_factor * rmax[row_ids]
    if max_elements >= 0:
        # rank within row by descending magnitude (stable, deterministic)
        order = np.lexsort((np.arange(len(data)), -absd, row_ids))
        counts = np.diff(indptr)
        rank = np.empty(len(data), dtype=np.int64)
        rank[order] = np.arange(len(data)) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        keep &= rank < max_elements
    rs_old = _row_sum(row_ids, data, n)
    rs_new = _row_sum(row_ids, np.where(keep, data, 0.0), n)
    scale = np.where(rs_new != 0, rs_old / np.where(rs_new != 0, rs_new, 1),
                     1.0)
    newdata = data * keep * scale[row_ids]
    # copied arrays: eliminate_zeros mutates them and must not corrupt P
    Pt = sps.csr_matrix(
        (newdata, indices.copy(), indptr.copy()), shape=P.shape
    )
    Pt.eliminate_zeros()
    Pt.sort_indices()
    return Pt


def build_classical_level(Asp, cfg, scope, level_id: int = 0):
    """One classical level: S -> C/F -> P -> R=P^T -> RAP (reference
    classical_amg_level.cu:213-489).  Levels below ``aggressive_levels``
    use two-stage aggressive coarsening with the aggressive interpolator
    (MULTIPASS default), reference amg_level setup."""
    theta = float(cfg.get("strength_threshold", scope))
    max_row_sum = float(cfg.get("max_row_sum", scope))
    strength = str(cfg.get("strength", scope)).upper()
    selector = str(cfg.get("selector", scope)).upper()
    interp = str(cfg.get("interpolator", scope)).upper()
    trunc = float(cfg.get("interp_truncation_factor", scope))
    max_el = int(cfg.get("interp_max_elements", scope))
    aggressive_levels = int(cfg.get("aggressive_levels", scope))
    aggressive_interp = str(
        cfg.get("aggressive_interpolator", scope)
    ).upper()

    # per-A-entry strong flags ride along from the strength stage when
    # it knows them (fast path: saves the D1 interpolator's membership
    # re-derivation, a full extra pass over A's pattern)
    strong_flag = None
    fast = setup_fastpath_enabled()
    with setup_phase("strength"):
        if strength == "ALL":
            if fast:
                S, strong_flag = strength_all(Asp, return_flags=True)
            else:
                S = strength_all(Asp)
        elif strength == "AFFINITY":
            S = strength_affinity(
                Asp,
                theta,
                n_vectors=int(cfg.get("affinity_vectors", scope)),
                n_iters=int(cfg.get("affinity_iterations", scope)),
            )
        else:  # AHAT default
            if fast:
                S, strong_flag = strength_ahat(
                    Asp, theta, max_row_sum, return_flags=True
                )
            else:
                S = strength_ahat(Asp, theta, max_row_sum)

    aggressive = (
        level_id < aggressive_levels
        or selector in ("AGGRESSIVE_PMIS", "AGGRESSIVE_HMIS")
    )
    if selector not in ("PMIS", "HMIS", "AGGRESSIVE_PMIS",
                        "AGGRESSIVE_HMIS", "RS", "CR", "DUMMY"):
        warnings.warn(f"selector {selector}: using PMIS")
    if aggressive:
        with setup_phase("cf_split"):
            cf = aggressive_pmis_select(S)
        if aggressive_interp != "MULTIPASS":
            warnings.warn(
                f"aggressive interpolator {aggressive_interp}: "
                "using MULTIPASS"
            )
        with setup_phase("interp"):
            P = multipass_interpolation(Asp, S, cf)
    else:
        with setup_phase("cf_split"):
            if selector in ("RS",):
                cf = rs_select(S)
            elif selector == "HMIS":
                cf = hmis_select(S)
            elif selector == "CR":
                cf = cr_select(S, Asp)
            else:
                cf = pmis_select(S)
        with setup_phase("interp"):
            if interp == "D1":
                P = direct_interpolation(Asp, S, cf,
                                         strong_flag=strong_flag)
            elif interp in ("D2", "STD", "STANDARD"):
                P = standard_interpolation(Asp, S, cf)
            elif interp == "MULTIPASS":
                # reference multipass.cu works with any selector (F
                # points may lack direct strong C neighbours)
                P = multipass_interpolation(Asp, S, cf)
            else:
                warnings.warn(
                    f"interpolator {interp} not yet implemented; "
                    "using D2 standard"
                )
                P = standard_interpolation(Asp, S, cf)
    with setup_phase("interp"):
        P = truncate_interp(P, trunc, max_el)
    with setup_phase("rap_execute"):
        R = P.T.tocsr()
        Ac = (R @ Asp @ P).tocsr()
        Ac.sum_duplicates()
    if int(cfg.get("structure_reuse_levels", scope)) != 0:
        # structure reuse needs the FULL structural Galerkin pattern
        # stored: scipy's value matmul prunes numerically-cancelled
        # entries, and a pruned Ac cannot hold the slot when future
        # coefficient sets make it nonzero (plan_rap would correctly
        # refuse and resetup would silently fall back to full
        # re-coarsening).  Union with the binary-product pattern
        # (explicit zeros) — only paid when reuse is requested.
        ones = np.ones
        Rb = sps.csr_matrix(
            (ones(R.nnz), R.indices, R.indptr), shape=R.shape)
        Ab = sps.csr_matrix(
            (ones(Asp.nnz), Asp.indices, Asp.indptr), shape=Asp.shape)
        Pb = sps.csr_matrix(
            (ones(P.nnz), P.indices, P.indptr), shape=P.shape)
        pat = (Rb @ Ab @ Pb).tocsr()
        pat.sort_indices()
        # fill the structural pattern with the computed values
        # explicitly (scipy's + would re-prune the zero slots): locate
        # each value entry's slot in the superset pattern
        Ac.sort_indices()
        nc2 = np.int64(pat.shape[1]) + 1
        pkey = (np.repeat(np.arange(pat.shape[0], dtype=np.int64),
                          np.diff(pat.indptr)) * nc2
                + pat.indices)
        vkey = (np.repeat(np.arange(Ac.shape[0], dtype=np.int64),
                          np.diff(Ac.indptr)) * nc2
                + Ac.indices)
        pos = np.searchsorted(pkey, vkey)
        data = np.zeros(pat.nnz, dtype=Ac.data.dtype)
        data[pos] = Ac.data
        Ac = sps.csr_matrix(
            (data, pat.indices.copy(), pat.indptr.copy()),
            shape=pat.shape,
        )
    Ac.sort_indices()
    return P, R, Ac
