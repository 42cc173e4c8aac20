"""Graph coloring for parallel smoothers (reference src/matrix_coloring/).

A copy of the JAX package's ``ops/coloring.py`` (pure numpy on the
host), so both packages give the same colours for the same matrix.
The only changes: :func:`color_matrix` reads the port's host CSR
triple (``SparseMatrix._host``) instead of device arrays,
``print_coloring_info`` prints directly, and :func:`min_max_coloring`
scans in each round only the edges the last round left between
uncoloured vertices (the same colours: without ``weakness_bound`` no
colour is taken back, so no edge rejoins that set).

The reference ships ten coloring schemes (core.cu:669-678) because CUDA
smoother kernels launch one kernel per color; the port's colour sweeps
(``solvers/dilu.py``, ``solvers/gs.py``) take one stage per colour the
same way.  What matters is (a) a valid distance-1 coloring, (b)
determinism, (c) few colors, and (d) for downwind-aware smoothing, a
color order that follows the flow.  Implemented:

  * GREEDY / SERIAL_GREEDY_BFS: deterministic natural-order greedy —
    the determinism_flag path.
  * MULTI_HASH: the reference's multi-hash round scheme
    (multi_hash.cu colorRowsMultiHashKernel — num_hash independent
    hash functions per round, strict-extremum candidates, i%possible
    selection), vectorized.
  * GREEDY_RECOLOR: multi-hash first coloring + iterated
    class-parallel palette shrinking (greedy_recolor.cu recolor pass).
  * MIN_MAX / PARALLEL_GREEDY / ROUND_ROBIN: hash-based
    parallel-style MIS coloring (min_max.cu structure).
  * MIN_MAX_2RING / GREEDY_MIN_MAX_2RING: the same algorithms on the
    distance-2 (squared) graph — same-color rows are then independent
    in A^2, which ILU(1)-class factorizations need.
  * LOCALLY_DOWNWIND: greedy coloring in downwind topological order
    (locally_downwind.cu semantics: the directed graph of dominant
    couplings |a_ij| > |a_ji| orders the sweep along the flow; greedy
    on that order keeps the coloring valid).
  * UNIFORM: index mod (bandwidth+1) — the reference's cheap scheme,
    valid for banded matrices, greedy fallback otherwise.
"""

from __future__ import annotations

import numpy as np

from amgx_tpu_torch.core.printing import emit


def greedy_coloring(indptr, indices, n, order=None) -> np.ndarray:
    """Greedy distance-1 coloring in the given vertex order
    (natural order by default); deterministic."""
    colors = np.full(n, -1, dtype=np.int32)
    seq = range(n) if order is None else order
    for i in seq:
        neigh = indices[indptr[i] : indptr[i + 1]]
        used = set(colors[neigh[neigh < n]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def _two_ring_graph(indptr, indices, n):
    """Pattern of A + A^2 (distance-2 adjacency) as CSR arrays."""
    import scipy.sparse as sps

    # int64 counts: path counts through common neighbors can exceed
    # small-int ranges and a wrapped-to-zero count would silently drop
    # a distance-2 edge
    S = sps.csr_matrix(
        (np.ones(len(indices), dtype=np.int64), indices.copy(),
         indptr.copy()), shape=(n, max(int(indices.max()) + 1, n)),
    )[:, :n]
    S2 = ((S + S @ S) != 0).astype(np.int8).tocsr()
    S2.setdiag(0)
    S2.eliminate_zeros()
    return S2.indptr, S2.indices


def downwind_order(indptr, indices, vals, n) -> np.ndarray:
    """Topological-ish vertex order along the flow: a dominant entry
    |a_ij| > |a_ji| means j is UPSTREAM of i (upwind discretizations
    couple strongly to the upstream neighbor), so i's level exceeds
    j's and upstream vertices are ordered first (cycles broken by the
    bounded fixpoint + index tie-break)."""
    import scipy.sparse as sps

    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    off = indices != row_ids
    r, c, v = row_ids[off], indices[off], np.abs(vals[off])
    Aabs = sps.csr_matrix((v, (r, c)), shape=(n, n))
    At = Aabs.T.tocsr()
    # a dominant |a_ij| > |a_ji| means j is UPSTREAM of i (upwind
    # discretizations couple strongly to the upstream neighbor), so the
    # level propagates from column to row
    coo = Aabs.tocoo()
    back = np.asarray(At[coo.row, coo.col]).ravel()
    down = coo.data > back
    dr, dc = coo.row[down], coo.col[down]
    level = np.zeros(n, dtype=np.int64)
    for _ in range(64):  # bounded fixpoint (cycles cap the sweep)
        new = level.copy()
        np.maximum.at(new, dr, level[dc] + 1)
        if (new == level).all():
            break
        level = new
    return np.lexsort((np.arange(n), level))


def min_max_coloring(indptr, indices, n, max_rounds=64, seed=0,
                     weakness_bound=None,
                     late_rejection=False) -> np.ndarray:
    """Luby-style min-max hash coloring (reference min_max.cu structure):
    in each round, uncolored vertices that are local maxima (by hashed
    weight) among uncolored neighbours take the current color; local
    minima take color+1.  Deterministic for a fixed seed.

    ``weakness_bound`` relaxes the local-max test (reference
    min_max_2ring.cu:194: a vertex counts as max when at most that many
    uncolored neighbours beat its hash), coloring more vertices per
    round at the cost of tentative conflicts; ``late_rejection``
    (min_max_2ring.cu:404) then uncolors the lower-hash side of any
    same-round conflict instead of preventing it up front."""
    rng = np.random.default_rng(seed)
    w = rng.permutation(n).astype(np.int64)
    colors = np.full(n, -1, dtype=np.int32)
    color = 0
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    mask_offdiag = indices != row_ids
    rows = row_ids[mask_offdiag]
    cols = indices[mask_offdiag]
    relaxed = (
        weakness_bound is not None and 0 < weakness_bound < 2 ** 30
    )
    # the edges still between uncolored vertices: without the relaxed
    # test a colour is never taken back, so an edge that leaves this
    # set never returns, and each round scans only the last one's
    r, c = rows, cols
    for _ in range(max_rounds):
        un = colors < 0
        if not un.any():
            break
        # for each uncolored vertex, max/min hashed weight among uncolored
        # neighbours
        if relaxed:
            r, c = rows, cols
        active_edge = un[r] & un[c] & (c < n)
        r, c = r[active_edge], c[active_edge]
        if relaxed:
            gt = np.zeros(n, dtype=np.int64)
            lt = np.zeros(n, dtype=np.int64)
            np.add.at(gt, r, (w[c] > w[r]).astype(np.int64))
            np.add.at(lt, r, (w[c] < w[r]).astype(np.int64))
            is_max = un & (gt <= weakness_bound)
            is_min = un & (lt <= weakness_bound) & ~is_max
        else:
            nb_max = np.full(n, -1, dtype=np.int64)
            nb_min = np.full(n, n + 1, dtype=np.int64)
            np.maximum.at(nb_max, r, w[c])
            np.minimum.at(nb_min, r, w[c])
            is_max = un & (w > nb_max)
            is_min = un & (w < nb_min) & ~is_max
        colors[is_max] = color
        colors[is_min] = color + 1
        if relaxed:
            # the relaxed test can create same-round conflicts: the
            # lower-hash ENDPOINT of each conflicting edge reverts,
            # whichever direction the edge is stored in — nonsymmetric
            # patterns may store only the (hi-hash -> lo-hash)
            # direction, where reverting only ``rows`` would leave an
            # invalid pair colored.  (The reference's two schedules —
            # in-kernel prevention vs late_rejection — collapse to
            # this same fixpoint in vectorized form; late_rejection
            # additionally allows reverting against already-colored
            # neighbours, min_max_2ring.cu:404.)
            hi = color if not late_rejection else 0
            same = (colors[rows] >= hi) & (
                colors[rows] == colors[cols])
            lo_end = np.where(w[rows] < w[cols], rows, cols)
            colors[lo_end[same]] = -1
        color += 2
    # anything left (pathological): greedy-fix
    left = np.nonzero(colors < 0)[0]
    for i in left:
        neigh = indices[indptr[i] : indptr[i + 1]]
        used = set(colors[neigh[neigh < n]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    if relaxed:
        # belt-and-braces for GS/DILU's independent-set contract:
        # greedy-recolor any residual conflict (late_rejection against
        # earlier rounds can strand adjacent same-color pairs)
        colors = _fix_conflict_vertices(colors, rows, cols, w, n)
    return _compact_colors(colors)


def _fix_conflict_vertices(colors, rows, cols, w, n):
    """Greedy-recolor the lower-hash endpoint of every same-colored
    edge until :func:`validate_coloring` would pass.  Neighbourhoods
    are symmetrized (a directed edge constrains both endpoints)."""
    local = cols < n  # halo columns carry no local color
    rows, cols = rows[local], cols[local]
    sym_r = np.concatenate([rows, cols])
    sym_c = np.concatenate([cols, rows])
    order = np.argsort(sym_r, kind="stable")
    sym_r, sym_c = sym_r[order], sym_c[order]
    sym_ptr = np.searchsorted(sym_r, np.arange(n + 1))
    for _ in range(16):
        bad = colors[rows] == colors[cols]
        if not bad.any():
            break
        verts = np.unique(
            np.where(w[rows[bad]] < w[cols[bad]], rows[bad], cols[bad])
        )
        for i in verts:
            neigh = sym_c[sym_ptr[i] : sym_ptr[i + 1]]
            used = set(colors[neigh].tolist())
            c = 0
            while c in used:
                c += 1
            colors[i] = c
    return colors


def _compact_colors(colors):
    uniq = np.unique(colors)
    remap = np.zeros(uniq.max() + 1, dtype=np.int32)
    remap[uniq] = np.arange(uniq.shape[0], dtype=np.int32)
    return remap[colors]


def _mix_hash(a, seed):
    """The reference's integer mix (multi_hash.cu:hash), vectorized on
    uint32 with wraparound."""
    a = (np.asarray(a, dtype=np.uint64) ^ np.uint64(seed)) & np.uint64(
        0xFFFFFFFF
    )

    def u32(x):
        return x & np.uint64(0xFFFFFFFF)

    a = u32(a + np.uint64(0x7ED55D16) + u32(a << np.uint64(12)))
    a = u32((a ^ np.uint64(0xC761C23C)) + (a >> np.uint64(19)))
    a = u32(a + np.uint64(0x165667B1) + u32(a << np.uint64(5)))
    a = u32((a ^ np.uint64(0xD3A2646C)) + u32(a << np.uint64(9)))
    a = u32(a + np.uint64(0xFD7046C5) + u32(a << np.uint64(3)))
    a = u32((a ^ np.uint64(0xB55A4F09)) + (a >> np.uint64(16)))
    return a


def multi_hash_coloring(
    indptr, indices, n, num_hash=8, seed=0, max_rounds=64
) -> np.ndarray:
    """MULTI_HASH coloring (reference multi_hash.cu
    colorRowsMultiHashKernel): each round runs ``num_hash`` independent
    hash functions; a vertex that is a strict local max (min) among
    its uncolored neighbours under hash t may take color
    ``next_color + 2t`` (``+2t+1``), and among its candidate colors it
    picks the ``i % n_candidates``-th — up to 2*num_hash independent
    classes colored per round.  Deterministic."""
    colors = np.full(n, -1, dtype=np.int32)
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    keep = (indices != row_ids) & (indices < n)
    rows, cols = row_ids[keep], indices[keep]
    # hashes for every vertex x hash fn: [n, K] (round-invariant)
    hv = np.stack(
        [
            _mix_hash(np.arange(n), seed + 1043 * int(t))
            for t in range(num_hash)
        ],
        axis=1,
    )
    next_color = 0
    for _ in range(max_rounds):
        un = colors < 0
        if not un.any():
            break
        ae = un[rows] & un[cols]
        r, c = rows[ae], cols[ae]
        # not_max[i,t]: some active neighbour j has h_t(i) <= h_t(j)
        not_max = np.zeros((n, num_hash), dtype=bool)
        not_min = np.zeros((n, num_hash), dtype=bool)
        le = hv[r] <= hv[c]
        ge = hv[r] >= hv[c]
        np.logical_or.at(not_max, r, le)
        np.logical_or.at(not_min, r, ge)
        # candidate slots in reference order: per t, min (2t) then
        # max (2t+1), offset by next_color
        cand = np.zeros((n, 2 * num_hash), dtype=bool)
        cand[:, 0::2] = ~not_min
        cand[:, 1::2] = ~not_max
        cand[~un] = False
        possible = cand.sum(axis=1)
        pick = np.nonzero(un & (possible > 0))[0]
        if len(pick):
            col_id = pick % possible[pick]
            cum = np.cumsum(cand[pick], axis=1)
            slot = np.argmax(
                (cum == (col_id + 1)[:, None]) & cand[pick], axis=1
            )
            colors[pick] = next_color + slot.astype(np.int32)
        next_color += 2 * num_hash
    # anything left (pathological): greedy-fix
    for i in np.nonzero(colors < 0)[0]:
        neigh = indices[indptr[i]: indptr[i + 1]]
        used = set(colors[neigh[neigh < n]].tolist())
        ccc = 0
        while ccc in used:
            ccc += 1
        colors[i] = ccc
    return _compact_colors(colors)


def recolor_min_colors(
    indptr, indices, n, colors, max_passes=4
) -> np.ndarray:
    """Iterated class-parallel recoloring (the palette-shrinking pass
    of reference greedy_recolor.cu): members of one color class are
    mutually non-adjacent, so the whole class simultaneously jumps to
    its smallest neighbour-free color.  Classes are processed from the
    highest color down; freed colors are only reclaimed on the next
    pass (conservative, keeps validity invariant)."""
    colors = np.asarray(colors, dtype=np.int32).copy()
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    keep = (indices != row_ids) & (indices < n)
    rows, cols = row_ids[keep], indices[keep]
    for _ in range(max_passes):
        changed = False
        nc = int(colors.max()) + 1
        if nc <= 1:
            break
        used = np.zeros((n, nc), dtype=bool)
        used[rows, colors[cols]] = True
        for col in range(nc - 1, 0, -1):
            mem = np.nonzero(colors == col)[0]
            if not len(mem):
                continue
            free = ~used[mem]
            free[:, col:] = False  # only strictly smaller colors
            has = free.any(axis=1)
            if not has.any():
                continue
            tgt = mem[has]
            colors[tgt] = np.argmax(free[has], axis=1).astype(np.int32)
            # incremental neighbour update (old colors stay marked —
            # conservative)
            flag = np.zeros(n, dtype=bool)
            flag[tgt] = True
            sel = flag[cols]
            used[rows[sel], colors[cols[sel]]] = True
            changed = True
        if not changed:
            break
    return _compact_colors(colors)


def parallel_greedy_coloring(indptr, indices, n, max_uncolored=0.0,
                             seed=0) -> np.ndarray:
    """PARALLEL_GREEDY (reference parallel_greedy.cu): Jones-Plassmann
    rounds — every uncolored vertex proposes the smallest color unused
    by its colored neighbours, and commits when it is the hashed local
    max among uncolored neighbours.  Stops once the uncolored fraction
    drops below ``max_uncolored_percentage`` (remainder greedy-fixed),
    like the reference's early-exit."""
    w = _mix_hash(np.arange(n), seed).astype(np.int64)
    colors = np.full(n, -1, dtype=np.int32)
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    keep = (indices != row_ids) & (indices < n)
    rows, cols = row_ids[keep], indices[keep]
    for _ in range(4 * 64):
        un = colors < 0
        n_un = int(un.sum())
        if n_un == 0 or n_un <= max_uncolored * n:
            break
        # smallest available color per uncolored vertex
        ncmax = int(colors.max()) + 2 if colors.max() >= 0 else 1
        used = np.zeros((n, ncmax + 1), dtype=bool)
        colored_nb = colors[cols] >= 0
        used[rows[colored_nb], colors[cols[colored_nb]]] = True
        avail = ~used
        proposal = np.argmax(avail, axis=1).astype(np.int32)
        # local max among uncolored neighbours commits
        ae = un[rows] & un[cols]
        nb_max = np.full(n, -1, dtype=np.int64)
        np.maximum.at(nb_max, rows[ae], w[cols[ae]])
        commit = un & (w > nb_max)
        colors[commit] = proposal[commit]
    for i in np.nonzero(colors < 0)[0]:
        neigh = indices[indptr[i]: indptr[i + 1]]
        used = set(colors[neigh[neigh < n]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return _compact_colors(colors)


_SCHEME_ALIASES = {
    "MIN_MAX": "MIN_MAX",
    "MIN_MAX_2RING": "MIN_MAX_2RING",
    "GREEDY_MIN_MAX_2RING": "GREEDY_2RING",
    "PARALLEL_GREEDY": "PARALLEL_GREEDY",
    "ROUND_ROBIN": "ROUND_ROBIN",
    "MULTI_HASH": "MULTI_HASH",
    "UNIFORM": "UNIFORM",
    "SERIAL_GREEDY_BFS": "GREEDY",
    "GREEDY_RECOLOR": "GREEDY_RECOLOR",
    "LOCALLY_DOWNWIND": "LOCALLY_DOWNWIND",
    "GREEDY": "GREEDY",
}

# UNIFORM is only used when the banded period stays this small
_UNIFORM_MAX_COLORS = 64


def color_matrix(A, scheme="MIN_MAX", deterministic=False,
                 cfg=None, scope="default") -> np.ndarray:
    """Color a SparseMatrix (host). Returns int32 colors (n_rows,).

    When ``cfg`` is given, the reference coloring knobs are honored:
    ``coloring_level`` (0 = no coloring, 1 = distance-1, >=2 =
    distance-2 via the two-ring graph, min_max.cu:426-434),
    ``num_colors`` (ROUND_ROBIN modulus, round_robin.cu:29),
    ``max_num_hash`` (MULTI_HASH hash count), ``max_uncolored_percentage``
    (PARALLEL_GREEDY early exit, parallel_greedy.cu:664),
    ``coloring_try_remove_last_colors``/``coloring_custom_arg``
    (GREEDY_RECOLOR shrink passes, greedy_recolor.cu), and
    ``print_coloring_info`` (emit summary)."""
    indptr, indices, host_vals = A._host
    n = A.n_rows
    algo = _SCHEME_ALIASES.get(scheme.upper(), "MIN_MAX")
    g = (lambda k: cfg.get(k, scope)) if cfg is not None else None
    coloring_level = int(g("coloring_level")) if g else 1

    if coloring_level == 0:
        colors = np.zeros(n, dtype=np.int32)
        return _emit_coloring_info(g, scheme, colors, indptr, indices)
    if coloring_level >= 2 and algo not in (
        "MIN_MAX_2RING", "GREEDY_2RING", "LOCALLY_DOWNWIND",
    ):
        # distance-2 coloring: color the two-ring graph.  The 2RING
        # schemes already operate at distance 2; LOCALLY_DOWNWIND
        # needs A's values aligned with the graph, so it stays on the
        # distance-1 pattern.
        indptr, indices = _two_ring_graph(indptr, indices, n)

    if algo in ("MIN_MAX_2RING", "GREEDY_2RING"):
        ip2, ix2 = _two_ring_graph(indptr, indices, n)
        if deterministic or algo == "GREEDY_2RING":
            colors = greedy_coloring(ip2, ix2, n)
        else:
            wb = int(g("weakness_bound")) if g else None
            lr = bool(g("late_rejection")) if g else False
            colors = min_max_coloring(ip2, ix2, n, weakness_bound=wb,
                                      late_rejection=lr)
    elif algo == "LOCALLY_DOWNWIND":
        vals = np.asarray(host_vals)
        if vals.ndim > 1:  # block matrix: use block Frobenius weight
            vals = np.sqrt((np.abs(vals) ** 2).sum(axis=(1, 2)))
        order = downwind_order(indptr, indices, vals, n)
        colors = greedy_coloring(indptr, indices, n, order=order)
    elif algo == "ROUND_ROBIN":
        # reference round_robin.cu:29: literally i % num_colors (no
        # conflict resolution — a calibration scheme, kept faithful)
        k = max(int(g("num_colors")) if g else 10, 1)
        colors = (np.arange(n, dtype=np.int32) % k).astype(np.int32)
        return _emit_coloring_info(g, scheme, colors, indptr, indices)
    elif algo == "PARALLEL_GREEDY":
        frac = float(g("max_uncolored_percentage")) if g else 0.0
        colors = parallel_greedy_coloring(indptr, indices, n,
                                          max_uncolored=frac)
    elif algo == "UNIFORM":
        row_ids = np.repeat(np.arange(n), np.diff(indptr))
        off = indices != row_ids
        if off.any():
            period = int(np.abs(indices[off] - row_ids[off]).max()) + 1
        else:
            period = 1
        if period <= _UNIFORM_MAX_COLORS:
            colors = (np.arange(n, dtype=np.int32) % period).astype(
                np.int32
            )
            return _emit_coloring_info(g, scheme, colors, indptr,
                                       indices)
        colors = greedy_coloring(indptr, indices, n)
    elif algo == "MULTI_HASH":
        nh = max(int(g("max_num_hash")) if g else 8, 1)
        colors = multi_hash_coloring(indptr, indices, n, num_hash=nh)
    elif algo == "GREEDY_RECOLOR":
        # reference greedy_recolor.cu: fast multi-hash first coloring,
        # then iterated class-parallel palette shrinking;
        # coloring_try_remove_last_colors / coloring_custom_arg bound
        # the shrink passes
        first = multi_hash_coloring(indptr, indices, n)
        passes = 4
        if g:
            try_rm = int(g("coloring_try_remove_last_colors"))
            custom = str(g("coloring_custom_arg"))
            if try_rm > 0:
                passes = try_rm
            elif custom.isdigit():
                passes = max(int(custom), 1)
        colors = recolor_min_colors(indptr, indices, n, first,
                                    max_passes=passes)
    elif deterministic or algo == "GREEDY":
        colors = greedy_coloring(indptr, indices, n)
    else:
        colors = min_max_coloring(indptr, indices, n)
    return _emit_coloring_info(g, scheme, colors, indptr, indices)


def _emit_coloring_info(g, scheme, colors, indptr, indices):
    """print_coloring_info (reference matrix_coloring.cu): color count,
    class sizes, validity."""
    if g is not None and bool(g("print_coloring_info")):
        nc = int(colors.max()) + 1
        sizes = np.bincount(colors, minlength=nc)
        ok = validate_coloring(indptr, indices, colors)
        emit(
            f"         Coloring [{scheme}]: {nc} colors over "
            f"{colors.shape[0]} rows; largest class {int(sizes.max())}"
            f", smallest {int(sizes.min())}; valid={ok}"
        )
    return colors


def validate_coloring(indptr, indices, colors) -> bool:
    """True iff no edge joins same-colored distinct vertices (reference
    src/tests/valid_coloring.cu)."""
    n = colors.shape[0]
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    off = indices != row_ids
    ok_range = indices < n
    r, c = row_ids[off & ok_range], indices[off & ok_range]
    return bool(np.all(colors[r] != colors[c]))
