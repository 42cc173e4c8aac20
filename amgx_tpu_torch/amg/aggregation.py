"""Aggregation-AMG coarsening (reference src/aggregation/**).

Host-side numpy/scipy, copied from the JAX package's
``amg/aggregation.py`` so both packages build the same aggregates and
the same Galerkin operators, with its two large-grid stages on the
solver's device as torch operations:

  * the structured path (the default, ``structured_aggregation=1``):
    a matrix whose diagonals form a <=27-point stencil on an inferred
    (nx, ny, nz) grid is aggregated in lexicographic blocks
    (:func:`geo_aggregate`), which keeps every coarse operator a
    stencil (DIA) and numbers coarse unknowns lexicographically, so the
    transfer operators P and R have column locality;
  * the matching path (SIZE_2/4/8, MULTI_PAIRWISE): deterministic
    pairwise matching (:func:`pairwise_match`), whose handshake rounds
    run on the device (:func:`pairwise_match_device`, the same
    aggregates bit for bit) for graphs of at least
    ``_DEVICE_MATCH_MIN_ROWS`` rows and at most
    ``_DEVICE_ROUNDS_MAX_WIDTH`` neighbours a row when the solver is on
    the card (``AMGX_TPU_TORCH_DEVICE_MATCH`` overrides: ``0`` never,
    anything else also on CPU tensors), the edges' preference ranks
    sorted on the device too;
  * the Galerkin product: for geometric aggregates above
    ``_GEO_RAP_MIN_ROWS`` rows, windowed sums of the DIA diagonals on
    the device (:func:`geo_galerkin_dia`), which never forms the ``A P``
    intermediate; else ``R @ A @ P`` with scipy.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sps
import torch

from amgx_tpu_torch.core.printing import emit
from amgx_tpu_torch.core.profiling import count_setup_sync, setup_phase

def edge_weights(Asp: sps.csr_matrix, formula: int = 0) -> sps.csr_matrix:
    """Symmetric positive weight graph (zero diagonal)."""
    n = Asp.shape[0]
    absA = abs(Asp)
    d = np.abs(Asp.diagonal())
    d = np.where(d > 0, d, 1.0)
    if formula == 1:
        # w_ij = -0.5*(a_ij/a_ii + a_ji/a_jj)
        Dinv = sps.diags_array(1.0 / np.where(Asp.diagonal() != 0,
                                              Asp.diagonal(), 1.0))
        W = -(Dinv @ Asp + (Dinv @ Asp).T) * 0.5
        W = W.tocsr()
        W.data = np.maximum(W.data, 0.0)
    else:
        S = (absA + absA.T) * 0.5
        # divide each w_ij by max(d_i, d_j): do it entrywise
        S = S.tocoo()
        denom = np.maximum(d[S.row], d[S.col])
        W = sps.csr_matrix(
            (S.data / denom, (S.row, S.col)), shape=(n, n)
        )
    W.setdiag(0.0)
    W.eliminate_zeros()
    W.sort_indices()
    return W



def _first_per_row(rows_sorted, n):
    """Index of the first occurrence of each row id in a row-sorted
    array; -1 for absent rows (boundary positions of the sorted ids)."""
    first = np.full(n, -1, dtype=np.int64)
    if rows_sorted.shape[0]:
        mask = np.empty(rows_sorted.shape[0], dtype=bool)
        mask[0] = True
        np.not_equal(rows_sorted[1:], rows_sorted[:-1], out=mask[1:])
        idx = np.nonzero(mask)[0]
        first[rows_sorted[idx]] = idx
    return first


def pairwise_match(W: sps.csr_matrix, merge_singletons: bool = True,
                   max_rounds: int = 15,
                   max_unassigned: float = 0.0):
    """Deterministic pairwise matching via mutual-strongest-neighbour
    rounds (the handshaking scheme of the reference's size2 selector,
    fully vectorized; max_rounds mirrors max_matching_iterations and
    ``max_unassigned`` the max_unassigned_percentage early exit,
    size2_selector.cu:621-625).

    Returns agg (n,) int32 aggregate ids 0..n_agg-1.
    """
    n = W.shape[0]
    coo = W.tocoo()
    r, c, w = coo.row, coo.col, coo.data
    # per-row preference: heavy edges first; ties broken by a symmetric
    # per-edge hash (deterministic).  Without it, uniform-weight graphs
    # (Poisson) deadlock the handshake into chains — the reference breaks
    # ties with random edge weights for the same reason.
    jitter = _edge_jitter(r, c, n)
    order = np.lexsort((jitter, -w, r))
    rs, cs = r[order], c[order]

    partner = np.full(n, -1, dtype=np.int64)
    for _ in range(max_rounds):
        un = partner == -1
        if max_unassigned > 0 and un.mean() <= max_unassigned:
            break  # remaining rows join as merged singletons
        valid = un[rs] & un[cs]
        first = _first_per_row(rs[valid], n)
        # strongest available neighbour per unmatched vertex
        cand = np.full(n, -1, dtype=np.int64)
        has = first >= 0
        cand[has] = cs[valid][first[has]]
        # mutual handshake
        ok = (cand >= 0) & un
        idx = np.nonzero(ok)[0]
        mutual = idx[cand[cand[idx]] == idx]
        a = mutual[mutual < cand[mutual]]
        partner[a] = cand[a]
        partner[cand[a]] = a
        if a.size == 0:
            break

    # aggregate ids: pair root = min(i, partner); singletons own id
    root = np.where(partner >= 0, np.minimum(np.arange(n), partner),
                    np.arange(n))
    uniq, agg = np.unique(root, return_inverse=True)

    if merge_singletons:
        sizes = np.bincount(agg)
        is_single = sizes[agg] == 1
        if is_single.any():
            # strongest neighbour regardless of matching state
            first_all = _first_per_row(rs, n)
            best = np.full(n, -1, dtype=np.int64)
            hasn = first_all >= 0
            best[hasn] = cs[first_all[hasn]]
            move = is_single & (best >= 0)
            agg = agg.copy()
            agg[move] = agg[best[move]]
            uniq2, agg = np.unique(agg, return_inverse=True)
    return agg.astype(np.int32)


_DEVICE_MATCH_MAX_WIDTH = 32  # the JAX package's gate for its ELL matcher
# the torch rounds' gate: wider than the JAX package's, so that the
# Galerkin levels of a block system's scalar expansion (30-60
# neighbours a row) match on the card too
_DEVICE_ROUNDS_MAX_WIDTH = 128
_DEVICE_MATCH_MIN_ROWS = 16384  # below this, host numpy rounds win


def _device_matching_wanted(device) -> bool:
    """Whether the handshake rounds run on the device: on the card,
    not on the CPU, whose numpy rounds cost less than torch operations
    on the same cores (the JAX package's backend gate).
    ``AMGX_TPU_TORCH_DEVICE_MATCH`` overrides (``0`` disables, anything
    else enables, on CPU tensors too: how the tests drive the torch
    rounds)."""
    env = os.environ.get("AMGX_TPU_TORCH_DEVICE_MATCH")
    if env is not None:
        return env != "0"
    return device is not None and torch.device(device).type == "cuda"


def _edge_jitter(r, c, n):
    """Symmetric per-edge tie-break hash — the ONE definition both the
    host and device matchers key on (bit-parity contract).  Host numpy,
    also for the device matcher, which sees only the ranks it orders."""
    lo = np.minimum(r, c).astype(np.uint64)
    hi = np.maximum(r, c).astype(np.uint64)
    z = lo * np.uint64(n) + hi + np.uint64(0x9E3779B9)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return (z ^ (z >> np.uint64(31))).astype(np.float64)


def _match_ell_arrays(W: sps.csr_matrix, max_width=_DEVICE_MATCH_MAX_WIDTH,
                      device=None):
    """CSR -> padded ELL (cols, preference ranks) for the device
    matcher, or None when the row degree exceeds ``max_width``.

    Every edge gets its position in the (weight desc, jitter asc) order
    the host matcher sorts by, as an int32: the device rounds compare
    integers, so their picks are the host matcher's at any device
    precision.  Padding slots hold column n and rank INT32_MAX.  With
    ``device`` (as :func:`pairwise_match_device` calls it): int32
    tensors on ``device``, the order taken by two stable sorts there
    (jitter, then weight: ``np.lexsort``'s order, ties by position).
    Without it: host numpy arrays ranked by ``np.lexsort``, the JAX
    package's arrays, which the tests hold both the device ranks and
    the JAX package's to."""
    n = W.shape[0]
    lens = np.diff(W.indptr)
    w = int(lens.max()) if lens.size else 0
    if w == 0 or w > max_width:
        return None
    if len(W.indices) > np.iinfo(np.int32).max:
        # int32 ranks would wrap; the host matcher takes giant graphs
        return None
    r = np.repeat(np.arange(n, dtype=np.int64), lens)
    c = W.indices.astype(np.int64)
    jitter = _edge_jitter(r, c, n)
    cols = np.full((n, w), n, dtype=np.int32)
    pos = np.arange(len(c)) - W.indptr[r].astype(np.int64)
    cols[r, pos] = c
    imax = np.iinfo(np.int32).max
    if device is None:
        order = np.lexsort((jitter, -W.data))
        rank = np.empty(len(c), dtype=np.int32)
        rank[order] = np.arange(len(c), dtype=np.int32)
        ranks = np.full((n, w), imax, dtype=np.int32)
        ranks[r, pos] = rank
        return cols, ranks
    # + 0.0: -0.0 becomes +0.0, which a radix sort would otherwise
    # order apart from it, where np.lexsort sees a tie
    _, by_jitter = torch.sort(torch.from_numpy(jitter).to(device),
                              stable=True)
    key = torch.from_numpy(-W.data + 0.0).to(device)
    _, by_weight = torch.sort(key[by_jitter], stable=True)
    order = by_jitter[by_weight]
    rank = torch.empty(len(c), dtype=torch.int32, device=device)
    rank[order] = torch.arange(len(c), dtype=torch.int32, device=device)
    ranks = torch.full((n * w,), imax, dtype=torch.int32, device=device)
    ranks[torch.from_numpy(r * w + pos).to(device)] = rank
    return torch.from_numpy(cols).to(device), ranks.reshape(n, w)


def _device_match_rounds(cols, ranks, max_rounds):
    """Mutual-strongest-neighbour handshake rounds as torch operations
    on the tensors' device (the JAX package's ``_device_match_rounds``;
    reference size2_selector.cu).  A vertex picks the available
    neighbour of least rank (integer compares: the host matcher's
    pick); mutual picks pair up.  The JAX ``while_loop`` is a loop that
    reads the round's "any new pair" flag once (counted as a setup
    sync) and stops after a round that pairs none, or after
    ``max_rounds``.  Returns (partner, best_all): int64 tensors, -1
    where none."""
    n, w = cols.shape
    dev = cols.device
    iota = torch.arange(n, device=dev)
    rmax = torch.iinfo(torch.int32).max
    idx = cols.long()
    spill = torch.zeros(1, dtype=torch.bool, device=dev)
    none = torch.full((1,), -1, dtype=torch.int64, device=dev)

    def best_neighbour(valid):
        # ranks are distinct per edge: the least is unique, unless none
        # is valid (all rmax)
        rv = torch.where(valid, ranks, rmax)
        br, k = torch.min(rv, dim=1)
        bc = torch.gather(idx, 1, k.unsqueeze(1)).squeeze(1)
        return torch.where(br < rmax, bc, -1)

    best_all = best_neighbour(torch.ones_like(cols, dtype=torch.bool))
    partner = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for _ in range(max_rounds):
        un_ext = torch.cat([partner < 0, spill])
        valid = un_ext[idx] & un_ext[:n].unsqueeze(1)
        cand = best_neighbour(valid)
        ci = torch.where(cand >= 0, cand, n)
        mutual = (cand >= 0) & (torch.cat([cand, none])[ci] == iota)
        a = mutual & (iota < cand)
        # the b side of each new pair: a row's partner written at
        # partner[cand]; rows of no new pair write to the spill slot n
        pext = torch.cat([partner, none])
        pext[torch.where(a, cand, n)] = torch.where(a, iota, -1)
        partner = torch.where(a, cand, pext[:n])
        count_setup_sync()
        if not bool(a.any()):
            break
    return partner, best_all


def pairwise_match_device(W: sps.csr_matrix, merge_singletons: bool = True,
                          max_rounds: int = 15, device="cuda"):
    """:func:`pairwise_match` with the handshake rounds on ``device``
    (:func:`_device_match_rounds`): the same aggregates bit for bit,
    the selection keys being the same.  A graph of rows wider than
    ``_DEVICE_ROUNDS_MAX_WIDTH`` takes the host matcher."""
    ell = _match_ell_arrays(W, _DEVICE_ROUNDS_MAX_WIDTH, device=device)
    if ell is None:
        return pairwise_match(W, merge_singletons, max_rounds)
    cols, ranks = ell
    partner, best_all = _device_match_rounds(cols, ranks, max_rounds)
    count_setup_sync()
    partner = partner.cpu().numpy()
    best_all = best_all.cpu().numpy()
    n = W.shape[0]
    root = np.where(
        partner >= 0, np.minimum(np.arange(n), partner), np.arange(n)
    )
    uniq, agg = np.unique(root, return_inverse=True)
    if merge_singletons:
        sizes = np.bincount(agg)
        is_single = sizes[agg] == 1
        if is_single.any():
            move = is_single & (best_all >= 0)
            agg = agg.copy()
            agg[move] = agg[best_all[move]]
            uniq2, agg = np.unique(agg, return_inverse=True)
    return agg.astype(np.int32)

def filter_edge_weights(W: sps.csr_matrix,
                        alpha: float) -> sps.csr_matrix:
    """Weak-edge filter (reference multi_pairwise.cu:931-945,
    filter_weights=1): drop edges with w_ij < alpha * max_k w_ik
    (symmetrized so the graph stays matchable both ways)."""
    coo = W.tocoo()
    rmax = np.zeros(W.shape[0])
    np.maximum.at(rmax, coo.row, coo.data)
    keep = (coo.data >= alpha * rmax[coo.row]) | (
        coo.data >= alpha * rmax[coo.col]
    )
    Wf = sps.csr_matrix(
        (np.where(keep, coo.data, 0.0), (coo.row, coo.col)),
        shape=W.shape,
    )
    Wf.eliminate_zeros()
    Wf.sort_indices()
    return Wf


def aggregate(Asp: sps.csr_matrix, passes: int, formula: int = 0,
              merge_singletons: bool = True, max_rounds: int = 15,
              filter_alpha: float = 0.0,
              serial_matching: bool = False,
              max_unassigned: float = 0.0, device=None) -> np.ndarray:
    """Compose `passes` pairwise matchings -> aggregates of size ~2^passes
    (reference SIZE_2=1, SIZE_4=2, SIZE_8=3 passes).  ``max_rounds``
    mirrors max_matching_iterations (size2_selector.cu:621);
    ``filter_alpha`` > 0 applies the filter_weights weak-edge filter;
    ``serial_matching`` keeps every pass on the host matcher
    (multi_pairwise.cu serial_matching).  A pass over a graph of at
    least ``_DEVICE_MATCH_MIN_ROWS`` rows matches on ``device`` where
    :func:`_device_matching_wanted` says so."""
    n = Asp.shape[0]
    agg = np.arange(n, dtype=np.int32)
    W = edge_weights(Asp, formula)
    if filter_alpha > 0:
        W = filter_edge_weights(W, filter_alpha)
    for p in range(passes):
        if (not serial_matching and max_unassigned <= 0
                and W.shape[0] >= _DEVICE_MATCH_MIN_ROWS
                and _device_matching_wanted(device)):
            sub = pairwise_match_device(
                W, merge_singletons, max_rounds=max_rounds,
                device="cpu" if device is None else device)
        else:
            sub = pairwise_match(W, merge_singletons,
                                 max_rounds=max_rounds,
                                 max_unassigned=max_unassigned)
        agg = sub[agg]
        if p + 1 < passes:
            nc = int(sub.max()) + 1
            Pb = sps.csr_matrix(
                (np.ones(W.shape[0]), (np.arange(W.shape[0]), sub)),
                shape=(W.shape[0], nc),
            )
            W = (Pb.T @ W @ Pb).tocsr()
            W.setdiag(0.0)
            W.eliminate_zeros()
    return agg

SELECTOR_PASSES = {
    "SIZE_2": 1,
    "SIZE_4": 2,
    "SIZE_8": 3,
    "MULTI_PAIRWISE": None,  # uses aggregation_passes config
    "DUMMY": 1,
    "GEO": 3,
}


def _col_diffs(Asp: sps.csr_matrix, dtype=np.int64):
    """col - row per stored entry, straight from CSR (no COO copy —
    this runs on every level of every setup).  ``dtype`` may be int32
    when both dimensions fit (the offset-scan unique sorts ~2x faster
    there) — entry ORDER is the contract axis_strengths relies on."""
    rows = np.repeat(
        np.arange(Asp.shape[0], dtype=dtype), np.diff(Asp.indptr)
    )
    return Asp.indices.astype(dtype, copy=False) - rows


def stencil_offsets(Asp: sps.csr_matrix, max_diags: int = 64,
                    return_diffs: bool = False):
    """Distinct diagonal offsets of A if there are few, else None.

    Short-circuits on a row sample first: unstructured matrices bail
    after O(sample) work instead of sorting all nnz diffs.
    ``return_diffs`` additionally returns the per-entry col-row diff
    array (entry order) so the caller's geo path reuses the single
    pass for ``axis_strengths`` — as ``(offs, diffs)``."""
    n = Asp.shape[0]
    if n > 4096:
        take = min(n, 512)
        stride = max(n // take, 1)
        rsel = np.arange(0, n, stride)
        sub = Asp[rsel]
        rows = np.repeat(rsel, np.diff(sub.indptr))
        if np.unique(
            sub.indices.astype(np.int64) - rows
        ).size > max_diags:
            return (None, None) if return_diffs else None
    # int32 diff arithmetic when both dimensions fit: the unique sort
    # runs ~2x faster and the offsets themselves are tiny either way
    use32 = max(Asp.shape) < np.iinfo(np.int32).max
    diffs = _col_diffs(Asp, np.int32 if use32 else np.int64)
    offs = np.unique(diffs)
    if offs.size > max_diags:
        return (None, None) if return_diffs else None
    offs = offs.astype(np.int64)
    return (offs, diffs) if return_diffs else offs


def infer_grid(offsets, n: int):
    """Infer (nx, ny, nz) with nx*ny*nz == n from stencil diagonal
    offsets; None if the offsets are not <=27-point-stencil shaped.

    A wrong-but-validating guess only degrades aggregate shapes (the
    Galerkin product is correct for any partition), never correctness.
    """
    offs = set(int(o) for o in offsets)
    pos = sorted(o for o in offs if o > 0)
    if not pos or n < 8:
        return None

    def allowed_set(nx, ny, nz):
        out = set()
        for a in (-1, 0, 1) if nx > 1 else (0,):
            for b in (-1, 0, 1) if ny > 1 else (0,):
                for c in (-1, 0, 1) if nz > 1 else (0,):
                    out.add(a + b * nx + c * nx * ny)
        return out

    cands_nx = {n}  # 1D chain
    for o in pos:
        for d in (o - 1, o, o + 1):
            if 2 <= d < n and n % d == 0:
                cands_nx.add(d)
    best = None
    best_score = None
    for nx in sorted(cands_nx):
        rem = n // nx
        cands_ny = {rem}
        for o in pos:
            for d in (o - 1, o, o + 1):
                if d >= 2 * nx and d % nx == 0 and rem % (d // nx) == 0:
                    cands_ny.add(d // nx)
        for ny in sorted(cands_ny):
            if ny < 1 or rem % ny:
                continue
            nz = rem // ny
            if offs <= allowed_set(nx, ny, nz):
                # prefer geometries whose primary strides are actual
                # offsets (true stencil axes), then the most cubic one
                score = (
                    (nx in offs or ny == 1)
                    + (nx * ny in offs or nz == 1),
                    -(max(nx, ny, nz) / max(min(nx, ny, nz), 1)),
                )
                if best is None or score > best_score:
                    best, best_score = (nx, ny, nz), score
    return best


def axis_strengths(Asp: sps.csr_matrix, nx: int, ny: int, nz: int,
                   diffs=None):
    """Mean |coupling| along each grid axis (offsets ±1, ±nx, ±nx·ny).

    Drives the semicoarsening decision: anisotropic stencils must be
    aggregated along the STRONG axis (classical strength-of-connection
    semantics), not by grid shape.
    """
    d = _col_diffs(Asp) if diffs is None else diffs
    av = np.abs(Asp.data)
    out = []
    for stride, dim in ((1, nx), (nx, ny), (nx * ny, nz)):
        if dim <= 1:
            out.append(0.0)
            continue
        m = np.abs(d) == stride
        out.append(float(av[m].mean()) if m.any() else 0.0)
    return out


def geo_block_shape(nx, ny, nz, passes, strengths=None):
    """Block shape (bx, by, bz) the geometric aggregation uses: each
    pass halves the axis with the largest remaining strength-to-block
    ratio (semicoarsening on anisotropic stencils)."""
    dims = [nx, ny, nz]
    block = [1, 1, 1]
    s = list(strengths) if strengths is not None else [1.0, 1.0, 1.0]
    smax = max(s) if max(s) > 0 else 1.0
    # breaking exact ties by dims keeps large axes first on cubes
    for _ in range(passes):
        ratios = [
            (s[a] / smax + 1e-9 * dims[a]) / block[a]
            if dims[a] > block[a]
            else 0.0
            for a in range(3)
        ]
        axis = int(np.argmax(ratios))
        if ratios[axis] <= 0.0:
            break
        block[axis] *= 2
    return tuple(block)


def geo_aggregate(
    nx: int, ny: int, nz: int, passes: int, strengths=None
) -> np.ndarray:
    """Blocked lexicographic aggregation on an (nx, ny, nz) grid.

    Each pass halves one axis: the one with the largest remaining
    coupling-strength-to-block ratio (``strengths`` from
    :func:`axis_strengths`; unit strengths when absent).  Isotropic
    stencils get the reference selector block shapes (SIZE_2 -> 2x1x1,
    SIZE_4 -> 2x2x1, SIZE_8 -> 2x2x2 on a cube); anisotropic stencils
    semicoarsen along the strong axis.  Coarse aggregates are numbered
    lexicographically on the coarse grid, so bandedness is preserved.
    """
    dims = [nx, ny, nz]
    block = list(geo_block_shape(nx, ny, nz, passes, strengths))
    cdims = [-(-dims[a] // block[a]) for a in range(3)]
    i = np.arange(nx * ny * nz, dtype=np.int64)
    ix = i % nx
    iy = (i // nx) % ny
    iz = i // (nx * ny)
    agg = (
        ix // block[0]
        + cdims[0] * (iy // block[1])
        + cdims[0] * cdims[1] * (iz // block[2])
    )
    return agg.astype(np.int32)


def select_aggregates(Asp, cfg, scope, device=None):
    """The selector decision shared by the serial and distributed
    setup paths: geometric blocks when the matrix is stencil-structured
    (and structured_aggregation allows it, or selector is GEO),
    matching-based aggregation otherwise (on ``device`` where
    :func:`aggregate` matches there).

    Returns (agg, geo_info): geo_info is (grid, block) when the
    geometric path was taken (enables the dense-reduction Galerkin in
    geo_galerkin_dia), else None."""
    selector = str(cfg.get("selector", scope)).upper()
    passes = SELECTOR_PASSES.get(selector, 1)
    if passes is None:
        passes = int(cfg.get("aggregation_passes", scope))
    if selector == "DUMMY":
        # reference dummy.cu:51: aggregates[i] = i / aggregate_size
        size = max(int(cfg.get("aggregate_size", scope)), 1)
        agg = (np.arange(Asp.shape[0], dtype=np.int32) // size).astype(
            np.int32
        )
        return _maybe_print_agg_info(cfg, scope, selector, agg), None
    if bool(cfg.get("structured_aggregation", scope)) or selector == "GEO":
        # one diff pass serves the offset scan and the axis strengths
        offs, diffs = stencil_offsets(Asp, return_diffs=True)
        grid = (
            infer_grid(offs, Asp.shape[0]) if offs is not None else None
        )
        if grid is not None:
            strengths = axis_strengths(Asp, *grid, diffs=diffs)
            block = geo_block_shape(*grid, passes, strengths)
            agg = geo_aggregate(*grid, passes, strengths=strengths)
            return (
                _maybe_print_agg_info(cfg, scope, selector, agg),
                (grid, block),
            )
    # reference notay_weights=1 selects the Notay coupling formula
    formula = (
        1 if bool(cfg.get("notay_weights", scope))
        else int(cfg.get("weight_formula", scope))
    )
    merge = bool(cfg.get("merge_singletons", scope))
    max_rounds = int(cfg.get("max_matching_iterations", scope))
    filter_alpha = (
        float(cfg.get("filter_weights_alpha", scope))
        if bool(cfg.get("filter_weights", scope)) else 0.0
    )
    serial = bool(cfg.get("serial_matching", scope))
    # max_unassigned_percentage early exit is honored only when the
    # config sets it (the registry default is a reference-GPU tuning)
    max_un = (
        float(cfg.get("max_unassigned_percentage", scope))
        if cfg.has("max_unassigned_percentage", scope) else 0.0
    )
    agg = aggregate(Asp, passes, formula, merge, max_rounds=max_rounds,
                    filter_alpha=filter_alpha, serial_matching=serial,
                    max_unassigned=max_un, device=device)
    return _maybe_print_agg_info(cfg, scope, selector, agg), None

def _maybe_print_agg_info(cfg, scope, selector, agg):
    """print_aggregation_info (reference aggregation selectors'
    printAggregationInfo): aggregate count + size histogram."""
    if bool(cfg.get("print_aggregation_info", scope)):
        nc = int(agg.max()) + 1 if agg.size else 0
        sizes = np.bincount(agg, minlength=max(nc, 1))
        emit(
            f"         Aggregation [{selector}]: {nc} aggregates over "
            f"{agg.shape[0]} rows; avg size "
            f"{agg.shape[0] / max(nc, 1):.2f}, max {int(sizes.max())}, "
            f"singletons {int((sizes == 1).sum())}"
        )
    return agg


# above this row count the dense-reduction Galerkin replaces the
# sparse product (memory: no A@P intermediate)
_GEO_RAP_MIN_ROWS = 4_000_000


def _decompose_offset(off, nx, ny, nz, reach=3):
    """Linear DIA offset -> (dx, dy, dz) stencil displacement with
    |d*| <= reach, or None when absent or AMBIGUOUS (thin grids make
    several displacements share a linear offset; guessing would build a
    wrong coarse operator, so the caller must fall back)."""
    found = []
    for dz in range(-reach, reach + 1):
        rem_z = off - dz * nx * ny
        for dy in range(-reach, reach + 1):
            dx = rem_z - dy * nx
            if -reach <= dx <= reach:
                found.append((dx, dy, dz))
    if len(found) != 1:
        return None
    return found[0]


def _geo_rap_keys(block, decs):
    """Coarse-displacement keys of the geometric Galerkin reduction, in
    the order :func:`_geo_rap_device` stacks them."""
    bx, by, bz = block
    keys = set()
    for dx, dy, dz in decs:
        for w in range(bz):
            for v in range(by):
                for u in range(bx):
                    keys.add(
                        ((u + dx) // bx, (v + dy) // by, (w + dz) // bz)
                    )
    return sorted(keys)


def _geo_rap_device(dia, grid, block, decs):
    """Wrap check and windowed block reductions of the DIA diagonals
    ``dia`` (nd, n), a tensor, as torch operations on its device (the
    JAX package's jitted ``_geo_rap_device``).  The wrap flag is read
    to the host once (a setup sync).  Returns (wrap_bad, stacked
    [n_keys, cz, cy, cx] tensor, or None when wrap_bad), keys ordered
    by :func:`_geo_rap_keys`.  Each coarse value sums its fine
    contributions in the order of the JAX package's host twin, so the
    two agree bit for bit."""
    nx, ny, nz = grid
    bx, by, bz = block
    cx, cy, cz = nx // bx, ny // by, nz // bz
    dev = dia.device
    fz = torch.arange(nz, device=dev).view(nz, 1, 1)
    fy = torch.arange(ny, device=dev).view(1, ny, 1)
    fx = torch.arange(nx, device=dev).view(1, 1, nx)
    wrap = torch.zeros((), dtype=torch.bool, device=dev)
    keys = _geo_rap_keys(block, decs)
    accs = {k: torch.zeros((cz, cy, cx), dtype=dia.dtype, device=dev)
            for k in keys}
    for ki, (dx, dy, dz) in enumerate(decs):
        d3 = dia[ki].reshape(nz, ny, nx)
        valid = (
            (fx + dx >= 0) & (fx + dx < nx)
            & (fy + dy >= 0) & (fy + dy < ny)
            & (fz + dz >= 0) & (fz + dz < nz)
        )
        wrap = wrap | ((d3 != 0) & ~valid).any()
        V = dia[ki].reshape(cz, bz, cy, by, cx, bx)
        for w in range(bz):
            DZ = (w + dz) // bz
            for v in range(by):
                DY = (v + dy) // by
                for u in range(bx):
                    DX = (u + dx) // bx
                    accs[(DX, DY, DZ)] = (
                        accs[(DX, DY, DZ)] + V[:, w, :, v, :, u]
                    )
    count_setup_sync()
    if bool(wrap):
        return True, None
    return False, torch.stack([accs[k] for k in keys])


def geo_galerkin_dia(Asp, grid, block, device="cpu", dia=None):
    """Galerkin product R A P for piecewise-constant geometric
    aggregates of a stencil matrix, as windowed sums over its DIA
    diagonals: no sparse-sparse product (the JAX package's
    ``geo_galerkin_dia``).  With P binary over (bx, by, bz) blocks,
    Ac[P, Q] = sum_{i in P, j in Q} A[i, j], and a fine entry on
    displacement (dx, dy, dz) at intra-block position (u, v, w) lands
    on coarse displacement ((u+dx)//bx, (v+dy)//by, (w+dz)//bz).

    The reductions run as torch operations on ``device``
    (:func:`_geo_rap_device`).  The JAX package keeps a host twin for
    an f64 operator where its device would round f64 to f32 (x64 off);
    torch computes f64 on every device, so the coarse operator never
    loses precision and one route serves both.  ``dia``
    (``(offsets, planes)``: the sorted distinct offsets of ``Asp`` and
    its (nd, n) planes on ``device``, as ``SparseMatrix`` holds them)
    saves building the planes from the CSR arrays; it must be the DIA
    form of ``Asp`` itself.

    Returns the coarse operator as scipy CSR, or None where the
    decomposition does not apply (ragged blocks, an ambiguous offset,
    or a wrap diagonal with entries outside the grid): the caller forms
    the sparse product."""
    nx, ny, nz = grid
    bx, by, bz = block
    if nx % bx or ny % by or nz % bz:
        return None  # ragged blocks: fall back
    cx, cy, cz = nx // bx, ny // by, nz // bz
    n = nx * ny * nz
    if dia is not None:
        offs_arr = np.asarray(dia[0], dtype=np.int64)
        planes = dia[1]
    else:
        rows_all = np.repeat(
            np.arange(n, dtype=np.int64), np.diff(Asp.indptr)
        )
        d_all = Asp.indices.astype(np.int64) - rows_all
        offs_arr = np.unique(d_all)
    reach = max(bx, by, bz)
    dec = {}
    for off in offs_arr:
        d = _decompose_offset(int(off), nx, ny, nz, reach)
        if d is None:
            return None
        dec[int(off)] = d
    if dia is None:
        # all dense diagonals in one pass over the entries (CSR has no
        # duplicates, so plain fancy assignment suffices)
        k_all = np.searchsorted(offs_arr, d_all)
        planes = np.zeros((offs_arr.shape[0], n), dtype=Asp.dtype)
        planes[k_all, rows_all] = Asp.data
        planes = torch.from_numpy(planes).to(device)
    decs = tuple(dec[int(off)] for off in offs_arr)
    wrap_bad, stacked = _geo_rap_device(planes, grid, (bx, by, bz), decs)
    if not wrap_bad:
        count_setup_sync()
        stacked = stacked.cpu().numpy()
    if wrap_bad:
        # periodic/wrap diagonals (e.g. +-(nx-1)) carry nonzeros at
        # out-of-window rows: geometric attribution would be wrong
        return None
    keys = _geo_rap_keys((bx, by, bz), decs)
    coarse = {k: stacked[i] for i, k in enumerate(keys)}

    nc = cx * cy * cz
    Z, Y, X = np.meshgrid(
        np.arange(cz), np.arange(cy), np.arange(cx), indexing="ij"
    )
    r_full = X + cx * (Y + cy * Z)
    rows_l, cols_l, vals_l = [], [], []
    for (DX, DY, DZ), acc in coarse.items():
        # valid coarse rows: the displaced coarse cell stays in-grid
        ok = (
            (X + DX >= 0) & (X + DX < cx)
            & (Y + DY >= 0) & (Y + DY < cy)
            & (Z + DZ >= 0) & (Z + DZ < cz)
        )
        c_off = DX + cx * (DY + cy * DZ)
        r = r_full[ok].ravel()
        rows_l.append(r)
        cols_l.append(r + c_off)
        vals_l.append(acc[ok].ravel())
    Ac = sps.csr_matrix(
        (
            np.concatenate(vals_l),
            (np.concatenate(rows_l), np.concatenate(cols_l)),
        ),
        shape=(nc, nc),
    )
    Ac.sum_duplicates()
    Ac.eliminate_zeros()
    Ac.sort_indices()
    return Ac


def build_aggregation_level(Asp, cfg, scope, device=None, dia=None):
    """Returns (P, R, A_coarse) scipy matrices for one aggregation level
    (reference aggregation_amg_level.cu:238-371): P is the binary
    aggregate map, R = P^T and A_coarse = R A P, from
    :func:`geo_galerkin_dia` on ``device`` for geometric aggregates of
    at least ``_GEO_RAP_MIN_ROWS`` rows (``dia``: the level's DIA
    planes there, or None), else scipy's product.  Matching runs on
    ``device`` where :func:`aggregate` says so.  Setup phases
    ``aggregation``, ``interp`` and ``rap_execute``, as in the JAX
    package."""
    gen = str(cfg.get("coarseAgenerator", scope)).upper()
    if gen not in ("", "LOW_DEG", "GALERKIN", "THRUST", "DEFAULT"):
        raise KeyError(
            f"CoarseAGeneratorFactory '{gen}' has not been registered"
        )
    if not Asp.data.flags.writeable or not Asp.has_canonical_format:
        # aggregation reads the summed operator (the JAX package sums
        # the duplicates of every finest operator, whose host arrays are
        # read-only there), and scipy's abs()/binops dedup IN PLACE:
        # work on a private canonical copy
        Asp = Asp.copy()
        Asp.sum_duplicates()
        Asp.sort_indices()
    with setup_phase("aggregation"):
        agg, geo_info = select_aggregates(Asp, cfg, scope, device=device)
    n = Asp.shape[0]
    nc = int(agg.max()) + 1
    with setup_phase("interp"):
        P = sps.csr_matrix(
            (np.ones(n, dtype=Asp.dtype), (np.arange(n), agg)),
            shape=(n, nc),
        )
        R = P.T.tocsr()
    with setup_phase("rap_execute"):
        Ac = None
        # the dense-reduction Galerkin avoids the A@P sparse
        # intermediate (about 8x the fine operator's memory); below this
        # size scipy's product is faster on the host
        if geo_info is not None and n >= _GEO_RAP_MIN_ROWS:
            Ac = geo_galerkin_dia(
                Asp, *geo_info, device="cpu" if device is None else device,
                dia=dia)
        if Ac is None:
            Ac = (R @ Asp @ P).tocsr()
            Ac.sum_duplicates()
            Ac.eliminate_zeros()
            Ac.sort_indices()
    return P, R, Ac
