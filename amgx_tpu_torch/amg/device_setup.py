"""Classical AMG setup on the solver's device: strength, PMIS, D1 / D2 /
MULTIPASS interpolation, truncation and the Galerkin product as torch
ops.

Counterpart of the JAX package's ``amg/device_setup.py``, which runs
the same pipeline as XLA programs (reference: ``src/classical/strength/
ahat.cu``, ``selectors/pmis.cu``, ``interpolators/distance1.cu`` and the
two-phase SpGEMM of ``src/csr_multiply.cu:207``).  The arithmetic that
decides a result is the JAX package's: the same comparisons in
strength, PMIS weights ``lam + hash`` in the problem's float dtype with
the hash made on the host, the same interpolation formulas.  So the C/F
splits equal the JAX device pipeline's bit for bit, and P, R and Ac
have its patterns with values equal to roundoff.

Torch idiom in place of XLA's:

  * matrices are row-sorted COO triples of exact length (int64 indices):
    no power-of-two buckets or sentinel rows, which exist in the JAX
    package only to reuse compiled programs;
  * PMIS's ``lax.while_loop`` is a Python loop with one scalar read per
    round;
  * a sort on (row, col) is a stable sort on one int64 key
    ``row * n_cols + col``;
  * float segment sums run over row-sorted data in entry order
    (``ops/spmv.py:segment_sum``), integer counts are ``index_add_``,
    maxima ``scatter_reduce``.  No float sum goes through atomics, so
    two setups of one matrix on the card give the same P, R and Ac bit
    for bit;
  * compaction of masked entries to a known count scatters into slots
    (a cumsum of the mask), so it reads nothing back to the host: the
    only reads are the explicit scalar ones and the final download of
    P, R and Ac, each counted (``_read``, ``_download``).

``build_classical_level_device`` returns (P, R, Ac) as scipy CSR, as
the JAX package's does, and adds to the caller's profile its host and
device seconds, ``syncs`` (the reads it made: one per scalar, one per
PMIS round, one per downloaded array) and ``jax_syncs`` (the JAX
package's tally of the same level, its ``syncs``, which counts neither
PMIS rounds, a loop that stays on its device, nor downloads).  An ESC
expansion past int32 range raises :class:`DeviceSetupOverflow` in both
packages; the hierarchy falls back to the host builder for that level
only on that error.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import scipy.sparse as sps
import torch

from amgx_tpu_torch.amg.classical import _hash_weights as _hash_weights_raw
from amgx_tpu_torch.core import profiling
from amgx_tpu_torch.core.device import resolve_device
from amgx_tpu_torch.core.errors import ResourceError
from amgx_tpu_torch.ops.spmv import segment_sum as _seg_sum


class DeviceSetupOverflow(ResourceError):
    """An ESC SpGEMM expansion exceeds int32 addressing; the hierarchy
    builds the level with the host (scipy) builder instead."""


# the JAX package addresses ESC expansions with int32 arithmetic on the
# device; the port keeps its limit so both packages fail alike
_SPGEMM_MAX_EXPANSION = 2**31 - 1


def _hash_weights(n, seed, acc):
    """Tie-break hash weights (host numpy), their seconds added to the
    per-call accumulator ``acc`` (a one-element list): host work done
    between device stages."""
    t0 = time.perf_counter()
    out = _hash_weights_raw(n, seed=seed)
    acc[0] += time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# row-sorted COO helpers


def _row_offsets(rows, n):
    """CSR row pointers (n + 1,) of row-sorted ``rows``."""
    return torch.searchsorted(
        rows, torch.arange(n + 1, dtype=rows.dtype, device=rows.device)
    )


def _seg_max(x, index, n):
    """Per-segment maxima of ``x`` grouped by ``index`` (any order);
    -inf where a segment is empty, as ``jax.ops.segment_max``."""
    out = torch.full((n,), float("-inf"), dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, index, x, "amax", include_self=True)


def _count(index, mask, n):
    """Per-segment counts of ``mask`` grouped by ``index`` (int64)."""
    out = torch.zeros(n, dtype=torch.int64, device=index.device)
    return out.index_add_(0, index, mask.to(torch.int64))


def _read(t):
    """The value of the 0-d tensor ``t`` on the host: one counted read."""
    profiling.count_setup_sync()
    return t.item()


def _download(t):
    """``t`` as a host numpy array: one counted read."""
    profiling.count_setup_sync()
    return t.cpu().numpy()


def _compact(keep, count, *arrays):
    """The entries of each array where ``keep`` holds, in order;
    ``count`` is the number of them, read by the caller.  Scatters into
    slots from a cumsum of the mask (a dropped entry lands in one spare
    slot), so nothing is read back to the host."""
    slot = torch.cumsum(keep, 0) - 1
    slot = torch.where(keep, slot, torch.full_like(slot, count))
    out = []
    for a in arrays:
        o = a.new_empty(count + 1)
        o.scatter_(0, slot, a)
        out.append(o[:count])
    return out


def _compact_masked(rows, cols, vals, keep):
    """(rows, cols, vals) where ``keep`` holds; one scalar read."""
    nnz = _read(keep.sum())
    return _compact(keep, nnz, rows, cols, vals)


def _sort_coo(rows, cols, vals, n_cols):
    """Stable sort of COO triples by (row, col)."""
    key = rows * max(n_cols, 1) + cols
    perm = torch.sort(key, stable=True).indices
    return rows[perm], cols[perm], vals[perm]


def _take(vals, idx):
    """``vals[idx]`` with ``idx`` clamped into range; zeros when
    ``vals`` is empty (the caller masks the misses)."""
    if vals.numel() == 0:
        return torch.zeros(idx.shape, dtype=vals.dtype, device=vals.device)
    return vals[idx.clamp(0, vals.numel() - 1)]


# ----------------------------------------------------------------------
# strength of connection (AHAT)


def _strength_ahat_dev(rows, cols, vals, offsets, n, theta, max_row_sum):
    """Strong mask over A's entries (reference strength/ahat.cu; the
    comparisons of the host ``strength_ahat``)."""
    zero = vals.new_zeros(())
    offd = rows != cols
    mneg = _seg_max(torch.where(offd, -vals, zero), rows, n)
    mabs = _seg_max(torch.where(offd, vals.abs(), zero), rows, n)
    use_abs = mneg <= 0
    thresh = torch.where(use_abs, mabs, mneg) * theta
    val = torch.where(use_abs[rows], vals.abs(), -vals)
    strong = offd & (val >= thresh[rows]) & (val > 0)
    if max_row_sum < 1.0 + 1e-12:
        # max_row_sum guard (weakened dependencies, reference core.cu)
        diag = _seg_sum(torch.where(~offd, vals, zero), offsets)
        rs = _seg_sum(vals, offsets).abs()
        one = vals.new_ones(())
        weak = rs > max_row_sum * torch.where(diag != 0, diag, one).abs()
        strong &= ~weak[rows]
    return strong


# ----------------------------------------------------------------------
# PMIS C/F selection


def _pmis_dev(rows, cols, strong, n, w):
    """PMIS on the symmetrized strength graph (reference
    selectors/pmis.cu), the fixed point of the JAX package's
    ``_pmis_dev``: the same weights, the same undecided-neighbour max,
    the same C-neighbour fine sweep, 200-round cap.  One scalar read
    per round (is any point undecided)."""
    deg = _count(rows, strong, n) + _count(cols, strong, n)
    state = torch.where(deg == 0, 1, 0).to(torch.int8)
    minus1 = w.new_full((), -1.0)
    for _ in range(200):
        und = state == 0
        if not _read(und.any()):
            break
        wu = torch.where(und, w, minus1)
        act = strong & und[rows] & und[cols]
        # neighbour max over both directions (symmetrized graph)
        nbmax = torch.maximum(
            _seg_max(torch.where(act, wu[cols], minus1), rows, n),
            _seg_max(torch.where(act, wu[rows], minus1), cols, n),
        )
        state = torch.where(und & (wu > nbmax), 1, state).to(torch.int8)
        # fine: undecided with a C neighbour (either direction)
        isC = state == 1
        cnb = (_count(rows, strong & isC[cols], n)
               + _count(cols, strong & isC[rows], n)) > 0
        state = torch.where((state == 0) & cnb, -1, state).to(torch.int8)
    return (state != -1).to(torch.int8)


def _pmis_weights(strong, cols, n, dtype, seed, acc):
    """PMIS weights ``lam + hash`` in ``dtype``: lam is the strong
    in-degree (exact in any float dtype), the hash host numpy."""
    lam = _count(cols, strong, n).to(dtype)
    h = torch.from_numpy(_hash_weights(n, seed, acc)).to(
        device=lam.device, dtype=dtype)
    return lam + h


# ----------------------------------------------------------------------
# distance-1 direct interpolation


def _d1_weights_dev(rows, cols, vals, offsets, strong, cf):
    """Per-entry interpolation weights, keep mask and coarse map
    (reference interpolators/distance1.cu; the sign-split alpha/beta
    formula of the host ``direct_interpolation``)."""
    zero = vals.new_zeros(())
    one = vals.new_ones(())
    offd = rows != cols
    isC_col = cf[cols] == 1

    def seg(x):
        return _seg_sum(x, offsets)

    negm = vals < 0
    posm = offd & (vals > 0)
    sum_neg = seg(torch.where(offd & negm, vals, zero))
    sum_pos = seg(torch.where(posm, vals, zero))
    strongC = strong & isC_col
    sum_negC = seg(torch.where(strongC & negm, vals, zero))
    sum_posC = seg(torch.where(strongC & ~negm, vals, zero))
    diag = seg(torch.where(~offd, vals, zero))
    diag = diag + torch.where(sum_posC == 0, sum_pos, zero)
    alpha = torch.where(
        sum_negC != 0,
        sum_neg / torch.where(sum_negC != 0, sum_negC, one), zero)
    beta = torch.where(
        sum_posC != 0,
        sum_pos / torch.where(sum_posC != 0, sum_posC, one), zero)
    diag = torch.where(diag != 0, diag, one)
    keep = strongC & (cf[rows] == 0)
    coef = torch.where(vals < 0, alpha[rows], beta[rows])
    pvals = -coef * vals / diag[rows]
    cmap = torch.cumsum(cf, 0) - 1
    return pvals, keep, cmap


def _c_identity(cf, cmap, nc, dtype):
    """The C rows of P: row i (a C point) holds 1 at column cmap[i]."""
    isC = cf == 1
    node = torch.arange(cf.shape[0], device=cf.device)
    (crow,) = _compact(isC, nc, node)
    return crow, cmap[crow], torch.ones(nc, dtype=dtype, device=cf.device)


def _assemble_p_dev(rows, cols, pvals, keep, cf, cmap, nf, nc):
    """P as row-sorted COO: the ``nf`` kept F-row weights and the ``nc``
    C-row identity entries."""
    fr, fc, fv = _compact(keep, nf, rows, cmap[cols], pvals)
    cr, cc, cv = _c_identity(cf, cmap, nc, pvals.dtype)
    return _sort_coo(torch.cat([fr, cr]), torch.cat([fc, cc]),
                     torch.cat([fv, cv]), nc)


def _transpose_dev(rows, cols, vals, n_rows):
    """COO transpose by a stable (col, row) sort."""
    key = cols * max(n_rows, 1) + rows
    perm = torch.sort(key, stable=True).indices
    return cols[perm], rows[perm], vals[perm]


def _lookup_sorted_pairs(qrows, qcols, rows, cols, n_cols):
    """Index of each query (qrows[t], qcols[t]) in the (row, col)-sorted
    COO arrays, or -1 where absent (binary search on int64 keys)."""
    m = rows.shape[0]
    if m == 0:
        return torch.full_like(qrows, -1)
    key = rows * n_cols + cols
    q = qrows * n_cols + qcols
    idx = torch.searchsorted(key, q)
    safe = idx.clamp(max=m - 1)
    hit = (idx < m) & (key[safe] == q)
    return torch.where(hit, safe, -1)


# ----------------------------------------------------------------------
# interpolation truncation (reference truncate.cu + interp_max_elements)


def _truncate_weights_dev(prow, pval, n, trunc, apply_trunc, max_el):
    """Keep mask and rescaled values for row-sorted P (the host
    ``truncate_interp``: drop below trunc * max|row|, keep the max_el
    largest per row with the original position as the tie-break,
    rescale to preserve row sums)."""
    offsets = _row_offsets(prow, n)
    absd = pval.abs()
    keep = torch.ones_like(prow, dtype=torch.bool)
    if apply_trunc:
        rmax = _seg_max(absd, prow, n)
        keep &= absd >= trunc * rmax[prow]
    if max_el >= 0:
        # rank within a row by descending |val|, then position: two
        # stable sorts give the (row, -|val|, position) order
        by_val = torch.sort(-absd, stable=True).indices
        order = by_val[torch.sort(prow[by_val], stable=True).indices]
        m = prow.shape[0]
        rank_sorted = torch.arange(m, device=prow.device) - \
            offsets[prow[order]]
        rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
        keep &= rank < max_el
    zero = pval.new_zeros(())
    one = pval.new_ones(())
    rs_old = _seg_sum(pval, offsets)
    rs_new = _seg_sum(torch.where(keep, pval, zero), offsets)
    scale = torch.where(
        rs_new != 0, rs_old / torch.where(rs_new != 0, rs_new, one), one)
    newval = pval * keep * scale[prow]
    keep &= newval != 0  # eliminate_zeros parity
    return keep, newval


def truncate_interp_device(prow, pcol, pval, n, trunc, max_el):
    """Device truncation; returns the compacted row-sorted COO."""
    apply_trunc = trunc < 1.0
    if (not apply_trunc and max_el < 0) or prow.numel() == 0:
        return prow, pcol, pval
    keep, newval = _truncate_weights_dev(prow, pval, n, trunc,
                                         apply_trunc, int(max_el))
    return _compact_masked(prow, pcol, newval, keep)


# ----------------------------------------------------------------------
# ESC SpGEMM (expand, sort, compress)


def _spgemm_bound_dev(a_cols, b_indptr):
    """Phase 1 (bound): the B row length at each A entry's column, and
    its inclusive cumsum."""
    cnt = b_indptr[a_cols + 1] - b_indptr[a_cols]
    return torch.cumsum(cnt, 0), cnt


def _spgemm_expand_sort_dev(a_rows, a_cols, a_vals, cum, cnt, b_indptr,
                            b_cols, b_vals, E, n_right):
    """Phase 2 (expand + sort): all E partial products, stably sorted by
    output (row, col) key, with the mask of each run's first entry."""
    dev = a_rows.device
    e = torch.repeat_interleave(
        torch.arange(a_rows.shape[0], device=dev), cnt, output_size=E)
    off = torch.arange(E, device=dev) - (cum - cnt)[e]
    bflat = b_indptr[a_cols[e]] + off
    key = a_rows[e] * n_right + b_cols[bflat]
    vals = a_vals[e] * b_vals[bflat]
    key, perm = torch.sort(key, stable=True)
    vals = vals[perm]
    first = torch.ones(E, dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    return key, vals, first


def _spgemm_compress_dev(key, vals, first, nnz, n_right):
    """Phase 3 (compress): sum each run of equal keys (in its sorted
    order, so the sums repeat bit for bit) into ``nnz`` entries."""
    E = key.shape[0]
    if nnz == 0:
        empty = key.new_empty(0)
        return empty, empty, vals.new_empty(0)
    (starts,) = _compact(first, nnz, torch.arange(E, device=key.device))
    okey = key[starts]
    offsets = torch.cat([starts, starts.new_full((1,), E)])
    return okey // n_right, okey % n_right, _seg_sum(vals, offsets)


def spgemm_device(a_rows, a_cols, a_vals, b_rows, b_cols, b_vals, n_mid,
                  n_right):
    """C = A @ B (ESC) on row-sorted COO operands; B has ``n_mid`` rows
    and ``n_right`` columns.  Two scalar reads: the expansion length
    and the output nnz (the reference csr_multiply.cu:207 counter
    readbacks).  Raises :class:`DeviceSetupOverflow` when the
    expansion exceeds int32 range."""
    b_indptr = _row_offsets(b_rows, n_mid)
    cum, cnt = _spgemm_bound_dev(a_cols, b_indptr)
    total = _read(cum[-1]) if cum.numel() else 0
    if total > _SPGEMM_MAX_EXPANSION:
        raise DeviceSetupOverflow(
            f"ESC SpGEMM expansion {total} exceeds int32 range; "
            "use the host builder for this level"
        )
    key, vals, first = _spgemm_expand_sort_dev(
        a_rows, a_cols, a_vals, cum, cnt, b_indptr, b_cols, b_vals,
        total, n_right)
    nnz = _read(first.sum())
    return _spgemm_compress_dev(key, vals, first, nnz, n_right)


def coalesce_coo_device(rows, cols, vals, n_right):
    """Sort by (row, col) and sum duplicates; one scalar read."""
    key = rows * n_right + cols
    key, perm = torch.sort(key, stable=True)
    vals = vals[perm]
    first = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    first[1:] = key[1:] != key[:-1]
    nnz = _read(first.sum())
    return _spgemm_compress_dev(key, vals, first, nnz, n_right)


# ----------------------------------------------------------------------
# aggressive two-stage PMIS (reference selectors AGGRESSIVE_PMIS)


def aggressive_pmis_device(rows, cols, vals, strong, n, hash_acc):
    """Two-stage aggressive coarsening: PMIS on S, then PMIS (seed 1)
    among the stage-1 C points on the distance-2 graph S + S@S (the
    JAX package's ``aggressive_pmis_device``).  Returns (cf, nc)."""
    fdt = vals.dtype
    w0 = _pmis_weights(strong, cols, n, fdt, 0, hash_acc)
    cf1 = _pmis_dev(rows, cols, strong, n, w0).to(torch.int64)
    nc1 = _read(cf1.sum())
    if nc1 <= 1:
        return cf1.to(torch.int8), nc1
    ones = torch.ones_like(vals)
    sr, sc, sv = _compact_masked(rows, cols, ones, strong)
    ss = spgemm_device(sr, sc, sv, sr, sc, sv, n, n)
    r2, c2, v2 = coalesce_coo_device(
        torch.cat([sr, ss[0]]), torch.cat([sc, ss[1]]),
        torch.cat([sv, torch.ones_like(ss[2])]), n)
    # restrict to C x C, drop the diagonal, renumber by cmap1
    cmap1 = torch.cumsum(cf1, 0) - 1
    keepC = (cf1[r2] == 1) & (cf1[c2] == 1) & (r2 != c2)
    crow, ccol, _ = _compact_masked(cmap1[r2], cmap1[c2], v2, keepC)
    edgeC = torch.ones_like(crow, dtype=torch.bool)
    w2 = _pmis_weights(edgeC, ccol, nc1, fdt, 1, hash_acc)
    cf2 = _pmis_dev(crow, ccol, edgeC, nc1, w2)
    # final C = stage-1 C that survived stage 2
    cf = (cf1 == 1) & (cf2[cmap1.clamp(0, nc1 - 1)] == 1)
    return cf.to(torch.int8), _read(cf.sum())


# ----------------------------------------------------------------------
# multipass interpolation (reference interpolators/multipass.cu)


def multipass_interpolation_device(rows, cols, vals, offsets, strong, cf,
                                   n, max_passes=10):
    """Pass-k F rows interpolate through strong assigned neighbours' P
    rows (the host ``multipass_interpolation``'s recurrence; each pass
    is one ESC product of the scaled strong-assigned slice with the
    current P).  Returns (prow, pcol, pval, nc)."""
    zero = vals.new_zeros(())
    one = vals.new_ones(())

    def seg(x):
        return _seg_sum(x, offsets)

    diag = seg(torch.where(rows == cols, vals, zero))
    row_total = seg(vals) - diag
    strongm = strong & (rows != cols)
    cf_b = cf.to(torch.int64)
    cmap = torch.cumsum(cf_b, 0) - 1
    nc = _read(cf_b.sum())
    assigned = cf_b == 1
    # P starts as the C-point identity block
    prow, pcol, pval = _c_identity(cf_b, cmap, nc, vals.dtype)
    for _ in range(max_passes):
        # ready: unassigned rows with a strong assigned neighbour
        ready = ~assigned & (_count(rows, strongm & assigned[cols], n) > 0)
        n_ready = _read(ready.sum())
        if n_ready == 0:
            break
        picked = strongm & ready[rows] & assigned[cols]
        strong_sum = seg(torch.where(picked, vals, zero))
        atil = diag + (row_total - strong_sum)
        atil = torch.where(atil != 0, atil, one)
        wvals = torch.where(picked, -vals / atil[rows], zero)
        wr, wc, wv = _compact_masked(rows, cols, wvals, picked)
        wp = spgemm_device(wr, wc, wv, prow, pcol, pval, n, nc)
        # the new rows are disjoint from P's: concatenate and sort
        prow, pcol, pval = coalesce_coo_device(
            torch.cat([prow, wp[0]]), torch.cat([pcol, wp[1]]),
            torch.cat([pval, wp[2]]), nc)
        assigned = assigned | ready
    return prow, pcol, pval, nc


# ----------------------------------------------------------------------
# distance-2 "standard" interpolation (reference interpolators/
# distance2.cu; hypre BoomerAMG standard formulation)


def standard_interpolation_device(rows, cols, vals, offsets, strong, cf,
                                  n):
    """D2 interpolation (the host ``standard_interpolation``'s algebra
    over COO slices with ESC products; the pair denominators d_ik are
    entries of T @ A_FC_neg^T looked up on the strong F-F pattern).
    Returns (prow, pcol, pval, nc)."""
    zero = vals.new_zeros(())
    one = vals.new_ones(())
    cf_b = cf.to(torch.int64)
    cmap = torch.cumsum(cf_b, 0) - 1
    nc = _read(cf_b.sum())
    isF_r = cf_b[rows] == 0
    isC_c = cf_b[cols] == 1
    isF_c = cf_b[cols] == 0
    offd = rows != cols

    def seg(x):
        return _seg_sum(x, offsets)

    diag = seg(torch.where(~offd, vals, zero))
    m_sfc = strong & isF_r & isC_c
    m_sff = offd & strong & isF_r & isF_c
    # sign restriction: redistribution uses entries opposite in sign
    # to the row diagonal (host keep_neg)
    m_neg = isF_r & isC_c & (vals * diag[rows] < 0)

    fr, fc, fv = _compact_masked(rows, cols, vals, m_sfc)
    gr, gc, gv = _compact_masked(rows, cols, vals, m_sff)
    hr, hc, hv = _compact_masked(rows, cols, vals, m_neg)

    # T = SFCb U SFFb @ SFCb (binary patterns)
    sfc1 = torch.ones_like(fv)
    tprod = spgemm_device(gr, gc, torch.ones_like(gv), fr, fc, sfc1, n, n)
    tr, tc, tv = coalesce_coo_device(
        torch.cat([fr, tprod[0]]), torch.cat([fc, tprod[1]]),
        torch.cat([sfc1, torch.ones_like(tprod[2])]), n)
    # E = T @ A_FC_neg^T; d_ik sampled at the SFF entries
    ntr, ntc, ntv = _transpose_dev(hr, hc, hv, n)
    E = spgemm_device(tr, tc, torch.ones_like(tv), ntr, ntc, ntv, n, n)
    d_idx = _lookup_sorted_pairs(gr, gc, E[0], E[1], n)
    d_vals = torch.where(d_idx >= 0, _take(E[2], d_idx), zero)
    b_vals = torch.where(
        d_vals != 0, gv / torch.where(d_vals != 0, d_vals, one), zero)
    # Wnum = (AsFC + B @ A_FC_neg) masked to T
    ba = spgemm_device(gr, gc, b_vals, hr, hc, hv, n, n)
    wr, wc, wv = coalesce_coo_device(
        torch.cat([fr, ba[0]]), torch.cat([fc, ba[1]]),
        torch.cat([fv, ba[2]]), n)
    inT = _lookup_sorted_pairs(wr, wc, tr, tc, n) >= 0

    # modified diagonal
    row_total = seg(vals) - diag
    strong_sum = seg(torch.where(m_sfc | m_sff, vals, zero))
    weak_sum = row_total - strong_sum
    undis = _seg_sum(torch.where(d_vals == 0, gv, zero),
                     _row_offsets(gr, n))
    atil = diag + weak_sum + undis
    atil = torch.where(atil != 0, atil, one)
    wv = torch.where(inT, -wv / atil[wr], zero)

    # P: the F rows of Wnum inside T, and the C identity
    nnzWk = _read(inT.sum())
    Fr, Fc, Fv = _compact(inT, nnzWk, wr, cmap[wc], wv)
    cr, cc, cv = _c_identity(cf_b, cmap, nc, vals.dtype)
    prow, pcol, pval = _sort_coo(torch.cat([Fr, cr]), torch.cat([Fc, cc]),
                                 torch.cat([Fv, cv]), nc)
    return prow, pcol, pval, nc


# ----------------------------------------------------------------------
# Galerkin chain


def galerkin_rap_device(rows, cols, vals, prow, pcol, pval, n, nc,
                        prof=None):
    """R = P^T, AP = A @ P, Ac = R @ AP.  Four scalar reads (two per
    product), the JAX package's tally of them added to ``prof``.
    Returns ((rrow, rcol, rval), (ac_rows, ac_cols, ac_vals))."""
    rrow, rcol, rval = _transpose_dev(prow, pcol, pval, n)
    ap = spgemm_device(rows, cols, vals, prow, pcol, pval, n, nc)
    ac = spgemm_device(rrow, rcol, rval, *ap, n, nc)
    if prof is not None:
        prof["jax_syncs"] = prof.get("jax_syncs", 0) + 4
    return (rrow, rcol, rval), ac


# ----------------------------------------------------------------------
# orchestration


def device_setup_eligible(cfg, scope, level_id: int) -> bool:
    """The device pipeline covers AHAT strength with PMIS and D1 / D2 /
    MULTIPASS interpolation, and aggressive levels; any other config
    takes the host builder."""
    strength = str(cfg.get("strength", scope)).upper()
    selector = str(cfg.get("selector", scope)).upper()
    interp = str(cfg.get("interpolator", scope)).upper()
    aggressive_levels = int(cfg.get("aggressive_levels", scope))
    aggressive = (
        level_id < aggressive_levels
        or selector in ("AGGRESSIVE_PMIS", "AGGRESSIVE_HMIS")
    )
    if aggressive:
        # two-stage PMIS + MULTIPASS (AGGRESSIVE_HMIS uses the PMIS
        # stage, as the host builder does)
        return strength == "AHAT"
    return (
        strength == "AHAT"
        and selector == "PMIS"
        and interp in ("D1", "D2", "STD", "STANDARD", "MULTIPASS")
    )


def _coo_to_scipy(rows, cols, vals, shape):
    """Row-sorted unique COO tensors -> scipy CSR on the host."""
    r, c, v = _download(rows), _download(cols), _download(vals)
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=shape[0]), out=indptr[1:])
    return sps.csr_matrix((v, c, indptr), shape=shape)


def build_classical_level_device(Asp, cfg, scope, level_id: int = 0,
                                 profile: dict | None = None,
                                 device="cuda"):
    """One classical level on ``device`` (strength -> C/F -> P ->
    truncation -> RAP).  Returns (P, R, Ac) as scipy CSR for the
    hierarchy loop; the host/device seconds, the reads made
    (``syncs``) and the JAX package's tally of them (``jax_syncs``) are
    added to ``profile``.  Callers gate on
    :func:`device_setup_eligible`."""
    prof = {"host_s": 0.0, "device_s": 0.0, "syncs": 0, "jax_syncs": 0}
    with profiling.setup_profile_scope(prof):
        out = _build_level(Asp, cfg, scope, level_id, prof, device)
    if profile is not None:
        for k, v in prof.items():
            profile[k] = profile.get(k, 0) + v
    return out


def _build_level(Asp, cfg, scope, level_id, prof, device):
    hash_acc = [0.0]
    theta = float(cfg.get("strength_threshold", scope))
    max_row_sum = float(cfg.get("max_row_sum", scope))
    selector = str(cfg.get("selector", scope)).upper()
    interp = str(cfg.get("interpolator", scope)).upper()
    trunc = float(cfg.get("interp_truncation_factor", scope))
    max_el = int(cfg.get("interp_max_elements", scope))
    aggressive_levels = int(cfg.get("aggressive_levels", scope))
    aggressive_interp = str(
        cfg.get("aggressive_interpolator", scope)).upper()
    aggressive = (
        level_id < aggressive_levels
        or selector in ("AGGRESSIVE_PMIS", "AGGRESSIVE_HMIS")
    )
    dev = resolve_device(device)

    t0 = time.perf_counter()
    A = Asp.tocsr()
    n = A.shape[0]
    rows_np = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    prof["host_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = torch.from_numpy(rows_np).to(dev)
    cols = torch.from_numpy(A.indices.astype(np.int64)).to(dev)
    vals = torch.from_numpy(np.ascontiguousarray(A.data)).to(dev)
    offsets = torch.from_numpy(A.indptr.astype(np.int64)).to(dev)
    strong = _strength_ahat_dev(rows, cols, vals, offsets, n, theta,
                                max_row_sum)

    if aggressive:
        if aggressive_interp != "MULTIPASS":
            warnings.warn(
                f"aggressive interpolator {aggressive_interp}: "
                "using MULTIPASS"
            )
        cf, nc = aggressive_pmis_device(rows, cols, vals, strong, n,
                                        hash_acc)
        prof["jax_syncs"] += 4
        prow, pcol, pval, nc = multipass_interpolation_device(
            rows, cols, vals, offsets, strong, cf, n)
        prof["jax_syncs"] += 4
    else:
        # seed 0: the host pmis_select's stage-0 seed
        w = _pmis_weights(strong, cols, n, vals.dtype, 0, hash_acc)
        cf = _pmis_dev(rows, cols, strong, n, w)
        if interp == "MULTIPASS":
            prow, pcol, pval, nc = multipass_interpolation_device(
                rows, cols, vals, offsets, strong, cf, n)
            prof["jax_syncs"] += 4
        elif interp == "D1":
            cf64 = cf.to(torch.int64)
            pvals, keep, cmap = _d1_weights_dev(rows, cols, vals, offsets,
                                                strong, cf64)
            nf = _read(keep.sum())
            nc = _read(cf64.sum())
            prof["jax_syncs"] += 2
            prow, pcol, pval = _assemble_p_dev(rows, cols, pvals, keep,
                                               cf64, cmap, nf, nc)
        else:  # D2 / STD / STANDARD
            prow, pcol, pval, nc = standard_interpolation_device(
                rows, cols, vals, offsets, strong, cf, n)
            prof["jax_syncs"] += 6

    prow, pcol, pval = truncate_interp_device(prow, pcol, pval, n, trunc,
                                              max_el)
    (rrow, rcol, rval), ac = galerkin_rap_device(
        rows, cols, vals, prow, pcol, pval, n, nc, prof=prof)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # the hashes ran on the host between device stages
    prof["device_s"] += time.perf_counter() - t0 - hash_acc[0]
    prof["host_s"] += hash_acc[0]

    t0 = time.perf_counter()
    P = _coo_to_scipy(prow, pcol, pval, (n, nc))
    R = _coo_to_scipy(rrow, rcol, rval, (nc, n))
    Ac = _coo_to_scipy(*ac, (nc, nc))
    prof["host_s"] += time.perf_counter() - t0
    return P, R, Ac
