"""The upload's DIA planes and diagonal (``core/matrix.py``
``_try_build_dia_np``, ``_extract_diag_np``) bit for bit against their
``ufunc.at`` scatters, which they take only where a (row, column) pair
repeats or a row's columns are not sorted: sorted, unsorted and
duplicated CSR inputs, with -0.0, NaN and infinite values, scalar and
block values.  And the serve layer's padded pattern
(``serve/bucketing.py`` ``pad_pattern``, its free slots found by a mask)
equal to the JAX package's on Poisson, empty-row and irregular
patterns; the Poisson matrices (``io/poisson.py`` ``poisson_scipy``,
assembled directly) bit for bit the JAX package's Kronecker sums, and
the serve layer's jittered family (``jittered_poisson_family``, its
symmetrization a gather of each entry's transpose) bit for bit the JAX
package's sparse sums."""

import numpy as np
import pytest

from amgx_tpu_torch.core import matrix as cm


def _dia_at(row_offsets, col_indices, values, row_ids, n):
    """The scatters with ``ufunc.at`` (duplicates sum, the first entry
    of a position is its source)."""
    offs = col_indices.astype(np.int64) - row_ids.astype(np.int64)
    uniq = np.unique(offs)
    dia_vals = np.zeros((uniq.shape[0], n), dtype=values.dtype)
    k = np.searchsorted(uniq, offs)
    np.add.at(dia_vals, (k, row_ids), values)
    sentinel = np.iinfo(np.int32).max
    dia_src = np.full((uniq.shape[0], n), sentinel, dtype=np.int32)
    np.minimum.at(dia_src, (k, row_ids),
                  np.arange(col_indices.shape[0], dtype=np.int32))
    dia_src[dia_src == sentinel] = -1
    return tuple(int(o) for o in uniq), dia_vals, dia_src


def _diag_at(row_offsets, col_indices, values, n_rows):
    diag = np.zeros((n_rows,) + values.shape[1:], dtype=values.dtype)
    row_ids = cm._row_ids_np(row_offsets, n_rows)
    hit = col_indices == row_ids
    np.add.at(diag, row_ids[hit], values[hit])
    return diag


def _csr(kind, dtype, seed=0, n=40, block=1):
    """A banded CSR (``n`` rows): its rows' columns sorted, reversed
    (``unsorted``) or with repeats (``duplicates``)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        # a band of 5 diagonals (DIA's gate takes it), rows of 3-5
        cols = list(range(max(i - 2, 0), min(i + 3, n)))
        if kind == "unsorted" and len(cols) > 1:
            cols = cols[::-1]
        if kind == "duplicates" and i % 5 == 0:
            cols = cols + [i, cols[0]]
        rows.append(cols)
    row_offsets = np.cumsum([0] + [len(c) for c in rows]).astype(np.int32)
    col_indices = np.array([c for r in rows for c in r], np.int32)
    shape = (col_indices.shape[0],) + ((block, block) if block > 1 else ())
    values = rng.standard_normal(shape).astype(dtype)
    flat = values.reshape(-1)
    flat[::7] = -0.0
    flat[3] = np.nan
    flat[11] = -np.inf
    return row_offsets, col_indices, values, n


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


KINDS = ("sorted", "unsorted", "duplicates")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_planes_bitwise_the_scatter(kind, dtype):
    ro, ci, v, n = _csr(kind, dtype)
    rid = cm._row_ids_np(ro, n)
    assert cm._entries_unique(rid, ci) == (kind == "sorted")
    got = cm._try_build_dia_np(ro, ci, v, rid, n)
    want = _dia_at(ro, ci, v, rid, n)
    assert got[0] == want[0]
    assert _same(got[1], want[1]) and _same(got[2], want[2])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block", [1, 3])
def test_diagonal_bitwise_the_scatter(kind, block):
    ro, ci, v, n = _csr(kind, np.float64, seed=1, block=block)
    assert _same(cm._extract_diag_np(ro, ci, v, n), _diag_at(ro, ci, v, n))


def test_negative_zero_becomes_positive_as_in_the_scatter():
    ro = np.array([0, 1, 2], np.int32)
    ci = np.array([0, 1], np.int32)
    v = np.array([-0.0, 2.0])
    rid = cm._row_ids_np(ro, 2)
    planes = cm._try_build_dia_np(ro, ci, v, rid, 2)[1]
    assert not np.signbit(planes[0, 0])
    assert not np.signbit(cm._extract_diag_np(ro, ci, v, 2)[0])


def _patterns():
    import scipy.sparse as sps

    from amgx_tpu_torch.io.poisson import poisson_scipy

    rng = np.random.default_rng(3)
    irregular = sps.random(300, 300, density=0.02, random_state=4,
                           format="csr") + sps.eye(300, format="csr")
    empty_rows = sps.csr_matrix(
        (np.ones(5), ([0, 2, 2, 7, 9], [0, 1, 2, 7, 9])), shape=(10, 10))
    return {"poisson_3d": poisson_scipy((6, 7, 5)).tocsr(),
            "poisson_1d": poisson_scipy((13,)).tocsr(),
            "irregular": irregular.tocsr(), "empty_rows": empty_rows,
            "one_row": sps.csr_matrix(rng.standard_normal((1, 1)))}


PATTERNS = _patterns()


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_padded_pattern_equals_jax(name):
    from amgx_tpu.serve.bucketing import pad_pattern as jax_pad

    from amgx_tpu_torch.serve.bucketing import pad_pattern

    sp = PATTERNS[name]
    sp.sort_indices()
    t = pad_pattern(sp.indptr, sp.indices, sp.shape[0])
    j = jax_pad(sp.indptr, sp.indices, sp.shape[0])
    for f in ("row_offsets", "col_indices", "scatter", "ones_pos"):
        a, b = np.asarray(getattr(t, f)), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("n", "nnz", "nb", "nnzb", "max_row_len", "num_diagonals",
              "fingerprint"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("shape", [(1,), (7,), (1, 1), (4, 6), (5, 1),
                                   (3, 4, 5), (1, 1, 1), (2, 1, 3),
                                   (6, 7, 5), (2, 2, 2, 2), (16, 8, 32)])
def test_poisson_matrix_bitwise_jax(shape):
    from amgx_tpu.io.poisson import poisson_scipy as jax_poisson

    from amgx_tpu_torch.io.poisson import poisson_scipy

    t, j = poisson_scipy(shape), jax_poisson(shape)
    assert type(t) is type(j) and t.shape == j.shape
    for f in ("indptr", "indices", "data"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("shape, count, seed, jitter", [
    ((7,), 3, 0, 0.08), ((4, 6), 3, 2, 0.3), ((3, 4, 5), 4, 5, 0.08),
    ((1,), 2, 0, 0.08), ((1, 1, 1), 2, 3, 0.08), ((2, 1, 3), 2, 3, 0.08),
    ((16, 8, 32), 2, 11, 0.05)])
def test_jittered_family_bitwise_jax(shape, count, seed, jitter):
    from amgx_tpu.io.poisson import jittered_poisson_family as jax_family

    from amgx_tpu_torch.io.poisson import jittered_poisson_family

    got = jittered_poisson_family(shape, count, seed=seed, jitter=jitter)
    want = jax_family(shape, count, seed=seed, jitter=jitter)
    assert len(got) == len(want) == count
    for (t, tb), (j, jb) in zip(got, want):
        assert type(t) is type(j) and t.shape == j.shape
        assert t.has_sorted_indices and j.has_sorted_indices
        for f in ("indptr", "indices", "data"):
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert _same(tb, jb)
