"""Parity of the PyTorch port's SparseMatrix with the JAX package's.

The same host CSR arrays, made with numpy from a seed, go through both
packages' ``from_csr``/``from_scipy``; the formats built (DIA, dense,
ELL, CSR) and every array must match exactly — both run the same numpy
code.  The port stores ELL slot-major, so its arrays are compared
with the JAX package's (n_rows, w) arrays transposed.  The port runs on
the CPU here (``device="cpu"``).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy as j_poisson_scipy
from amgx_tpu_torch.amg.aggregation import geo_aggregate
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.io.poisson import poisson_3d_7pt, poisson_scipy


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jformat(A):
    if A.has_dia:
        return "DIA"
    if A.has_dense:
        return "dense"
    if A.has_ell:
        return "ELL"
    return "CSR"


def _transfer(n_side, passes=3):
    """Aggregation prolongation of an n_side^3 grid (binary, w=1)."""
    agg = geo_aggregate(n_side, n_side, n_side, passes)
    n = agg.shape[0]
    return sps.csr_matrix(
        (np.ones(n), (np.arange(n), agg)), shape=(n, int(agg.max()) + 1)
    )


def _random(n_rows, n_cols, per_row, seed, empty_frac=0.0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, per_row + 1, n_rows)
    lens[rng.random(n_rows) < empty_frac] = 0
    r = np.repeat(np.arange(n_rows), lens)
    c = rng.integers(0, n_cols, r.shape[0])
    m = sps.csr_matrix(
        (rng.standard_normal(r.shape[0]), (r, c)), shape=(n_rows, n_cols)
    )
    m.sum_duplicates()
    m.sort_indices()
    return m


def _with_duplicates(seed):
    """Banded COO matrix with repeated (row, col) entries kept in CSR:
    every format must sum them."""
    rng = np.random.default_rng(seed)
    n = 300
    r = np.concatenate([np.arange(n), np.arange(n), np.arange(1, n)])
    c = np.concatenate([np.arange(n), np.arange(n), np.arange(n - 1)])
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    v = rng.standard_normal(r.shape[0])
    ro = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ro, r + 1, 1)
    return np.cumsum(ro), c, v, n


CASES = {
    "poisson2d_70": lambda: j_poisson_scipy((70, 70)),
    "poisson3d_12": lambda: j_poisson_scipy((12, 12, 12)),
    "poisson3d_8_dia": lambda: j_poisson_scipy((8, 8, 8)),
    "random_square_dense": lambda: _random(300, 300, 6, seed=1),
    "random_square_ell": lambda: _random(6000, 6000, 5, seed=2),
    "random_rect_empty_rows": lambda: _random(7000, 900, 4, seed=3,
                                              empty_frac=0.2),
    "wide_random_csr": lambda: _random(5000, 5000, 120, seed=4,
                                       empty_frac=0.9),
    "P_24": lambda: _transfer(24),
    "R_24": lambda: _transfer(24).T.tocsr(),
    "P_16_dense": lambda: _transfer(16),
    "R_16_dense": lambda: _transfer(16).T.tocsr(),
}


def _assert_same(J, T):
    assert (T.n_rows, T.n_cols, T.nnz) == (J.n_rows, J.n_cols, J.nnz)
    assert T.format == _jformat(J)
    for name in ("row_offsets", "col_indices", "values", "row_ids", "diag"):
        np.testing.assert_array_equal(
            getattr(T, name).numpy(), np.asarray(getattr(J, name)),
            err_msg=name,
        )
    assert T.has_dia == J.has_dia
    if J.has_dia:
        assert T.dia_offsets == tuple(J.dia_offsets)
        np.testing.assert_array_equal(
            T.dia_offsets_dev.numpy(), np.asarray(J.dia_offsets)
        )
        assert T.dia_offsets_dev.dtype == torch.int32
        np.testing.assert_array_equal(T.dia_vals.numpy(),
                                      np.asarray(J.dia_vals))
    assert T.has_dense == J.has_dense
    if J.has_dense:
        np.testing.assert_array_equal(T.dense.numpy(), np.asarray(J.dense))
    assert T.has_ell == J.has_ell
    if J.has_ell:
        # slot-major (w, n) in the port, (n, w) in the JAX package
        np.testing.assert_array_equal(T.ell_cols.numpy(),
                                      np.asarray(J.ell_cols).T)
        np.testing.assert_array_equal(T.ell_vals.numpy(),
                                      np.asarray(J.ell_vals).T)
        assert T.ell_cols.is_contiguous() and T.ell_vals.is_contiguous()
        assert T.ell_cols.dtype == torch.int32


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_from_scipy_matches_jax(case, dtype):
    m = CASES[case]().astype(dtype)
    J = JMatrix.from_scipy(m)
    T = TMatrix.from_scipy(m, device="cpu")
    _assert_same(J, T)
    assert T.device == torch.device("cpu")
    assert T.values.dtype == (torch.float32 if dtype == np.float32
                              else torch.float64)


def test_expected_formats():
    """The formats the main path relies on: stencil levels are DIA, the
    level-0 transfers of a 24^3 grid are ELL (P w=1, R w=8), and 16^3
    transfers fit the dense gate."""
    fmt = {k: TMatrix.from_scipy(CASES[k](), device="cpu") for k in
           ("poisson3d_12", "P_24", "R_24", "P_16_dense",
            "random_square_ell", "wide_random_csr")}
    assert fmt["poisson3d_12"].format == "DIA"
    assert fmt["poisson3d_12"].dia_offsets == (-144, -12, -1, 0, 1, 12, 144)
    assert fmt["P_24"].format == "ELL"
    assert tuple(fmt["P_24"].ell_vals.shape) == (1, 13824)
    assert tuple(fmt["R_24"].ell_vals.shape) == (8, 1728)
    assert fmt["P_16_dense"].format == "dense"
    assert fmt["random_square_ell"].format == "ELL"
    assert fmt["wide_random_csr"].format == "CSR"


def test_duplicates_sum_in_every_format():
    ro, ci, v, n = _with_duplicates(seed=5)
    ref = sps.csr_matrix((v, ci, ro), shape=(n, n)).toarray()
    for formats in (("dia",), ("dense",), ("ell",), ()):
        J = JMatrix.from_csr(ro, ci, v, accel_formats=formats)
        T = TMatrix.from_csr(ro, ci, v, accel_formats=formats, device="cpu")
        _assert_same(J, T)
        np.testing.assert_allclose(T.diag.numpy(), np.diag(ref), rtol=0,
                                   atol=1e-15)


def test_accel_formats_restrict():
    m = j_poisson_scipy((12, 12, 12))
    for formats, want in ((("dia",), "DIA"), (("dense",), "dense"),
                          (("ell",), "ELL"), ((), "CSR")):
        J = JMatrix.from_scipy(m, accel_formats=formats)
        T = TMatrix.from_scipy(m, accel_formats=formats, device="cpu")
        assert T.format == want
        _assert_same(J, T)


def test_poisson_generators_match():
    T = poisson_3d_7pt(6, dtype=np.float32, device="cpu")
    m = j_poisson_scipy((6, 6, 6)).astype(np.float32)
    np.testing.assert_array_equal(T.to_dense(), m.toarray())
    assert (poisson_scipy((5, 4, 3)) != j_poisson_scipy((5, 4, 3))).nnz == 0


def test_host_csr_roundtrip():
    m = _random(400, 300, 5, seed=9)
    T = TMatrix.from_scipy(m, device="cpu")
    assert (T.host_csr() != m).nnz == 0
    s = T.to_scipy()
    s.data[:] = 0.0  # a copy: the matrix keeps its values
    assert (T.host_csr() != m).nnz == 0


def test_malformed_csr_raises():
    from amgx_tpu_torch.core.errors import PatternDegeneracyError

    m = j_poisson_scipy((4, 4))
    with pytest.raises(PatternDegeneracyError, match="values"):
        TMatrix.from_csr(m.indptr, m.indices, m.data[:-1], device="cpu")
    with pytest.raises(PatternDegeneracyError, match="column"):
        TMatrix.from_csr(m.indptr, m.indices + 1, m.data, device="cpu")


def test_block_and_bf16_unported():
    """A block upload builds the JAX package's block CSR and block ELL;
    float16 is still not uploaded from the host."""
    m = j_poisson_scipy((4, 4))
    t = TMatrix.from_scipy(m, block_size=2, device="cpu")
    j = JMatrix.from_scipy(m, block_size=2)
    assert t.block_size == j.block_size == 2
    assert t.format == _jformat(j) == "ELL"
    assert np.array_equal(t.values.numpy(), np.asarray(j.values))
    assert np.array_equal(t.diag.numpy(), np.asarray(j.diag))
    assert np.array_equal(t.ell_vals.numpy(),
                          np.asarray(j.ell_vals).swapaxes(0, 1))
    assert (t.to_scipy() != m).nnz == 0
    with pytest.raises(NotImplementedError, match="float16"):
        TMatrix.from_csr(m.indptr, m.indices, m.data.astype(np.float16),
                         device="cpu")
