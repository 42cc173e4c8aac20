"""Block matrices in the PyTorch port against the JAX package (CPU).

The same seeded numpy inputs go through both packages, in f64 unless a
test says otherwise:

  * block CSR built by ``from_csr`` / ``from_scipy`` / ``from_coo`` at
    b = 2, 3 and 4: values, ``diag`` (n, b, b) and the block-ELL arrays
    equal to the JAX package's (the port's ELL is slot-major, so its
    arrays are the JAX package's transposed), ``to_scipy`` the same
    expansion, ``replace_values`` the same refilled formats;
  * the block SpMV, ELL and CSR, at rtol 1e-12;
  * ``scalarized``: the same scalar CSR and, on the 8^3 x 4 Poisson
    system, the same 43 DIA offsets and planes;
  * ``invert_diag`` with zero, singular and bf16 blocks;
  * ``block_norm`` / ``get_norm`` for every NormType, and the solvers'
    per-component monitored norms with ``use_scalar_norm`` 0 and 1;
  * ``read_mtx`` / ``write_system`` / ``write_system_binary`` of block
    files.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io import matrix_market as j_mm
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu.ops import diagonal as j_diag
from amgx_tpu.ops import norms as j_norms
from amgx_tpu.ops.spmv import spmv as j_spmv
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.core.types import NormType as TNorm
from amgx_tpu_torch.io import matrix_market as t_mm
from amgx_tpu_torch.ops import diagonal as t_diag
from amgx_tpu_torch.ops import norms as t_norms
from amgx_tpu_torch.ops.spmv import spmv as t_spmv
from amgx_tpu.core.types import NormType as JNorm

amgx_tpu.initialize()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _quiet_expansion():
    # the notice that a block matrix is expanded to scalars
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


def block_system(b, shape=(5, 5, 5), seed=0, coupling=0.2):
    """kron(Poisson, I_b + coupling * R) with R a seeded random b x b
    matrix: a nonsymmetric block system whose blocks are all stored."""
    rng = np.random.default_rng(seed)
    B = np.eye(b) + coupling * rng.standard_normal((b, b))
    return sps.kron(poisson_scipy(shape), B, format="csr")


def random_block(b, n_blocks=20, per_row=4, seed=0, empty_frac=0.1):
    """Random block CSR arrays with varying row lengths (some empty),
    a few zero blocks and duplicate-free sorted columns."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, per_row + 1, n_blocks)
    lens[rng.random(n_blocks) < empty_frac] = 0
    cols = [np.sort(rng.choice(n_blocks, k, replace=False)) for k in lens]
    ro = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ci = np.concatenate(cols).astype(np.int32)
    vals = rng.standard_normal((ci.shape[0], b, b))
    vals[rng.random(ci.shape[0]) < 0.1] = 0.0
    return ro, ci, vals


def _same_matrix(t, j):
    assert t.block_size == j.block_size
    assert (t.n_rows, t.n_cols, t.nnz) == (j.n_rows, j.n_cols, j.nnz)
    assert np.array_equal(t.row_offsets.numpy(), np.asarray(j.row_offsets))
    assert np.array_equal(t.col_indices.numpy(), np.asarray(j.col_indices))
    assert np.array_equal(t.row_ids.numpy(), np.asarray(j.row_ids))
    assert np.array_equal(t.values.numpy(), np.asarray(j.values))
    assert np.array_equal(t.diag.numpy(), np.asarray(j.diag))
    assert t.has_ell == j.has_ell
    assert not (t.has_dia or j.has_dia or t.has_dense or j.has_dense)
    assert t.sell is None
    if t.has_ell:
        # slot-major: (w, n) cols, (w, n, b, b) values
        assert np.array_equal(t.ell_cols.numpy(),
                              np.asarray(j.ell_cols).T)
        assert np.array_equal(t.ell_vals.numpy(),
                              np.asarray(j.ell_vals).swapaxes(0, 1))
    assert (t.to_scipy() != j.to_scipy()).nnz == 0


@pytest.mark.parametrize("b", [2, 3, 4])
@pytest.mark.parametrize("source", ["from_scipy", "from_csr", "from_coo",
                                    "from_csr_no_ell"])
def test_block_upload_matches_jax(source, b):
    if source == "from_scipy":
        sp = block_system(b, seed=b)
        t = TMatrix.from_scipy(sp, block_size=b, device="cpu")
        j = JMatrix.from_scipy(sp, block_size=b)
        assert t.format == "ELL"
    elif source == "from_coo":
        ro, ci, vals = random_block(b, seed=b)
        rows = np.repeat(np.arange(ro.shape[0] - 1), np.diff(ro))
        # shuffled, with one duplicate entry to sum
        perm = np.random.default_rng(b).permutation(ci.shape[0])
        rows = np.concatenate([rows[perm], rows[:1]])
        cols = np.concatenate([ci[perm], ci[:1]])
        v = np.concatenate([vals[perm], vals[:1]])
        t = TMatrix.from_coo(rows, cols, v.reshape(-1), n_rows=20,
                             n_cols=20, block_size=b, device="cpu")
        j = JMatrix.from_coo(rows, cols, v.reshape(-1), n_rows=20,
                             n_cols=20, block_size=b)
    else:
        ro, ci, vals = random_block(b, seed=b)
        fm = ("dia", "dense", "ell") if source == "from_csr" else ()
        t = TMatrix.from_csr(ro, ci, vals.reshape(-1), block_size=b,
                             accel_formats=fm, device="cpu")
        j = JMatrix.from_csr(ro, ci, vals.reshape(-1), block_size=b,
                             accel_formats=fm)
        assert t.format == ("ELL" if fm else "CSR")
    _same_matrix(t, j)
    # replace_values: the same refilled formats
    rng = np.random.default_rng(10 + b)
    v2 = rng.standard_normal(np.asarray(j.values).shape)
    _same_matrix(t.replace_values(v2), j.replace_values(v2))
    _same_matrix(t.replace_values(torch.from_numpy(v2.reshape(-1))),
                 j.replace_values(v2.reshape(-1)))


@pytest.mark.parametrize("b", [2, 3, 4])
def test_block_upload_wrong_length_raises(b):
    ro, ci, vals = random_block(b, seed=b)
    from amgx_tpu_torch.core.errors import PatternDegeneracyError

    for validate in (True, False):
        with pytest.raises(PatternDegeneracyError, match="values for"):
            TMatrix.from_csr(ro, ci, vals.reshape(-1)[:-1], block_size=b,
                             device="cpu", validate=validate)
    A = TMatrix.from_csr(ro, ci, vals, block_size=b, device="cpu")
    with pytest.raises(ValueError, match="values for"):
        A.replace_values(np.ones(A.nnz))
    with pytest.raises(Exception):
        JMatrix.from_csr(ro, ci, vals, block_size=b).replace_values(
            np.ones(A.nnz))


@pytest.mark.parametrize("b", [2, 3, 4])
@pytest.mark.parametrize("fmt", ["ELL", "CSR"])
def test_block_spmv_matches_jax(b, fmt):
    ro, ci, vals = random_block(b, n_blocks=30, seed=20 + b)
    fm = ("ell",) if fmt == "ELL" else ()
    t = TMatrix.from_csr(ro, ci, vals, block_size=b, accel_formats=fm,
                         device="cpu")
    j = JMatrix.from_csr(ro, ci, vals, block_size=b, accel_formats=fm)
    assert t.format == fmt
    x = np.random.default_rng(b).standard_normal(30 * b)
    yt = t_spmv(t, torch.from_numpy(x)).numpy()
    yj = np.asarray(j_spmv(j, x))
    np.testing.assert_allclose(yt, yj, rtol=1e-12,
                               atol=1e-12 * np.abs(yj).max())
    np.testing.assert_allclose(yt, t.to_scipy() @ x, rtol=1e-12,
                               atol=1e-12 * np.abs(yj).max())
    # a leading window of block rows
    yw = t_spmv(t, torch.from_numpy(x), n_rows=7).numpy()
    assert np.array_equal(yw, yt[:7 * b])


def test_scalarized_matches_jax_43_diagonals():
    """The b = 4 Poisson system at 8^3: the expansion is DIA with the
    JAX package's 43 offsets and planes, its CSR entry for entry."""
    b = 4
    sp = sps.kron(poisson_scipy((8, 8, 8)),
                  np.eye(b) + 0.2 * np.ones((b, b)), format="csr")
    t = t_diag.scalarized(TMatrix.from_scipy(sp, block_size=b,
                                             device="cpu"), "AMG")
    j = j_diag.scalarized(JMatrix.from_scipy(sp, block_size=b), "AMG")
    assert t.block_size == 1 and t.format == "DIA"
    assert t.dia_offsets == j.dia_offsets and len(t.dia_offsets) == 43
    assert np.array_equal(t.dia_vals.numpy(), np.asarray(j.dia_vals))
    assert np.array_equal(t.row_offsets.numpy(), np.asarray(j.row_offsets))
    assert np.array_equal(t.col_indices.numpy(), np.asarray(j.col_indices))
    assert np.array_equal(t.values.numpy(), np.asarray(j.values))
    # a random block matrix with zero blocks: zeros dropped as in JAX
    ro, ci, vals = random_block(3, seed=5)
    t2 = t_diag.scalarized(TMatrix.from_csr(ro, ci, vals, block_size=3,
                                            device="cpu"), "GS")
    j2 = j_diag.scalarized(JMatrix.from_csr(ro, ci, vals, block_size=3),
                           "GS")
    assert t2.format == ("DIA" if j2.has_dia else "dense" if j2.has_dense
                         else "ELL" if j2.has_ell else "CSR")
    assert np.array_equal(t2.values.numpy(), np.asarray(j2.values))
    assert np.array_equal(t2.col_indices.numpy(),
                          np.asarray(j2.col_indices))
    assert t_diag.scalarized(t2, "GS") is t2


def _zero_and_singular_blocks(b=2, n_blocks=6, seed=0):
    rng = np.random.default_rng(seed)
    blocks = [rng.standard_normal((b, b)) + 3 * np.eye(b)
              for _ in range(n_blocks)]
    blocks[2] = np.zeros((b, b))  # exactly zero
    blocks[4] = np.ones((b, b))  # exactly singular
    dense = np.zeros((n_blocks * b, n_blocks * b))
    for i, blk in enumerate(blocks):
        dense[i * b:(i + 1) * b, i * b:(i + 1) * b] = blk
    dense[:b, -b:] = 0.5  # one off-diagonal block
    return sps.csr_matrix(dense), blocks


@pytest.mark.parametrize("b", [2, 3])
def test_invert_diag_zero_and_singular_blocks(b):
    """A zero and a singular diagonal block take the identity, the
    others invert, as in the JAX package."""
    sp, blocks = _zero_and_singular_blocks(b)
    t = t_diag.invert_diag(TMatrix.from_scipy(sp, block_size=b,
                                              device="cpu")).numpy()
    j = np.asarray(j_diag.invert_diag(JMatrix.from_scipy(sp,
                                                         block_size=b)))
    assert t.shape == (6, b, b)
    assert np.array_equal(t, j)
    np.testing.assert_array_equal(t[2], np.eye(b))
    np.testing.assert_array_equal(t[4], np.eye(b))
    np.testing.assert_allclose(t[0] @ blocks[0], np.eye(b), atol=1e-12)
    # the scalar policy: 1 / d, 1 where d == 0
    d = TMatrix.from_scipy(sp, device="cpu")
    np.testing.assert_array_equal(
        t_diag.invert_diag(d).numpy(),
        np.asarray(j_diag.invert_diag(JMatrix.from_scipy(sp))))


def test_block_invert_diag_preserves_bf16():
    """A bf16 block matrix keeps its (n, b, b) diagonal, and its
    inverted blocks come back in bf16, rounded once from f32 as the JAX
    package's are."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    blocks = [sps.csr_matrix(rng.standard_normal((2, 2)) + 3 * np.eye(2))
              if i == j else None for i in range(4) for j in range(4)]
    bs = sps.block_array([blocks[4 * i:4 * i + 4] for i in range(4)])
    bs = bs.tocsr().astype(np.float32)
    t = TMatrix.from_scipy(bs, block_size=2, device="cpu").astype(
        torch.bfloat16)
    j = JMatrix.from_scipy(bs, block_size=2).astype(jnp.bfloat16)
    assert t.diag.dtype == torch.bfloat16 and t.diag.shape == (4, 2, 2)
    assert t.ell_vals.dtype == torch.bfloat16
    ti = t_diag.invert_diag(t)
    ji = j_diag.invert_diag(j)
    assert ti.dtype == torch.bfloat16 and str(ji.dtype) == "bfloat16"
    assert np.array_equal(ti.float().numpy(),
                          np.asarray(ji).astype(np.float32))


@pytest.mark.parametrize("b", [2, 4])
def test_apply_dinv_matches_jax(b):
    sp = block_system(b, shape=(4, 4), seed=7)
    t = TMatrix.from_scipy(sp, block_size=b, device="cpu")
    j = JMatrix.from_scipy(sp, block_size=b)
    r = np.random.default_rng(1).standard_normal(sp.shape[0])
    zt = t_diag.apply_dinv(t_diag.invert_diag(t), torch.from_numpy(r),
                           b).numpy()
    zj = np.asarray(j_diag.apply_dinv(j_diag.invert_diag(j), r, b))
    np.testing.assert_allclose(zt, zj, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("scalar", [0, 1])
@pytest.mark.parametrize("norm", ["L1", "L1_SCALED", "L2", "LMAX"])
def test_block_norms_match_jax(norm, scalar):
    b = 3
    sp = block_system(b, shape=(4, 4))
    t = TMatrix.from_scipy(sp, block_size=b, device="cpu")
    j = JMatrix.from_scipy(sp, block_size=b)
    r = np.random.default_rng(2).standard_normal(sp.shape[0])
    nt = t_norms.get_norm(t, torch.from_numpy(r), TNorm(norm),
                          use_scalar_norm=scalar).numpy()
    nj = np.asarray(j_norms.get_norm(j, r, JNorm(norm),
                                     use_scalar_norm=scalar))
    assert nt.shape == nj.shape == (() if scalar else (b,))
    np.testing.assert_allclose(nt, nj, rtol=1e-13)
    bt = t_norms.block_norm(torch.from_numpy(r), b, TNorm(norm)).numpy()
    np.testing.assert_allclose(bt, np.asarray(j_norms.block_norm(
        r, b, JNorm(norm))), rtol=1e-13)


@pytest.mark.parametrize("b", [2, 3, 4])
def test_block_mtx_roundtrip_matches_jax(tmp_path, b):
    """``write_system`` of a block matrix writes the block header and
    values; both packages read it back to the same block matrix, and
    the binary writer gives both the same matrix too."""
    ro, ci, vals = random_block(b, seed=30 + b)
    t = TMatrix.from_csr(ro, ci, vals, block_size=b, device="cpu")
    rhs = np.random.default_rng(b).standard_normal(20 * b)
    p = tmp_path / "block.mtx"
    t_mm.write_system(p, t, rhs=rhs)
    head = p.read_text().splitlines()[1]
    assert f"block_dimx {b} block_dimy {b}" in head
    pj = tmp_path / "block_jax.mtx"
    j_mm.write_system(pj, JMatrix.from_csr(ro, ci, vals, block_size=b),
                      rhs=rhs)
    assert p.read_text() == pj.read_text()
    for path in (p, pj):
        tr = t_mm.read_mtx(path, device="cpu")
        jr = j_mm.read_mtx(path)
        assert tr.block_size == b
        _same_matrix(tr, jr)
    pb = tmp_path / "block.bin"
    t_mm.write_system_binary(pb, t, rhs=rhs)
    _same_matrix(t_mm.read_mtx(pb, device="cpu"), j_mm.read_mtx(pb))
    A, rr, _ = t_mm.read_system(pb)
    np.testing.assert_array_equal(rr, rhs)


def test_rectangular_blocks_raise_in_both(tmp_path):
    p = tmp_path / "rect.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "%%AMGX block_dimx 2 block_dimy 1\n"
        "1 1 1\n"
        "1 1 2.0 3.0\n")
    with pytest.raises(t_mm.MatrixIOError, match="rectangular"):
        t_mm.read_mtx(p, device="cpu")
    with pytest.raises(j_mm.MatrixIOError, match="rectangular"):
        j_mm.read_mtx(p)
