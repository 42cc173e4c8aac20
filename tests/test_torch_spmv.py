"""SpMV parity of the PyTorch port with the JAX package.

On the CPU each kernel wrapper takes its plain PyTorch version, so these
tests hold the plain versions (the kernels' CPU twins) to:

  * the Pallas kernels in interpret mode, as the JAX package's own tests
    run them: ``pallas_dia_spmv`` (f32, rtol 2e-5, as
    tests/test_pallas_dia.py) and ``pallas_well_spmv`` with the windowed
    arrays forced on the CPU (``AMGX_TPU_TILED_ELL=1``);
  * the JAX package's XLA paths (``_spmv_dia``, the ELL gather, dense,
    CSR segment sum) in f64 at rtol 1e-12: same products, summed in the
    same order up to rounding.

The kernels themselves run only on the card (``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu.ops import pallas_dia as pd
from amgx_tpu.ops import pallas_well as pw
from amgx_tpu_torch.amg.aggregation import geo_aggregate
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.ops import dia, ell
from amgx_tpu_torch.ops import spmv as tspmv

# the module (amgx_tpu.ops re-exports its function under the same name)
jspmv = importlib.import_module("amgx_tpu.ops.spmv")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _x(n, dtype, seed=3):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _tspmv(T, x):
    return tspmv.spmv(T, torch.from_numpy(x)).numpy()


def _unaligned(n=5000, offs=(-301, -7, 0, 7, 301), seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), n - max(0, o))
        rows.append(r)
        cols.append(r + o)
        vals.append(rng.standard_normal(r.shape[0]))
    return sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()


def _banded_random(n, w, bw, seed=7):
    """Random matrix whose columns stay within +-bw of the diagonal (the
    locality the windowed-ELL kernel needs)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), w)
    c = np.clip(r + rng.integers(-bw, bw + 1, r.shape), 0, n - 1)
    m = sps.coo_matrix((rng.standard_normal(r.shape), (r, c)),
                       shape=(n, n)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return m


def _transfer(n_side):
    agg = geo_aggregate(n_side, n_side, n_side, 3)
    n = agg.shape[0]
    return sps.csr_matrix(
        (np.ones(n), (np.arange(n), agg)), shape=(n, int(agg.max()) + 1)
    )


# ---------------------------------------------------------------- DIA


@pytest.mark.parametrize("case", ["poisson3d_12", "poisson3d_24",
                                  "unaligned"])
def test_dia_plain_matches_pallas_interpret(case):
    m = {
        "poisson3d_12": lambda: poisson_scipy((12, 12, 12)),
        "poisson3d_24": lambda: poisson_scipy((24, 24, 24)),
        "unaligned": _unaligned,
    }[case]().astype(np.float32)
    J = JMatrix.from_scipy(m)
    T = TMatrix.from_scipy(m, device="cpu")
    assert T.format == "DIA"
    x = _x(m.shape[0], np.float32)
    y_pallas = np.asarray(pd.pallas_dia_spmv(J, x, interpret=True))
    np.testing.assert_allclose(_tspmv(T, x), y_pallas, rtol=2e-5, atol=2e-5)


def test_dia_plain_matches_pallas_multiblock_interpret(monkeypatch):
    """More rows than one Pallas row block (the case of
    tests/test_pallas_dia.py's multiblock test)."""
    monkeypatch.setattr(pd, "_ROW_BLOCK", 2048)
    m = poisson_scipy((70, 70)).astype(np.float32)  # 4900 rows, 3 blocks
    J = JMatrix.from_scipy(m)
    T = TMatrix.from_scipy(m, device="cpu")
    x = _x(m.shape[0], np.float32, seed=5)
    y_pallas = np.asarray(pd.pallas_dia_spmv(J, x, interpret=True))
    np.testing.assert_allclose(_tspmv(T, x), y_pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["poisson3d_12", "poisson2d_70",
                                  "unaligned", "poisson3d_8"])
def test_dia_plain_matches_xla_f64(case):
    m = {
        "poisson3d_12": lambda: poisson_scipy((12, 12, 12)),
        "poisson2d_70": lambda: poisson_scipy((70, 70)),
        "unaligned": _unaligned,
        "poisson3d_8": lambda: poisson_scipy((8, 8, 8)),
    }[case]()
    J = JMatrix.from_scipy(m)
    T = TMatrix.from_scipy(m, device="cpu")
    x = _x(m.shape[0], np.float64)
    y_xla = np.asarray(jspmv._spmv_dia(J, x))
    y = dia.dia_spmv_plain(T.dia_vals, T.dia_offsets, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_xla, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- ELL


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["banded_square", "P_24", "R_24"])
def test_ell_plain_matches_xla_gather(case, dtype):
    m = {
        "banded_square": lambda: _banded_random(6000, 6, 500, seed=11),
        "P_24": lambda: _transfer(24),
        "R_24": lambda: _transfer(24).T.tocsr(),
    }[case]().astype(dtype)
    J = JMatrix.from_scipy(m)
    T = TMatrix.from_scipy(m, device="cpu")
    assert T.format == "ELL" and J.ell_wcols is None
    x = _x(m.shape[1], dtype)
    y_xla = np.asarray(jspmv.spmv(J, x))
    rtol = 1e-12 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(_tspmv(T, x), y_xla, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("case", ["banded_square", "R_24"])
def test_ell_plain_matches_pallas_well_interpret(monkeypatch, case):
    monkeypatch.setenv("AMGX_TPU_TILED_ELL", "1")
    m = {
        "banded_square": lambda: _banded_random(6000, 6, 500, seed=11),
        "R_24": lambda: _transfer(24).T.tocsr(),
    }[case]().astype(np.float32)
    J = JMatrix.from_scipy(m)
    assert J.ell_wcols is not None
    T = TMatrix.from_scipy(m, device="cpu")
    x = _x(m.shape[1], np.float32, seed=5)
    y_pallas = np.asarray(pw.pallas_well_spmv(J, x, interpret=True))
    np.testing.assert_allclose(_tspmv(T, x), y_pallas, rtol=2e-5, atol=2e-5)


def test_ell_plain_empty_rows_and_padding():
    """Rows shorter than w hit padding slots (column 0, value 0)."""
    rng = np.random.default_rng(4)
    m = sps.random(7000, 900, density=0.004, random_state=rng,
                   format="csr")
    T = TMatrix.from_scipy(m, device="cpu", accel_formats=("ell",))
    assert T.format == "ELL"
    assert (np.diff(m.indptr) == 0).any()
    x = _x(900, np.float64)
    np.testing.assert_allclose(_tspmv(T, x), m @ x, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------- dispatch, counts


@pytest.mark.parametrize("formats,want", [
    (("dia", "dense", "ell"), "DIA"), (("dense",), "dense"),
    (("ell",), "ELL"), ((), "CSR"),
])
def test_spmv_dispatch_matches_jax(formats, want):
    m = poisson_scipy((10, 10, 10))
    J = JMatrix.from_scipy(m, accel_formats=formats)
    T = TMatrix.from_scipy(m, accel_formats=formats, device="cpu")
    assert T.format == want
    x = _x(m.shape[0], np.float64)
    np.testing.assert_allclose(_tspmv(T, x), np.asarray(jspmv.spmv(J, x)),
                               rtol=1e-12, atol=1e-12)
    r = tspmv.residual(T, torch.from_numpy(x), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(r, x - m @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_csr_spmv_complex_matches_jax(dtype):
    """A complex operator on the CSR path (rows of 0 to 40 entries)
    against the JAX package's CSR segment sum; the port's row sums
    repeat bit for bit."""
    rng = np.random.default_rng(11)
    n = 300
    lens = rng.integers(0, 41, n)
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, rows.shape[0])
    vals = (rng.standard_normal(rows.shape[0])
            + 1j * rng.standard_normal(rows.shape[0]))
    m = sps.csr_matrix((vals, (rows, cols)), shape=(n, n)).astype(dtype)
    J = JMatrix.from_scipy(m, accel_formats=())
    T = TMatrix.from_scipy(m, accel_formats=(), device="cpu")
    assert T.format == "CSR"
    x = (_x(n, np.float64) + 1j * _x(n, np.float64, seed=4)).astype(dtype)
    y = _tspmv(T, x)
    assert y.dtype == dtype
    tol = 1e-12 if dtype == np.complex128 else 1e-5
    np.testing.assert_allclose(y, np.asarray(jspmv.spmv(J, x)),
                               rtol=tol, atol=tol * np.abs(y).max())
    np.testing.assert_allclose(y, m @ x, rtol=tol,
                               atol=tol * np.abs(y).max())
    assert _tspmv(T, x).tobytes() == y.tobytes()


def test_op_pass_counter_counts_square_only():
    A = TMatrix.from_scipy(poisson_scipy((8, 8, 8)), device="cpu")
    P = TMatrix.from_scipy(_transfer(8), device="cpu")
    x = torch.zeros(512, dtype=torch.float64)
    xc = torch.zeros(P.n_cols, dtype=torch.float64)
    with tspmv.op_pass_counter() as c:
        tspmv.spmv(A, x)
        tspmv.spmv(P, xc)
        tspmv.spmv(A, x)
    assert c.count == 2
    tspmv.spmv(A, x)  # outside the counter: not recorded
    assert c.count == 2


def test_cpu_tensors_take_plain_versions_without_launch_counts():
    A = TMatrix.from_scipy(poisson_scipy((8, 8, 8)), device="cpu")
    R = TMatrix.from_scipy(_transfer(8).T.tocsr(), device="cpu",
                           accel_formats=("ell",))
    d0, e0 = dia.launches, ell.launches
    x = torch.from_numpy(_x(512, np.float64))
    y = dia.dia_spmv(A.dia_vals, A.dia_offsets_dev, x)
    np.testing.assert_array_equal(
        y.numpy(), dia.dia_spmv_plain(A.dia_vals, A.dia_offsets, x).numpy()
    )
    ell.ell_spmv(R.ell_cols, R.ell_vals, x)
    assert (dia.launches, ell.launches) == (d0, e0)


def test_non_cpu_tensors_never_take_plain_versions():
    """A tensor off the CPU goes to the kernel or raises; the kernel
    needs a CUDA tensor, so a meta tensor raises."""
    vals = torch.empty((7, 512), dtype=torch.float32, device="meta")
    offs = torch.empty((7,), dtype=torch.int32, device="meta")
    x = torch.empty((512,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dia.dia_spmv(vals, offs, x)
    cols = torch.empty((8, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ell.ell_spmv(cols, vals[:1].expand(8, 512).contiguous(), x)


# ------------------------------------------------------------ BLAS, norms


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_dots_and_norms_match_jax(dtype):
    from amgx_tpu.core.types import NormType as JNorm
    from amgx_tpu.ops.blas import dot as j_dot
    from amgx_tpu.ops.blas import fused_dots as j_fused
    from amgx_tpu.ops.norms import norm as j_norm
    from amgx_tpu_torch.core.types import NormType as TNorm
    from amgx_tpu_torch.ops.blas import dot, fused_dots
    from amgx_tpu_torch.ops.norms import norm

    rng = np.random.default_rng(8)

    def vec():
        v = rng.standard_normal(1000)
        if dtype == np.complex128:
            v = v + 1j * rng.standard_normal(1000)
        return v.astype(dtype)

    x, y, z = vec(), vec(), vec()
    tx, ty, tz = (torch.from_numpy(v) for v in (x, y, z))
    np.testing.assert_allclose(dot(tx, ty).numpy(), np.asarray(j_dot(x, y)),
                               rtol=1e-12)
    np.testing.assert_allclose(
        fused_dots([(tx, ty), (tz, tx)]).numpy(),
        np.asarray(j_fused([(x, y), (z, x)])), rtol=1e-12,
    )
    for name in ("L1", "L1_SCALED", "L2", "LMAX"):
        np.testing.assert_allclose(
            norm(tx, TNorm(name)).numpy(),
            np.asarray(j_norm(x, JNorm(name))), rtol=1e-12,
        )
