"""Solver parity of the PyTorch port with the JAX package (CPU).

The same config string, matrix and right-hand side (numpy, from a seed)
go through both packages' ``create_solver(...).setup(A).solve(b)``.
f64: same status and iteration count, x at rtol 1e-10 (iterated
reductions sum in another order than XLA's, so looser than one SpMV's
1e-12).  f32: iterations within one, x at rtol 1e-4.
"""

import warnings

import numpy as np
import pytest
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu_torch.core.errors import SingularDiagonalError
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.solvers.base import SUCCESS

amgx_tpu.initialize()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(solver, extra="", iters=100, tol=1e-8, conv="RELATIVE_INI",
         norm="L2", monitor=1):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{solver}", "max_iters": {iters},'
        f' "monitor_residual": {monitor}, "convergence": "{conv}",'
        f' "tolerance": {tol}, "norm": "{norm}"{extra}}}}}'
    )


JACOBI_PREC = (', "preconditioner": {"scope": "jac", "solver":'
               ' "BLOCK_JACOBI", "max_iters": 4, "monitor_residual": 0}')


def _both(cfg_text, m, dtype, seed=0):
    m = m.astype(dtype)
    b = poisson_rhs(m.shape[0], dtype=dtype, seed=seed)
    js = j_create(JConfig.from_string(cfg_text), "default")
    js.setup(JMatrix.from_scipy(m))
    jr = js.solve(b)
    ts = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(m, device="cpu"))
    tr = ts.solve(b)
    return jr, tr, ts, b


def _assert_parity(jr, tr, dtype):
    xj = np.asarray(jr.x)
    xt = tr.x.numpy()
    assert xt.dtype == xj.dtype
    assert tr.status == int(jr.status)
    if dtype == np.float64:
        assert tr.iters == int(jr.iters)
        rtol = 1e-10
    else:
        assert abs(tr.iters - int(jr.iters)) <= 1
        rtol = 1e-4
    np.testing.assert_allclose(xt, xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())
    n = tr.iters + 1
    np.testing.assert_allclose(
        tr.history[:n], np.asarray(jr.history)[:n], rtol=rtol * 10,
        atol=rtol * float(np.asarray(jr.initial_norm).max()),
    )


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,cfg_text", [
    ("pcg_jacobi", _cfg("PCG", JACOBI_PREC)),
    ("cg", _cfg("CG")),
    ("pcg_noprec", _cfg("PCG", ', "preconditioner": "NOSOLVER"')),
    ("jacobi_monitored", _cfg("BLOCK_JACOBI", ', "relaxation_factor": 0.9',
                              iters=40, tol=1e-3)),
    ("pcg_jacobi_linf_absolute",
     _cfg("PCG", JACOBI_PREC, conv="ABSOLUTE", norm="LMAX", tol=1e-6)),
    ("pcg_jacobi_l1_relmax",
     _cfg("PCG", JACOBI_PREC, conv="RELATIVE_MAX", norm="L1", tol=1e-7)),
])
def test_solver_matches_jax(name, cfg_text, dtype):
    m = poisson_scipy((10, 10, 10))
    jr, tr, _, _ = _both(cfg_text, m, dtype)
    _assert_parity(jr, tr, dtype)
    if name != "jacobi_monitored":
        assert tr.status == SUCCESS


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_unmonitored_fixed_iterations_match_jax(dtype):
    cfg_text = _cfg("PCG", JACOBI_PREC, iters=7, monitor=0)
    jr, tr, _, _ = _both(cfg_text, poisson_scipy((9, 9, 9)), dtype)
    assert tr.iters == int(jr.iters) == 7
    assert tr.status == int(jr.status) == SUCCESS
    rtol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(jr.x)).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_lu_matches_jax(dtype):
    m = poisson_scipy((9, 9))  # 81 rows
    jr, tr, _, b = _both(_cfg("DENSE_LU_SOLVER"), m, dtype)
    assert tr.status == int(jr.status) == SUCCESS
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(jr.x)).max())
    x_ref = np.linalg.solve(m.toarray(), b.astype(np.float64))
    np.testing.assert_allclose(tr.x.numpy(), x_ref, rtol=rtol * 10,
                               atol=rtol * 10 * np.abs(x_ref).max())


def _singular():
    m = poisson_scipy((6, 6)).tolil()
    m[-1, :] = 0.0
    m[:, -1] = 0.0
    return m.tocsr()


def test_dense_lu_zero_pivot_raise():
    cfg = T.AMGConfig.from_string(
        _cfg("DENSE_LU_SOLVER", ', "dense_lu_zero_pivot": "RAISE"')
    )
    s = T.create_solver(cfg, "default", device="cpu")
    with pytest.raises(SingularDiagonalError):
        s.setup(TMatrix.from_scipy(_singular(), device="cpu"))


def test_dense_lu_zero_pivot_regularize_matches_jax():
    """REGULARIZE switches to the pseudoinverse in both packages."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr, tr, ts, _ = _both(_cfg("DENSE_LU_SOLVER"), _singular(),
                              np.float64)
    assert ts._pinv_mode
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("extra,match", [
    (', "scaling": "DIAGONAL_SYMMETRIC"', "scaling"),
    (', "scaling": "BINORMALIZATION"', "scaling"),
    (', "solve_retries": 2', "solve_retries"),
])
def test_unported_options_raise(extra, match):
    cfg = T.AMGConfig.from_string(_cfg("PCG", JACOBI_PREC + extra))
    s = T.create_solver(cfg, "default", device="cpu")
    A = TMatrix.from_scipy(poisson_scipy((4, 4)), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        s.setup(A)


def test_fault_injection_unported(monkeypatch):
    monkeypatch.setenv("AMGX_TPU_FAULTS", "coarse_lu_zero_pivot")
    cfg = T.AMGConfig.from_string(_cfg("PCG", JACOBI_PREC))
    s = T.create_solver(cfg, "default", device="cpu")
    with pytest.raises(NotImplementedError, match="AMGX_TPU_FAULTS"):
        s.setup(TMatrix.from_scipy(poisson_scipy((4, 4)), device="cpu"))


@pytest.mark.parametrize("name", ["IDR", "MULTICOLOR_ILU", "CHEBYSHEV"])
def test_unported_solvers_raise(name):
    cfg = T.AMGConfig.from_string(_cfg(name))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.create_solver(cfg, "default", device="cpu")


def test_solve_accepts_device_tensors_and_checks_device():
    cfg = T.AMGConfig.from_string(_cfg("PCG", JACOBI_PREC))
    s = T.create_solver(cfg, "default", device="cpu")
    A = TMatrix.from_scipy(poisson_scipy((6, 6, 6)), device="cpu")
    s.setup(A)
    b = poisson_rhs(A.n_rows)
    r_np = s.solve(b)
    r_t = s.solve(torch.from_numpy(b), x0=torch.zeros(A.n_rows,
                                                      dtype=torch.float64))
    assert r_np.iters == r_t.iters
    np.testing.assert_array_equal(r_np.x.numpy(), r_t.x.numpy())
    with pytest.raises(ValueError, match="meta"):
        s.solve(torch.empty(A.n_rows, dtype=torch.float64, device="meta"))
