"""Parity of the port's colour-sweep smoothers and the rest of the
Krylov family with the JAX package (CPU).

  * MULTICOLOR_DILU: the host setup is a copy of the JAX package's, so
    E and the per-colour compact ELL slices of L and U must be equal
    bit for bit in f64; one application of M^-1 agrees at rtol 1e-12
    (f64) and 2e-5 (f32), as a single SpMV does.
  * MULTICOLOR_GS (plain and symmetric), GS, FIXCOLOR_GS, JACOBI_L1 and
    MULTICOLOR_DILU as smoothers: two sweeps from the same start, at
    the same tolerances.
  * FGMRES, GMRES, PCGF, PBICGSTAB and BICGSTAB solves, compared as
    ``tests/test_torch_solvers.py`` compares solves: same status and
    iteration count in f64 with x at rtol 1e-10; iterations within one
    in f32 with x at rtol 1e-4.  Also an unmonitored FGMRES (max_iters
    iterations, SUCCESS), a rel_div_tolerance DIVERGED case and FGMRES
    nested as the preconditioner of PCGF.
  * complex128 FGMRES, GMRES, PBICGSTAB and PCGF solves.
  * The ten names are registered and no longer in ``UNPORTED``; every
    name the JAX package registers resolves in the port but
    ITERATIVE_REFINEMENT.
"""

import numpy as np
import pytest
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_rhs, poisson_scipy
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.solvers.base import DIVERGED, SUCCESS

amgx_tpu.initialize()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(solver, extra="", iters=100, tol=1e-8, monitor=1):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{solver}", "max_iters": {iters},'
        f' "monitor_residual": {monitor}, "convergence": "RELATIVE_INI",'
        f' "tolerance": {tol}, "norm": "L2"{extra}}}}}'
    )


def _setup_both(cfg_text, m, dtype):
    m = m.astype(dtype)
    js = j_create(JConfig.from_string(cfg_text), "default")
    js.setup(JMatrix.from_scipy(m))
    ts = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(m, device="cpu"))
    return js, ts


def _tol(dtype):
    return 1e-12 if dtype == np.float64 else 2e-5


def _assert_close(xt, xj, rtol):
    np.testing.assert_allclose(xt, xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())


# ---------------------------------------------------------------------------
# MULTICOLOR_DILU setup and M^-1

DILU = _cfg("MULTICOLOR_DILU", ', "relaxation_factor": 0.75', iters=1,
            monitor=0)


def _jax_dilu_slices(js):
    """Per colour (rows, L cols, L vals, U cols, U vals) of the JAX
    solver's params, stacked (fori) or per-colour layout, and einv."""
    _, Ls, Us, rows, einv = js._params
    out = []
    if js._fori:
        (Lc, Lv), (Uc, Uv) = Ls, Us
        rows, einv = np.asarray(rows), np.asarray(einv)
        for c in range(rows.shape[0]):
            out.append((rows[c], np.asarray(Lc[c]), np.asarray(Lv[c]),
                        np.asarray(Uc[c]), np.asarray(Uv[c])))
    else:
        for c in range(len(rows)):
            out.append((np.asarray(rows[c]), np.asarray(Ls[c][0]),
                        np.asarray(Ls[c][1]), np.asarray(Us[c][0]),
                        np.asarray(Us[c][1])))
    return out, np.asarray(einv)


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 12)])
def test_dilu_setup_matches_jax_bitwise(shape):
    """E (as the 1/E both packages ship), the rows of each colour and
    the compact L and U slices, bit for bit in f64."""
    js, ts = _setup_both(DILU, poisson_scipy(shape), np.float64)
    jstages, jeinv = _jax_dilu_slices(js)
    stages = [[t.numpy() for t in st] for st in ts._params[1]]
    assert ts.num_colors == js.num_colors == len(jstages) == len(stages)
    covered = np.concatenate([st[0] for st in stages])
    assert np.array_equal(np.sort(covered), np.arange(ts.A.n_rows))
    for (rows, einv, *tslices), (jrows, *jslices) in zip(stages, jstages):
        k = rows.shape[0]
        assert np.array_equal(jrows[:k], rows)
        assert einv.dtype == np.float64
        assert np.array_equal(einv, jeinv[rows])
        for (tc, tv), (jc, jv) in zip((tslices[:2], tslices[2:]),
                                      (jslices[:2], jslices[2:])):
            w = tc.shape[1]
            assert np.array_equal(jc[:k, :w], tc)
            assert np.array_equal(jv[:k, :w], tv)
            # the JAX layout's padding carries zeros only
            assert not np.any(jv[:k, w:])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 12)])
def test_dilu_apply_matches_jax(shape, dtype):
    js, ts = _setup_both(DILU, poisson_scipy(shape), dtype)
    r = poisson_rhs(ts.A.n_rows, dtype=dtype, seed=3)
    zj = np.asarray(js._apply_M_inv(js._params, r))
    zt = ts._apply_M_inv(ts._params, torch.from_numpy(r)).numpy()
    assert zt.dtype == zj.dtype
    _assert_close(zt, zj, _tol(dtype))


def test_dilu_block_matrix_raises_a4():
    """A block matrix no longer raises: the block-native M^-1 (b x b E
    factors) agrees with the JAX package's at rtol 1e-12."""
    import scipy.sparse as sps

    m = sps.kron(poisson_scipy((5, 5)), np.array([[3.0, 0.4], [0.2, 2.0]]),
                 format="csr")
    js = j_create(JConfig.from_string(DILU), "default")
    js.setup(JMatrix.from_scipy(m, block_size=2))
    ts = T.create_solver(T.AMGConfig.from_string(DILU), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(m, block_size=2, device="cpu"))
    assert ts.num_colors == js.num_colors
    r = poisson_rhs(m.shape[0], seed=3)
    zj = np.asarray(js._apply_M_inv(js._params, r))
    zt = ts._apply_M_inv(ts._params, torch.from_numpy(r)).numpy()
    _assert_close(zt, zj, 1e-12)


# ---------------------------------------------------------------------------
# smoothers: two sweeps from the same start

SMOOTHERS = {
    "MULTICOLOR_DILU": ', "relaxation_factor": 0.75',
    "MULTICOLOR_GS": ', "relaxation_factor": 0.9',
    "MULTICOLOR_GS_symmetric": ', "relaxation_factor": 0.9,'
                               ' "symmetric_GS": 1',
    "GS": "",
    "FIXCOLOR_GS": ', "relaxation_factor": 1.1',
    "JACOBI_L1": ', "relaxation_factor": 0.9',
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(SMOOTHERS))
def test_smoother_sweeps_match_jax(name, dtype):
    solver = name.replace("_symmetric", "")
    text = _cfg(solver, SMOOTHERS[name], iters=1, monitor=0)
    js, ts = _setup_both(text, poisson_scipy((10, 10, 10)), dtype)
    n = ts.A.n_rows
    b = poisson_rhs(n, dtype=dtype, seed=1)
    x0 = poisson_rhs(n, dtype=dtype, seed=2)
    xj = np.asarray(js.make_smooth()(js._params, b, x0, 2))
    xt = ts.make_smooth()(ts._params, torch.from_numpy(b),
                          torch.from_numpy(x0), 2).numpy()
    assert xt.dtype == xj.dtype
    _assert_close(xt, xj, _tol(dtype))
    # the zero-guess application a preconditioner makes
    zj = np.asarray(js.make_apply()(js._params, b))
    zt = ts.make_apply()(ts._params, torch.from_numpy(b)).numpy()
    _assert_close(zt, zj, _tol(dtype))


# ---------------------------------------------------------------------------
# Krylov solves

JACOBI_PREC = (', "preconditioner": {"scope": "jac", "solver":'
               ' "BLOCK_JACOBI", "max_iters": 2, "monitor_residual": 0}')
DILU_PREC = (', "preconditioner": {"scope": "dilu", "solver":'
             ' "MULTICOLOR_DILU", "max_iters": 1, "monitor_residual": 0}')


def _solve_both(cfg_text, m, dtype, seed=0):
    js, ts = _setup_both(cfg_text, m, dtype)
    b = poisson_rhs(m.shape[0], dtype=dtype, seed=seed)
    return js.solve(b), ts.solve(b), ts


def _assert_parity(jr, tr, dtype, band=None):
    """``band``: the (lowest, highest) iteration count of the JAX
    package on this case across XLA's CPU instruction sets, where that
    count moves with them (``JAX_ITERS_BAND``): the port is held to the
    band, widened by the f32 tolerance of one, in place of the count of
    the JAX run beside it."""
    xj, xt = np.asarray(jr.x), tr.x.numpy()
    assert xt.dtype == xj.dtype
    assert tr.status == int(jr.status)
    if dtype == np.float64:
        assert tr.iters == int(jr.iters)
        rtol = 1e-10
    elif band is not None:
        assert band[0] - 1 <= tr.iters <= band[1] + 1
        rtol = 1e-4
    else:
        assert abs(tr.iters - int(jr.iters)) <= 1
        rtol = 1e-4
    _assert_close(xt, xj, rtol)
    k = min(tr.iters, int(jr.iters)) + 1
    np.testing.assert_allclose(
        tr.history[:k], np.asarray(jr.history)[:k], rtol=rtol * 10,
        atol=rtol * float(np.asarray(jr.initial_norm).max()),
    )


KRYLOV = {
    "fgmres_jacobi": _cfg("FGMRES", JACOBI_PREC + ', "gmres_n_restart": 8'),
    "fgmres_dilu": _cfg("FGMRES", DILU_PREC + ', "gmres_n_restart": 6'),
    "fgmres_noprec_krylov_dim": _cfg(
        "FGMRES", ', "preconditioner": "NOSOLVER", "gmres_n_restart": 20,'
        ' "gmres_krylov_dim": 7', iters=200, tol=1e-6),
    "gmres_jacobi": _cfg("GMRES", JACOBI_PREC + ', "gmres_n_restart": 8'),
    "pcgf_dilu": _cfg("PCGF", DILU_PREC),
    "pcgf_jacobi": _cfg("PCGF", JACOBI_PREC),
    "pbicgstab_jacobi": _cfg("PBICGSTAB", JACOBI_PREC),
    "pbicgstab_dilu": _cfg("PBICGSTAB", DILU_PREC),
    "bicgstab": _cfg("BICGSTAB", iters=200),
}


# The JAX package's iteration count of a case that moves with XLA's CPU
# vectorisation alone: BICGSTAB in f32 on the 10^3 system takes 32
# iterations with XLA_FLAGS=--xla_cpu_max_isa=SSE4_2, 31 with AVX2 and 31
# with the default (AVX-512), each in a fresh process on one host
# (ci/torch_jax_isa_band.py); the port takes 33 whatever XLA does.  Its
# true relative residual in f64 is then held to 1e-6, what the f32 x of
# either package reaches (the JAX package's: 3.5e-7) when the recurred
# one meets the 1e-8 tolerance.
JAX_ITERS_BAND = {("bicgstab", np.float32): (31, 32)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(KRYLOV))
def test_krylov_solve_matches_jax(name, dtype):
    """Status, iterations and x as ``_assert_parity`` holds them; where
    the JAX package's own count moves with XLA's CPU instruction set
    (``JAX_ITERS_BAND``: BICGSTAB f32, JAX 32 / 31 / 31 iterations under
    SSE4_2 / AVX2 / AVX-512, the band 31-32, the port 33), the port's
    count within that band widened by one and its true residual under
    1e-6."""
    m = poisson_scipy((10, 10, 10))
    jr, tr, _ = _solve_both(KRYLOV[name], m, dtype)
    band = JAX_ITERS_BAND.get((name, dtype))
    _assert_parity(jr, tr, dtype, band)
    assert tr.status == SUCCESS
    if band is not None:
        b = poisson_rhs(m.shape[0], dtype=dtype, seed=0).astype(np.float64)
        x = tr.x.numpy().astype(np.float64)
        assert np.linalg.norm(b - m @ x) / np.linalg.norm(b) <= 1e-6


@pytest.mark.parametrize("solver", ["FGMRES", "GMRES", "PBICGSTAB", "PCGF"])
def test_krylov_complex_matches_jax(solver):
    """complex128 (the dZ modes): conjugated MGS projections, the
    unitary Givens rotations and conjugated dots, as in JAX."""
    import scipy.sparse as sps

    m = (poisson_scipy((8, 8, 8)) + 0.3j * sps.eye(512)).tocsr()
    js, ts = _setup_both(
        _cfg(solver, JACOBI_PREC + ', "gmres_n_restart": 6'), m,
        np.complex128)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(512) + 1j * rng.standard_normal(512)
    jr, tr = js.solve(b), ts.solve(b)
    assert tr.status == int(jr.status) == SUCCESS
    assert tr.iters == int(jr.iters)
    assert tr.x.dtype == torch.complex128
    _assert_close(tr.x.numpy(), np.asarray(jr.x), 1e-10)


def test_complex_amg_gmres_matches_jax(tmp_path):
    """GMRES + SIZE_2 aggregation AMG on the 400-row Hermitian system of
    ``tests/test_complex.py::test_amg_preconditioned_complex_solve``,
    written to a complex MatrixMarket file and read back by each
    package's ``read_mtx``: the same hierarchy, iterations and x at
    rtol 1e-10."""
    import scipy.sparse as sps

    from amgx_tpu.io import matrix_market as j_mm
    from amgx_tpu_torch.io import matrix_market as t_mm

    n = 400
    rs = np.random.RandomState(5)
    B = sps.random(n, n, density=0.05, random_state=rs) + 1j * sps.random(
        n, n, density=0.05, random_state=rs)
    m = (B @ B.conj().T + n * sps.eye(n)).tocsr().astype(np.complex128)
    path = tmp_path / "hermitian.mtx"
    j_mm.write_system(path, JMatrix.from_scipy(m))
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    text = (
        '{"config_version": 2, "solver": {"scope": "main", '
        '"solver": "GMRES", "max_iters": 100, "gmres_n_restart": 20, '
        '"tolerance": 1e-8, "monitor_residual": 1, '
        '"convergence": "RELATIVE_INI", '
        '"preconditioner": {"scope": "amg", "solver": "AMG", '
        '"algorithm": "AGGREGATION", "selector": "SIZE_2", '
        '"smoother": {"scope": "j", "solver": "BLOCK_JACOBI", '
        '"relaxation_factor": 0.7, "monitor_residual": 0}, '
        '"max_iters": 1, "min_coarse_rows": 32, '
        '"coarse_solver": "DENSE_LU_SOLVER", "monitor_residual": 0}}}')
    js = j_create(JConfig.from_string(text), "default")
    js.setup(j_mm.read_mtx(path))
    ts = T.create_solver(T.AMGConfig.from_string(text), "default",
                         device="cpu")
    ts.setup(t_mm.read_mtx(path, device="cpu"))
    assert ts.A.dtype == torch.complex128
    assert [(lv.A.n_rows, lv.A.nnz) for lv in ts.precond.levels] == [
        (lv.A.n_rows, lv.A.nnz) for lv in js.precond.levels]
    jr, tr = js.solve(b), ts.solve(b)
    assert tr.status == int(jr.status) == SUCCESS
    assert tr.iters == int(jr.iters)
    _assert_close(tr.x.numpy(), np.asarray(jr.x), 1e-10)


@pytest.mark.parametrize("solver", ["FGMRES", "GMRES"])
def test_unmonitored_gmres_runs_max_iters(solver):
    text = _cfg(solver, JACOBI_PREC + ', "gmres_n_restart": 4', iters=9,
                monitor=0)
    jr, tr, _ = _solve_both(text, poisson_scipy((9, 9, 9)), np.float64)
    assert tr.iters == int(jr.iters) == 9
    assert tr.status == int(jr.status) == SUCCESS
    _assert_close(tr.x.numpy(), np.asarray(jr.x), 1e-10)


def test_fgmres_rel_div_tolerance_diverged():
    # GMRES's implicit residual never grows: a bound below one trips on
    # the first step if at all (its estimate there is 0.35 of the start)
    text = _cfg("FGMRES", ', "preconditioner": "NOSOLVER",'
                ' "gmres_n_restart": 10, "rel_div_tolerance": 0.3')
    jr, tr, _ = _solve_both(text, poisson_scipy((10, 10, 10)), np.float64)
    assert tr.status == int(jr.status) == DIVERGED
    assert tr.iters == int(jr.iters) == 1
    _assert_close(tr.x.numpy(), np.asarray(jr.x), 1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fgmres_nested_in_pcgf(dtype):
    text = _cfg(
        "PCGF", ', "preconditioner": {"scope": "inner", "solver": "FGMRES",'
        ' "max_iters": 2, "gmres_n_restart": 5, "monitor_residual": 0,'
        ' "preconditioner": {"scope": "jac", "solver": "BLOCK_JACOBI",'
        ' "max_iters": 1, "monitor_residual": 0}}')
    jr, tr, _ = _solve_both(text, poisson_scipy((10, 10, 10)), dtype)
    _assert_parity(jr, tr, dtype)
    assert tr.status == SUCCESS


@pytest.mark.parametrize("name", [
    "FGMRES", "GMRES", "PCGF", "PBICGSTAB", "BICGSTAB", "MULTICOLOR_DILU",
    "MULTICOLOR_GS", "GS", "FIXCOLOR_GS", "JACOBI_L1"])
def test_ported_solvers_registered(name):
    from amgx_tpu_torch.solvers.registry import UNPORTED, SolverRegistry

    assert name not in UNPORTED
    assert SolverRegistry.get(name).registry_name == name


# every name the JAX package registers (held to its registry below)
JAX_NAMES = (
    "AMG", "BICGSTAB", "BLOCK_JACOBI", "CF_JACOBI", "CG", "CHEBYSHEV",
    "CHEBYSHEV_POLY", "DENSE_LU", "DENSE_LU_SOLVER", "FGMRES",
    "FIXCOLOR_GS", "GMRES", "GS", "IDR", "IDRMSYNC", "INEXACT",
    "ITERATIVE_REFINEMENT", "JACOBI_L1", "KACZMARZ", "KPZ_POLYNOMIAL",
    "MULTICOLOR_DILU", "MULTICOLOR_GS", "MULTICOLOR_ILU", "NOSOLVER",
    "OPT_POLYNOMIAL", "PBICGSTAB", "PCG", "PCGF", "POLYNOMIAL", "SSTEP_PCG",
)


def test_name_list_is_the_jax_registry():
    from amgx_tpu.solvers.registry import _SOLVERS as JAX_SOLVERS

    assert sorted(JAX_SOLVERS) == list(JAX_NAMES)


@pytest.mark.parametrize("name", JAX_NAMES)
def test_every_jax_solver_name_resolves(name):
    """Every name the JAX package registers resolves in the port,
    ITERATIVE_REFINEMENT included since the reduced-precision slice:
    nothing is left in ``UNPORTED``."""
    from amgx_tpu_torch.solvers.registry import UNPORTED, SolverRegistry

    assert not UNPORTED
    cls = SolverRegistry.get(name)
    # DENSE_LU is an alias of DENSE_LU_SOLVER in both packages
    assert cls.registry_name == name or (
        name == "DENSE_LU" and cls.registry_name == "DENSE_LU_SOLVER")
