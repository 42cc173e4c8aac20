"""Parity of the port's remaining solvers with the JAX package (CPU):
IDR / IDRMSYNC, CHEBYSHEV / CHEBYSHEV_POLY, POLYNOMIAL, KPZ_POLYNOMIAL,
OPT_POLYNOMIAL, CF_JACOBI, KACZMARZ, SSTEP_PCG, INEXACT, NOSOLVER and
the scalers.

The same config string, matrix and right-hand side (numpy, from a seed)
go through both packages.  Solves: the same status and iteration count
in f64, x at rtol 1e-10.  Setup state copied from the JAX package's
host code is equal bit for bit (scaler vectors, the C/F split, the
opt-poly weights, IDR's shadow space); Chebyshev's lmax and lmin, from
20 power-iteration steps on the device, at rtol 1e-12.  The gate inputs
are those of ``tests/test_solvers_extra.py``, ``tests/test_sstep.py``
and ``tests/test_precision.py`` (the INEXACT cases that set no
``hierarchy_dtype``), with ``structure_reuse_levels`` left out of the
AMG configs: it only keeps a product plan for a later resetup, which
the port does not have, and the solve is the same without it.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_rhs, poisson_scipy
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu.solvers.registry import make_nested as j_nested
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.solvers.base import SUCCESS
from amgx_tpu_torch.solvers.registry import make_nested as t_nested

amgx_tpu.initialize()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _setup_both(cfg_text, m, nested=False):
    js = j_create(JConfig.from_string(cfg_text), "default")
    ts = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                         device="cpu")
    if nested:
        js, ts = j_nested(js), t_nested(ts)
    js.setup(JMatrix.from_scipy(m))
    ts.setup(TMatrix.from_scipy(m, device="cpu"))
    return js, ts


def _solve_both(cfg_text, m, b, nested=False):
    js, ts = _setup_both(cfg_text, m, nested)
    jr, tr = js.solve(b), ts.solve(b)
    assert tr.iters == int(jr.iters)
    assert tr.status == int(jr.status)
    xj = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    return js, ts, jr, tr


def _rel_res(m, x, b):
    return float(np.linalg.norm(b - m @ np.asarray(x)) / np.linalg.norm(b))


def _poisson(shape=(24, 24), seed=0):
    """tests/test_sstep.py's system."""
    sp = poisson_scipy(shape).tocsr()
    sp.sort_indices()
    return sp, np.random.default_rng(seed).standard_normal(sp.shape[0])


# ---------------------------------------------------------------------------
# IDR (tests/test_solvers_extra.py:31,45)

IDR_PLAIN = (
    '{{"config_version": 2, "solver": {{"scope": "main",'
    ' "solver": "{name}", "subspace_dim_s": 4, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI", "tolerance": 1e-08,'
    ' "max_iters": 120,'
    ' "preconditioner": {{"scope": "p", "solver": "NOSOLVER"}}}}}}'
)

IDR_DILU = (
    '{{"config_version": 2, "solver": {{"scope": "main",'
    ' "solver": "{name}", "subspace_dim_s": 4, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI", "tolerance": 1e-08,'
    ' "max_iters": 60,'
    ' "preconditioner": {{"scope": "p", "solver": "MULTICOLOR_DILU",'
    ' "max_iters": 1, "monitor_residual": 0}}}}}}'
)


@pytest.mark.parametrize("template", [IDR_PLAIN, IDR_DILU],
                         ids=["plain", "dilu"])
@pytest.mark.parametrize("name", ["IDR", "IDRMSYNC"])
def test_idr_poisson(name, template):
    m = poisson_scipy((24, 24))
    b = poisson_rhs(m.shape[0])
    js, ts, _, tr = _solve_both(template.format(name=name), m, b)
    assert tr.status == SUCCESS
    assert _rel_res(m, tr.x.numpy(), b) < 1e-7
    # the shadow space is the JAX package's, built once per setup
    from amgx_tpu_torch.solvers.idr import shadow_space

    P = shadow_space(m.shape[0], 4, torch.float64, "cpu").numpy()
    q, _ = np.linalg.qr(np.random.default_rng(42).standard_normal(
        (m.shape[0], 4)))
    assert P.tobytes() == q.T.tobytes()
    assert ts._shadow.numpy().tobytes() == P.tobytes()


def test_idr_s8_dilu_path_config():
    """IDR(8) + DILU, the idr_dilu path's config, at 10^3."""
    import chip_smoke

    m = poisson_scipy((10, 10, 10))
    b = poisson_rhs(m.shape[0])
    _, _, _, tr = _solve_both(chip_smoke.IDR_DILU_CFG, m, b)
    assert tr.status == SUCCESS


def test_idr_unmonitored():
    """Unmonitored IDR runs max_iters outer cycles and reports SUCCESS;
    run for the count the monitored solve took, it gives the monitored
    x bit for bit, and the JAX package's at rtol 1e-10."""
    m = poisson_scipy((24, 24))
    b = poisson_rhs(m.shape[0])
    _, ts, _, tr = _solve_both(IDR_PLAIN.format(name="IDR"), m, b)
    text = IDR_PLAIN.format(name="IDR").replace(
        '"monitor_residual": 1', '"monitor_residual": 0').replace(
        '"max_iters": 120', f'"max_iters": {tr.iters}')
    _, tu, _, ru = _solve_both(text, m, b)
    assert ru.iters == tr.iters and ru.status == SUCCESS
    assert ru.x.numpy().tobytes() == tr.x.numpy().tobytes()


# ---------------------------------------------------------------------------
# smoothers as solvers (tests/test_solvers_extra.py:69,144)

@pytest.mark.parametrize("name,rf,tol,iters", [
    ("POLYNOMIAL", 1.0, 1e-06, 2000),
    ("KPZ_POLYNOMIAL", 1.0, 1e-06, 2000),
    ("KACZMARZ", 1.5, 1e-04, 3000),
])
def test_extra_smoothers_converge(name, rf, tol, iters):
    m = poisson_scipy((12, 12))
    b = poisson_rhs(m.shape[0])
    text = (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{name}", "monitor_residual": 1,'
        f' "relaxation_factor": {rf}, "kpz_order": 3,'
        f' "convergence": "RELATIVE_INI", "tolerance": {tol},'
        f' "max_iters": {iters}}}}}'
    )
    js, ts, _, tr = _solve_both(text, m, b)
    assert tr.status == SUCCESS
    assert _rel_res(m, tr.x.numpy(), b) < tol * 20
    if name == "KACZMARZ":
        assert ts.num_colors == js.num_colors
        At_j = js._params[1].to_scipy()
        At_t = ts._params[1].host_csr()
        assert At_t.data.tobytes() == At_j.data.tobytes()
        assert ts._params[1].format == "DIA"
    if name == "KPZ_POLYNOMIAL":
        for cj, ct in zip(js._params[1], ts._params[1]):
            assert float(ct) == float(cj)


@pytest.mark.parametrize("mode", [0, 1])
def test_cf_jacobi(mode):
    m = poisson_scipy((16, 16))
    b = poisson_rhs(m.shape[0])
    text = (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "CF_JACOBI", "monitor_residual": 1,'
        f' "cf_smoothing_mode": {mode},'
        ' "relaxation_factor": 0.9, "convergence": "RELATIVE_INI",'
        ' "tolerance": 1e-06, "max_iters": 1500}}'
    )
    js, ts, _, tr = _solve_both(text, m, b)
    assert tr.status == SUCCESS
    assert _rel_res(m, tr.x.numpy(), b) < 1e-5
    assert np.array_equal(ts._params[2].numpy(), np.asarray(js._params[2]))


# ---------------------------------------------------------------------------
# scalers (tests/test_solvers_extra.py:106,157,182)

def _badly_scaled():
    sp = poisson_scipy((16, 16))
    rng = np.random.default_rng(3)
    d = 10.0 ** rng.uniform(-4, 4, sp.shape[0])
    sp_bad = (sps.diags_array(d) @ sp @ sps.diags_array(d)).tocsr()
    xtrue = rng.standard_normal(sp.shape[0])
    return sp_bad, sp_bad @ xtrue, xtrue


@pytest.mark.parametrize("scaling", ["BINORMALIZATION",
                                     "DIAGONAL_SYMMETRIC"])
def test_scalers(scaling):
    m, b, xtrue = _badly_scaled()
    text = (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "PCG", "scaling": "{scaling}",'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
        ' "tolerance": 1e-10, "max_iters": 1500,'
        ' "preconditioner": {"scope": "p", "solver": "NOSOLVER"}}}'
    )
    js, ts = _setup_both(text, m)
    # the scale vectors and the scaled operator, bit for bit
    for vj, vt in zip(js._scale_vecs, ts._scale_vecs):
        assert vt.numpy().tobytes() == np.asarray(vj).tobytes()
    assert ts.A.host_csr().data.tobytes() == js.A.to_scipy().data.tobytes()
    assert ts.A.format == "DIA" and js.A.has_dia
    jr, tr = js.solve(b), ts.solve(b)
    assert tr.iters == int(jr.iters)
    assert tr.status == int(jr.status) == SUCCESS
    # x = Dc xs with Dc spanning eight decades: compared in the scaled
    # space, where the solve runs (unscaling multiplies both by the same
    # bits)
    c = ts._scale_vecs[1].numpy()
    xs_j, xs_t = np.asarray(jr.x) / c, tr.x.numpy() / c
    np.testing.assert_allclose(xs_t, xs_j, rtol=1e-10,
                               atol=1e-10 * np.abs(xs_j).max())
    x = tr.x.numpy()
    assert np.linalg.norm(x - xtrue) / np.linalg.norm(xtrue) < 1e-2


def test_scaler_unknown_name():
    from amgx_tpu_torch.solvers.scalers import create_scaler

    with pytest.raises(KeyError):
        create_scaler("MAGIC")
    assert create_scaler("NONE") is None


def test_nbinormalization_equalizes_norms():
    from amgx_tpu.solvers.scalers import create_scaler as j_scaler
    from amgx_tpu_torch.solvers.scalers import create_scaler

    rng = np.random.default_rng(8)
    n = 60
    m = sps.random(n, n, density=0.1, random_state=rng, format="csr")
    m = m + sps.diags_array(2.0 + rng.random(n))
    m = (sps.diags_array(10.0 ** rng.uniform(-3, 3, n)) @ m).tocsr()
    r, c = create_scaler("NBINORMALIZATION").compute(m)
    rj, cj = j_scaler("NBINORMALIZATION").compute(m)
    assert r.tobytes() == rj.tobytes() and c.tobytes() == cj.tobytes()
    assert not np.allclose(r, c)
    S = (sps.diags_array(r) @ m @ sps.diags_array(c)).tocsr()
    rn = np.sqrt(np.asarray(S.multiply(S).sum(axis=1)).ravel())
    cn = np.sqrt(np.asarray(S.multiply(S).sum(axis=0)).ravel())
    assert rn.max() / rn.min() < 1.05
    assert cn.max() / cn.min() < 1.05


def test_nbinormalization_in_solver():
    rng = np.random.default_rng(4)
    n = 100
    m = sps.random(n, n, density=0.06, random_state=rng, format="csr")
    m = m + sps.diags_array(3.0 + rng.random(n))
    m = (sps.diags_array(10.0 ** rng.uniform(-2, 2, n)) @ m).tocsr()
    b = rng.standard_normal(n)
    text = (
        '{"config_version": 2, "solver": {"scope": "s",'
        ' "solver": "GMRES", "scaling": "NBINORMALIZATION",'
        ' "max_iters": 200, "tolerance": 1e-9,'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI"}}'
    )
    _, _, _, tr = _solve_both(text, m, b)
    assert _rel_res(m, tr.x.numpy(), b) < 1e-6


# ---------------------------------------------------------------------------
# SSTEP_PCG and OPT_POLYNOMIAL (tests/test_sstep.py:109-194,244-290)

def _krylov_cfg(solver, extra="", precond="BLOCK_JACOBI", max_iters=400,
                tol=1e-10):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{solver}", "max_iters": {max_iters},'
        f' "tolerance": {tol}, "monitor_residual": 1,'
        f' "convergence": "RELATIVE_INI", {extra}'
        ' "preconditioner": {"scope": "p",'
        f' "solver": "{precond}", "max_iters": 2,'
        ' "monitor_residual": 0}}}'
    )


def test_gram_block_matches_jax():
    from amgx_tpu.ops.blas import gram_block as j_gram
    from amgx_tpu_torch.ops.blas import gram_block

    rng = np.random.default_rng(1)
    for dt in (np.float64, np.complex128):
        X = rng.standard_normal((5, 40)).astype(dt)
        Y = rng.standard_normal((3, 40)).astype(dt)
        if dt == np.complex128:
            X = X + 1j * rng.standard_normal(X.shape)
            Y = Y + 1j * rng.standard_normal(Y.shape)
        np.testing.assert_allclose(
            gram_block(torch.from_numpy(X), torch.from_numpy(Y)).numpy(),
            np.asarray(j_gram(X, Y)), rtol=1e-12)


def test_s1_is_classic_pcg_bitwise():
    sp, b = _poisson()
    _, ref_t = _setup_both(_krylov_cfg("PCG"), sp, nested=True)
    ref = ref_t.solve(b)
    js, ts, jr, tr = _solve_both(_krylov_cfg("SSTEP_PCG", '"s_step": 1,'),
                                 sp, b, nested=True)
    assert ts.iterations_scale == 1
    assert tr.iters == ref.iters
    assert tr.x.numpy().tobytes() == ref.x.numpy().tobytes()
    np.testing.assert_array_equal(tr.history, ref.history)


@pytest.mark.parametrize("s_val", [2, 4])
def test_sstep_iteration_for_iteration(s_val):
    sp, b = _poisson()
    _, ts, _, tr = _solve_both(
        _krylov_cfg("SSTEP_PCG", f'"s_step": {s_val},'), sp, b, nested=True)
    assert tr.status == SUCCESS
    assert ts.iterations_scale == s_val
    assert _rel_res(sp, tr.x.numpy(), b) < 5e-9


@pytest.mark.parametrize("basis", ["MONOMIAL", "SCALED"])
def test_sstep_basis_knob(basis):
    sp, b = _poisson()
    _, _, _, tr = _solve_both(
        _krylov_cfg("SSTEP_PCG", f'"s_step": 4, "sstep_basis": "{basis}",'),
        sp, b, nested=True)
    assert tr.status == SUCCESS
    assert _rel_res(sp, tr.x.numpy(), b) < 5e-9


def test_sstep_residual_replacement():
    """s = 8 on the ill-conditioned operator of test_sstep.py, with and
    without the residual-replacement guard: the guard closes the drift
    between the recurred and the true residual in both packages.  At
    s = 8 the small Gram systems have condition numbers near 3e11, so
    last-bit differences of the Gram product (torch and XLA sum in
    another order) move the iterates at 1e-5 from the first outer
    iteration on, and the JAX package's own count moves with XLA's CPU
    vectorisation: without the guard 10 iterations with
    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2, 9 with AVX2 and 8 with the
    default (AVX-512), with it 8, 9 and 9, each in a fresh process on
    one host (ci/torch_jax_isa_band.py); the port takes 10 and 9.  So
    the port's count is held to that band widened by one, and x to the
    true residual, not to the JAX package's x."""
    sp, b = _poisson()
    sp = (sp + sps.diags_array(
        np.linspace(0.0, 50.0, sp.shape[0]) ** 2 * 1e-4)).tocsr()
    sp.sort_indices()
    res = {}
    for every, (lo, hi) in ((0, (8, 10)), (1, (8, 9))):
        text = _krylov_cfg("SSTEP_PCG",
                           f'"s_step": 8, "sstep_replace_every": {every},')
        js, ts = _setup_both(text, sp, nested=True)
        jr, tr = js.solve(b), ts.solve(b)
        assert tr.status == int(jr.status) == SUCCESS
        assert lo - 1 <= tr.iters <= hi + 1
        res[every] = (_rel_res(sp, tr.x.numpy(), b),
                      _rel_res(sp, np.asarray(jr.x), b))
    for k in (0, 1):
        assert res[1][k] < res[0][k] / 10 and res[1][k] < 5e-9


def _amg_cfg(outer, smoother, pre, post, coarse="DENSE_LU_SOLVER",
             extra_amg=""):
    """tests/test_sstep.py's and tests/test_precision.py's AMG configs
    (SIZE_8 aggregation, min_coarse_rows 32)."""
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{outer}", "max_iters": 100, "tolerance": 1e-8,'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
        + extra_amg +
        ' "smoother": {"scope": "sm",'
        f' "solver": "{smoother}", "relaxation_factor": 0.8,'
        ' "chebyshev_polynomial_order": 2, "kpz_order": 2,'
        ' "monitor_residual": 0},'
        f' "presweeps": {pre}, "postsweeps": {post}, "max_iters": 1,'
        ' "min_coarse_rows": 32, "max_levels": 10,'
        f' "coarse_solver": "{coarse}", "cycle": "V",'
        ' "monitor_residual": 0}}}'
    )


def test_sstep_with_amg_preconditioner():
    sp, b = _poisson((16, 16))
    text = _amg_cfg("SSTEP_PCG", "OPT_POLYNOMIAL", 1, 1).replace(
        '"max_iters": 100,', '"s_step": 4, "max_iters": 100,', 1)
    _, _, _, tr = _solve_both(text, sp, b, nested=True)
    assert tr.status == SUCCESS
    assert _rel_res(sp, tr.x.numpy(), b) < 1e-6


def test_opt_poly_weights_table():
    from amgx_tpu.solvers.polynomial import (
        opt_fourth_kind_weights as j_weights,
    )
    from amgx_tpu_torch.solvers.polynomial import opt_fourth_kind_weights

    for k in range(1, 10):
        assert np.array(opt_fourth_kind_weights(k)).tobytes() == \
            np.array(j_weights(k)).tobytes()


@pytest.mark.parametrize("smoother,pre", [("BLOCK_JACOBI", 2),
                                          ("OPT_POLYNOMIAL", 1),
                                          ("POLYNOMIAL", 1),
                                          ("KPZ_POLYNOMIAL", 1)])
def test_polynomial_amg_smoothers(smoother, pre):
    """test_opt_poly_smoother_beats_jacobi_iterations's two solves, and
    the other polynomial smoothers in the same AMG."""
    sp, b = _poisson((16, 16))
    _, _, _, tr = _solve_both(_amg_cfg("PCG", smoother, pre, pre), sp, b,
                              nested=True)
    assert tr.status == SUCCESS


def test_opt_poly_standalone_converges():
    sp, b = _poisson((16, 16))
    text = (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "OPT_POLYNOMIAL",'
        ' "chebyshev_polynomial_order": 3, "max_iters": 300,'
        ' "tolerance": 1e-6, "monitor_residual": 1,'
        ' "convergence": "RELATIVE_INI"}}'
    )
    js, ts, _, tr = _solve_both(text, sp, b, nested=True)
    assert tr.status == SUCCESS
    assert _rel_res(sp, tr.x.numpy(), b) < 1e-5
    np.testing.assert_allclose(ts.lmax, js.lmax, rtol=1e-12)


# ---------------------------------------------------------------------------
# CHEBYSHEV (tests/test_sstep.py:294-303)

@pytest.mark.parametrize("name,extra", [
    ("CHEBYSHEV", ""),
    ("CHEBYSHEV_POLY", ""),
    ("CHEBYSHEV", ' "chebyshev_lambda_estimate_mode": 3,'
                  ' "cheby_max_lambda": 2.0, "cheby_min_lambda": 0.05,'),
    ("CHEBYSHEV", ' "preconditioner": {"scope": "l1",'
                  ' "solver": "JACOBI_L1", "max_iters": 1,'
                  ' "monitor_residual": 0},'),
])
def test_chebyshev(name, extra):
    sp, b = _poisson((16, 16))
    text = (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{name}", "chebyshev_polynomial_order": 4,'
        f' {extra} "max_iters": 200, "tolerance": 1e-6,'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI"}}'
    )
    js, ts, _, tr = _solve_both(text, sp, b, nested=True)
    assert tr.status == SUCCESS
    np.testing.assert_allclose(ts.lmax, js.lmax, rtol=1e-12)
    np.testing.assert_allclose(ts.lmin, js.lmin, rtol=1e-12)


def test_classical_aggressive_chebyshev_l1_amg():
    """AMG + CHEBYSHEV / JACOBI_L1 with aggressive_levels 1 (the
    pcg_classical_cheby path's config) at 12^3: the same hierarchy and
    lmax per level, the same iterations and x."""
    import chip_smoke

    m = poisson_scipy((12, 12, 12))
    b = poisson_rhs(m.shape[0])
    js, ts, _, tr = _solve_both(chip_smoke.PCG_CLASSICAL_CHEB, m, b)
    assert tr.status == SUCCESS
    jl, tl = js.precond.levels, ts.precond.levels
    assert [(lv.n_rows, lv.nnz) for lv in tl] == \
        [(lv.A.n_rows, lv.A.nnz) for lv in jl]
    for lj, lt in zip(jl, tl):
        if lt.smoother is not None:
            np.testing.assert_allclose(lt.smoother.lmax, lj.smoother.lmax,
                                       rtol=1e-12)
            np.testing.assert_allclose(lt.smoother.lmin, lj.smoother.lmin,
                                       rtol=1e-12)


# ---------------------------------------------------------------------------
# INEXACT (tests/test_precision.py:182-265,316)

def test_inexact_coarse_parity():
    from amgx_tpu_torch.solvers.inexact import InexactCoarseSolver

    sp, b = _poisson()
    _, _, _, r0 = _solve_both(_amg_cfg("PCG", "OPT_POLYNOMIAL", 1, 1), sp, b,
                              nested=True)
    js, ts, _, r1 = _solve_both(
        _amg_cfg("PCG", "OPT_POLYNOMIAL", 1, 1, coarse="INEXACT"), sp, b,
        nested=True)
    cs = ts.precond.coarse_solver
    assert isinstance(cs, InexactCoarseSolver)
    assert cs.cycle_depth == js.precond.coarse_solver.cycle_depth == \
        len(ts.precond.levels)
    assert cs.sweep_budget() <= cs.max_coarse_iters
    assert cs.inner.max_iters == js.precond.coarse_solver.inner.max_iters
    assert r0.status == r1.status == SUCCESS
    assert r1.iters <= int(np.ceil(1.1 * r0.iters)) + 1
    # no dense trigger: the hierarchy coarsens further
    assert ts.precond.levels[-1].n_rows <= 32


def test_inexact_sstep_method():
    from amgx_tpu_torch.solvers.sstep import SStepPCGSolver

    sp, b = _poisson()
    text = _amg_cfg(
        "PCG", "OPT_POLYNOMIAL", 1, 1, coarse="INEXACT",
        extra_amg=' "inexact_coarse_solver": "SSTEP_PCG", "s_step": 2,')
    _, ts, _, tr = _solve_both(text, sp, b, nested=True)
    cs = ts.precond.coarse_solver
    assert isinstance(cs.inner, SStepPCGSolver)
    assert cs.inner.max_iters == -(-cs.sweep_budget() // 2)
    # an inner Krylov solver without a scope of its own runs
    # unpreconditioned
    assert cs.inner.precond is None
    assert tr.status == SUCCESS


def test_flat_config_inexact_krylov_no_recursion():
    sp, b = _poisson((12, 12))
    text = (
        "solver=PCG, preconditioner=AMG, coarse_solver=INEXACT,"
        " inexact_coarse_solver=SSTEP_PCG, algorithm=AGGREGATION,"
        " selector=SIZE_8, min_coarse_rows=32, max_levels=10,"
        " monitor_residual=1, tolerance=1e-8,"
        " convergence=RELATIVE_INI"
    )
    _, ts, _, tr = _solve_both(text, sp, b, nested=True)
    assert ts.precond.coarse_solver.inner.precond is None
    assert tr.status == SUCCESS


def test_inexact_scoped_preconditioner_honored():
    sp, b = _poisson((12, 12))
    text = (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-8,'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
        ' "max_iters": 1, "monitor_residual": 0,'
        ' "min_coarse_rows": 32, "coarse_solver": "INEXACT",'
        ' "inexact_coarse_solver": {"scope": "cg",'
        '   "solver": "SSTEP_PCG", "s_step": 2,'
        '   "preconditioner": "BLOCK_JACOBI"}}}}'
    )
    _, ts, _, _ = _solve_both(text, sp, b, nested=True)
    pc = ts.precond.coarse_solver.inner.precond
    assert pc is not None and pc.registry_name == "BLOCK_JACOBI"


# ---------------------------------------------------------------------------
# NOSOLVER

def test_nosolver():
    """NOSOLVER as a smoother (the coarsest level then keeps x) and as a
    solver (zero iterations, x0 returned)."""
    sp, b = _poisson((12, 12))
    text = _amg_cfg("PCG", "NOSOLVER", 1, 1)
    _solve_both(text, sp, b, nested=True)
    text = (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "NOSOLVER", "max_iters": 5, "monitor_residual": 1}}'
    )
    _, ts, jr, tr = _solve_both(text, sp, b)
    assert tr.iters == 0 and not tr.x.numpy().any()


# ---------------------------------------------------------------------------
# config keys

@pytest.mark.parametrize("key", [
    "subspace_dim_s", "chebyshev_polynomial_order",
    "chebyshev_lambda_estimate_mode", "cheby_max_lambda",
    "cheby_min_lambda", "kpz_mu", "kpz_order", "ilu_sparsity_level",
    "cf_smoothing_mode", "kaczmarz_coloring_needed", "s_step",
    "sstep_basis", "sstep_replace_every", "inexact_coarse_solver",
    "max_coarse_iters", "scaling", "strength_threshold", "max_row_sum",
])
def test_solver_keys_registered_with_jax_defaults(key):
    from amgx_tpu.config import params as jp
    from amgx_tpu_torch.config import params as tp

    assert tp.get_description(key).default == jp.get_description(key).default


@pytest.mark.parametrize("name", ["PCG_CLASSICAL_CHEB", "IDR_DILU_CFG",
                                  "GMRES_ILU0_CFG"])
def test_chip_path_configs_parse_alike(name):
    """The three chip paths' configs parse to the same settings in both
    packages, and name solvers both registries hold."""
    import chip_smoke

    text = getattr(chip_smoke, name)
    jc, tc = JConfig.from_string(text), T.AMGConfig.from_string(text)
    assert tc.items() == jc.items()
    for (scope, key), value in tc.items().items():
        if key in ("solver", "smoother", "preconditioner", "coarse_solver"):
            from amgx_tpu_torch.solvers.registry import SolverRegistry

            SolverRegistry.get(tc.get(key, scope))
