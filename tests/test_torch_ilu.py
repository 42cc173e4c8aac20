"""Parity of the port's MULTICOLOR_ILU with the JAX package (CPU).

  * Setup: the host factorization is a copy of the JAX package's, so
    the colours of the fill pattern, the unit-L and strict-U factors and
    the inverted pivots ``udinv`` are equal bit for bit, for ILU(0) and
    ILU(1), on a 2D Poisson matrix, a >= 3-colour ring and the
    nonsymmetric convection-diffusion operator.
  * One application of M^-1 agrees at rtol 1e-12 (f64) and 2e-5 (f32),
    as a single SpMV does.
  * The gate inputs of ``tests/test_selectors_ilu.py`` (ILU(0) exact on
    its pattern, ILU(1) beats ILU(0), ILU as a classical-AMG smoother,
    the multicolour ring) and of ``tests/test_nonsymmetric.py`` (GMRES(30)
    + ILU0 on the 24 x 24 upwind convection-diffusion operator, BASELINE
    acceptance config 4) go through both packages: same status and
    iteration count in f64, x at rtol 1e-10.
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
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.solvers.base import SUCCESS

amgx_tpu.initialize()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _smoother(extra="", iters=1, monitor=0, tol=1e-8):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "MULTICOLOR_ILU", "relaxation_factor": 1.0,'
        f' "max_iters": {iters}, "monitor_residual": {monitor},'
        f' "convergence": "RELATIVE_INI", "tolerance": {tol}{extra}}}}}'
    )


def convection_diffusion_2d(n, peclet=20.0):
    """The 2D first-order upwind operator of
    ``tests/test_nonsymmetric.py``."""
    h = 1.0 / (n + 1)
    cx, cy = peclet, peclet * 0.5
    main = 4.0 + h * (abs(cx) + abs(cy))
    west = -1.0 - h * max(cx, 0)
    east = -1.0 + h * min(cx, 0)
    south = -1.0 - h * max(cy, 0)
    north = -1.0 + h * min(cy, 0)
    eye = sps.eye_array(n)
    tx = sps.diags_array(
        [west * np.ones(n - 1), main * np.ones(n), east * np.ones(n - 1)],
        offsets=[-1, 0, 1],
    )
    ty = sps.diags_array(
        [south * np.ones(n - 1), np.zeros(n), north * np.ones(n - 1)],
        offsets=[-1, 0, 1],
    )
    A = (sps.kron(eye, tx) + sps.kron(ty, eye)).tocsr()
    A.sort_indices()
    return A


def _ring(n=40):
    """Ring with chords (an odd cycle: at least three colours), the
    matrix of ``test_ilu0_exact_on_pattern_multicolor``."""
    rows, cols = [], []
    for i in range(n):
        for j in (i - 1, i + 1, i + 7):
            rows.append(i)
            cols.append(j % n)
    m = sps.csr_matrix((np.full(len(rows), -1.0), (rows, cols)),
                       shape=(n, n))
    m = (m + m.T) * 0.5
    m.setdiag(8.0)
    m = m.tocsr()
    m.sort_indices()
    return m


def _setup_both(cfg_text, m, dtype=np.float64):
    m = m.astype(dtype)
    js = j_create(JConfig.from_string(cfg_text), "default")
    js.setup(JMatrix.from_scipy(m))
    ts = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(m, device="cpu"))
    return js, ts


def _jax_factors(js, n):
    """(rows per colour, L, U, udinv) of the JAX package's ILU (scalar),
    from either of its layouts (per-colour tuples or the stacked,
    spill-padded arrays)."""
    _A, Ls, Us, srows, udinv = js._params
    if isinstance(srows, tuple):
        rows = [np.asarray(r) for r in srows]
        Ls = [(np.asarray(c), np.asarray(v)) for c, v in Ls]
        Us = [(np.asarray(c), np.asarray(v)) for c, v in Us]
        ud = [np.asarray(u).reshape(-1) for u in udinv]
    else:
        sr = np.asarray(srows)
        Lc_s, Lv_s = np.asarray(Ls[0]), np.asarray(Ls[1])
        Uc_s, Uv_s = np.asarray(Us[0]), np.asarray(Us[1])
        ud_s = np.asarray(udinv)
        rows, Ls, Us, ud = [], [], [], []
        for c in range(sr.shape[0]):
            k = int((sr[c] < n).sum())
            rows.append(sr[c][:k])
            Ls.append((Lc_s[c][:k], Lv_s[c][:k]))
            Us.append((Uc_s[c][:k], Uv_s[c][:k]))
            ud.append(ud_s[c][:k].reshape(-1))
    return rows, _csr_of(rows, Ls, n), _csr_of(rows, Us, n), ud


def _torch_factors(ts, n):
    stages = ts._params[1]
    rows = [st[0].numpy() for st in stages]
    Ls = [(st[2].numpy(), st[3].numpy()) for st in stages]
    Us = [(st[4].numpy(), st[5].numpy()) for st in stages]
    return rows, _csr_of(rows, Ls, n), _csr_of(rows, Us, n), \
        [st[1].numpy() for st in stages]


def _csr_of(rows, slices, n):
    """CSR of per-colour ELL slices; the padding slots (value 0) go."""
    r, c, v = [], [], []
    for rows_c, (cols, vals) in zip(rows, slices):
        keep = vals != 0
        r.append(np.repeat(rows_c, cols.shape[1]).reshape(cols.shape)[keep])
        c.append(cols[keep])
        v.append(vals[keep])
    m = sps.csr_matrix((np.concatenate(v), (np.concatenate(r),
                                            np.concatenate(c))),
                       shape=(n, n))
    m.sort_indices()
    return m


def _assert_csr_bitwise(a, b):
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices),
                 (a.data, b.data)):
        assert x.tobytes() == y.tobytes()


CASES = {
    "poisson2d": lambda: poisson_scipy((12, 12)),
    "ring": _ring,
    "convdiff": lambda: convection_diffusion_2d(10),
}


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_factors_and_colors_bitwise(case, level):
    m = CASES[case]()
    n = m.shape[0]
    js, ts = _setup_both(_smoother(f', "ilu_sparsity_level": {level}'), m)
    assert ts.num_colors == js.num_colors
    jrows, jL, jU, jud = _jax_factors(js, n)
    trows, tL, tU, tud = _torch_factors(ts, n)
    assert len(jrows) == len(trows)
    for a, b in zip(jrows, trows):
        assert np.array_equal(a, b)
    _assert_csr_bitwise(jL, tL)
    _assert_csr_bitwise(jU, tU)
    for a, b in zip(jud, tud):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 2e-5)])
@pytest.mark.parametrize("level", [0, 1])
def test_apply_matches_jax(level, dtype, rtol):
    m = convection_diffusion_2d(12)
    js, ts = _setup_both(_smoother(f', "ilu_sparsity_level": {level}'),
                         m, dtype)
    r = np.random.default_rng(11).standard_normal(m.shape[0]).astype(dtype)
    zj = np.asarray(js._apply_M_inv(js._params, r))
    zt = ts._apply_M_inv(ts._params, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=rtol,
                               atol=rtol * np.abs(zj).max())


def test_ilu0_exact_on_pattern():
    """(L U)_ij == a_ij on the pattern (test_selectors_ilu.py:144), for
    the port's factors: M = L U with U's diagonal 1 / udinv."""
    for m in (poisson_scipy((8, 8)), _ring()):
        n = m.shape[0]
        _, ts = _setup_both(_smoother(), m)
        _, L, U, ud = _torch_factors(ts, n)
        rows = np.concatenate([st[0].numpy() for st in ts._params[1]])
        piv = np.zeros(n)
        piv[rows] = 1.0 / np.concatenate(ud)
        LU = (sps.eye_array(n) + L).toarray() @ (U + sps.diags_array(piv)
                                                 ).toarray()
        Ad = m.toarray()
        assert np.max(np.abs((LU - Ad)[Ad != 0])) < 1e-12


def test_ilu1_beats_ilu0():
    """Fill level 1 is a better preconditioner (test_selectors_ilu.py:165),
    with the JAX package's residuals in both packages."""
    m = poisson_scipy((24, 24))
    b = poisson_rhs(m.shape[0])
    rels = {}
    for lev in (0, 1):
        js, ts = _setup_both(
            _smoother(f', "ilu_sparsity_level": {lev}', iters=20,
                      monitor=1), m)
        jr, tr = js.solve(b), ts.solve(b)
        assert tr.iters == int(jr.iters)
        assert tr.status == int(jr.status)
        np.testing.assert_allclose(tr.final_norm, np.asarray(jr.final_norm),
                                   rtol=1e-10)
        rels[lev] = float(np.max(tr.final_norm))
    assert rels[1] < rels[0] * 0.5, rels


def _solve_both(cfg_text, m, b):
    js, ts = _setup_both(cfg_text, m)
    jr = js.solve(b)
    tr = ts.solve(b)
    assert tr.iters == int(jr.iters)
    assert tr.status == int(jr.status)
    xj = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    return tr


def test_ilu_as_amg_smoother():
    """test_selectors_ilu.py:206: classical AMG (HMIS, D1) with a
    MULTICOLOR_ILU smoother on a 20 x 20 Poisson."""
    cfg = (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "AMG", "algorithm": "CLASSICAL",'
        ' "selector": "HMIS", "interpolator": "D1",'
        ' "smoother": {"scope": "s", "solver": "MULTICOLOR_ILU",'
        ' "relaxation_factor": 1.0}, "presweeps": 1, "postsweeps": 1,'
        ' "max_levels": 8, "min_coarse_rows": 16,'
        ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
        ' "max_iters": 40, "monitor_residual": 1,'
        ' "convergence": "RELATIVE_INI", "tolerance": 1e-8}}'
    )
    m = poisson_scipy((20, 20))
    b = poisson_rhs(m.shape[0])
    tr = _solve_both(cfg, m, b)
    assert tr.status == SUCCESS
    rel = np.linalg.norm(b - m @ tr.x.numpy()) / np.linalg.norm(b)
    assert rel < 1e-7


GMRES_ILU0 = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "GMRES", "gmres_n_restart": 30,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "tolerance": 1e-08, "max_iters": 200,'
    ' "preconditioner": {"scope": "ilu",'
    ' "solver": "MULTICOLOR_ILU", "ilu_sparsity_level": 0,'
    ' "max_iters": 1, "monitor_residual": 0}}}'
)


def test_gmres_ilu0_nonsymmetric():
    """tests/test_nonsymmetric.py:50, acceptance config 4: GMRES(30) +
    ILU0 on the 24 x 24 upwind convection-diffusion operator."""
    m = convection_diffusion_2d(24)
    rng = np.random.default_rng(7)
    b = m @ rng.standard_normal(m.shape[0])
    tr = _solve_both(GMRES_ILU0, m, b)
    assert tr.status == SUCCESS and tr.iters < 60
    rel = np.linalg.norm(b - m @ tr.x.numpy()) / np.linalg.norm(b)
    assert rel < 1e-7


def test_chip_path_config_is_acceptance_config_4():
    """chip_smoke.py's gmres_ilu0 path runs this file's config."""
    import chip_smoke

    assert T.AMGConfig.from_string(chip_smoke.GMRES_ILU0_CFG).items() == \
        T.AMGConfig.from_string(GMRES_ILU0).items()


def test_block_ilu_raises():
    """Block matrices no longer raise: block ILU(0) (whole block columns
    eliminated with the inverted pivot blocks) applies as the JAX
    package's does, at rtol 1e-12."""
    from amgx_tpu_torch.solvers.dilu import MulticolorILUSolver

    text = _smoother()
    m = sps.kron(poisson_scipy((5, 5)), np.array([[3.0, 0.4], [0.2, 2.0]]),
                 format="csr")
    js = j_create(JConfig.from_string(text), "default")
    js.setup(JMatrix.from_scipy(m, block_size=2))
    s = T.create_solver(T.AMGConfig.from_string(text), "default",
                        device="cpu")
    assert isinstance(s, MulticolorILUSolver)
    s.setup(TMatrix.from_scipy(m, block_size=2, device="cpu"))
    assert s.num_colors == js.num_colors
    r = poisson_rhs(m.shape[0], seed=4)
    zj = np.asarray(js.make_apply()(js._params, r))
    zt = s.make_apply()(s._params, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=1e-12,
                               atol=1e-12 * np.abs(zj).max())
