"""Block solvers of the PyTorch port against the JAX package (CPU).

The same seeded block systems go through both packages, in f64:

  * two sweeps (and the zero-guess application) of BLOCK_JACOBI (the
    inverted b x b diagonal blocks), MULTICOLOR_DILU (native b x b E
    factors) and MULTICOLOR_ILU (block-column elimination, ILU(0) and
    ILU(1)) at b = 2, 3 and 4, equal at rtol 1e-12; the block DILU's
    colours, E inverses and slices bit for bit;
  * PCG + aggregation AMG (MULTICOLOR_DILU, DENSE_LU) on a block system,
    which AMG expands to scalars: the case of the JAX package's
    ``tests/test_solvers.py::test_block_matrix_amg_pcg`` and the b = 4
    Poisson system of ``__graft_entry__.dryrun_multichip`` at 8^3.  Same
    status and iterations, x at rtol 1e-10, the per-component history
    and the same hierarchy (levels, rows, nonzeros, format);
  * Krylov solvers and the scalarizing smoothers on a block system,
    with per-component norms (``use_scalar_norm`` 0) and one norm
    (``use_scalar_norm`` 1);
  * an AMG resetup (``structure_reuse_levels``) on a block system.
"""

import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
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


@pytest.fixture(autouse=True)
def _quiet_expansion():
    # the notice that a block matrix is expanded to scalars
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


def _cfg(solver, extra="", iters=100, tol=1e-8, monitor=1):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{solver}", "max_iters": {iters},'
        f' "monitor_residual": {monitor}, "convergence": "RELATIVE_INI",'
        f' "tolerance": {tol}, "norm": "L2"{extra}}}}}'
    )


def kron_system(b, shape, coupling=None, seed=0):
    """kron(Poisson, B): B = I_b + 0.2 * ones (the dryrun_multichip
    block) or, with ``coupling``, I_b + coupling * a seeded random
    matrix (nonsymmetric blocks)."""
    if coupling is None:
        B = np.eye(b) + 0.2 * np.ones((b, b))
    else:
        rng = np.random.default_rng(seed)
        B = np.eye(b) + coupling * rng.standard_normal((b, b))
    return sps.kron(poisson_scipy(shape), B, format="csr")


def setup_both(cfg_text, sp, b):
    js = j_create(JConfig.from_string(cfg_text), "default")
    js.setup(JMatrix.from_scipy(sp, block_size=b))
    ts = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(sp, block_size=b, device="cpu"))
    return js, ts


def assert_close(xt, xj, rtol):
    np.testing.assert_allclose(xt, xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())


def assert_solve_parity(jr, tr, ncomp):
    assert tr.status == int(jr.status) == SUCCESS
    assert tr.iters == int(jr.iters)
    assert_close(tr.x.numpy(), np.asarray(jr.x), 1e-10)
    hj = np.asarray(jr.history)
    assert tr.history.shape == hj.shape and hj.shape[1] == ncomp
    k = tr.iters + 1
    np.testing.assert_allclose(
        tr.history[:k], hj[:k], rtol=1e-9,
        atol=1e-10 * float(np.asarray(jr.initial_norm).max()))
    assert tr.final_norm.shape == (ncomp,)
    np.testing.assert_allclose(
        tr.final_norm, np.asarray(jr.final_norm), rtol=1e-8,
        atol=1e-10 * float(np.asarray(jr.initial_norm).max()))


SWEEPS = {
    "BLOCK_JACOBI": ', "relaxation_factor": 0.8',
    "MULTICOLOR_DILU": ', "relaxation_factor": 0.9',
    "MULTICOLOR_ILU": "",
    "MULTICOLOR_ILU_1": ', "ilu_sparsity_level": 1',
}


@pytest.mark.parametrize("b", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_block_sweeps_match_jax(name, b):
    solver = name.replace("_1", "")
    text = _cfg(solver, SWEEPS[name], iters=1, monitor=0)
    # ILU(1)'s fill pattern takes many colours in 3D: a 2D grid
    shape = (6, 6) if name.endswith("_1") else (5, 5, 4)
    sp = kron_system(b, shape, coupling=0.3, seed=b)
    js, ts = setup_both(text, sp, b)
    assert ts._params[0].block_size == b  # native: no expansion
    if solver != "BLOCK_JACOBI":
        assert ts.num_colors == js.num_colors
    rng = np.random.default_rng(b)
    rhs = rng.standard_normal(sp.shape[0])
    x0 = rng.standard_normal(sp.shape[0])
    # jitted: the JAX package's sweeps of ILU(1)'s many unrolled
    # colours take seconds op by op
    xj = np.asarray(jax.jit(lambda p, r, x: js.make_smooth()(p, r, x, 2))(
        js._params, rhs, x0))
    xt = ts.make_smooth()(ts._params, torch.from_numpy(rhs),
                          torch.from_numpy(x0), 2).numpy()
    assert_close(xt, xj, 1e-12)
    zj = np.asarray(jax.jit(js.make_apply())(js._params, rhs))
    zt = ts.make_apply()(ts._params, torch.from_numpy(rhs)).numpy()
    assert_close(zt, zj, 1e-12)


def _jax_block_dilu(js):
    """Per colour (rows, L cols, L vals, U cols, U vals) and Einv of the
    JAX package's block DILU (its stacked or per-colour layout)."""
    _, Ls, Us, rows, einv = js._params
    if js._fori:
        (Lc, Lv), (Uc, Uv) = Ls, Us
        rows = np.asarray(rows)
        return [(rows[c], np.asarray(Lc[c]), np.asarray(Lv[c]),
                 np.asarray(Uc[c]), np.asarray(Uv[c]))
                for c in range(rows.shape[0])], np.asarray(einv)
    return [(np.asarray(rows[c]), np.asarray(Ls[c][0]),
             np.asarray(Ls[c][1]), np.asarray(Us[c][0]),
             np.asarray(Us[c][1])) for c in range(len(rows))], \
        np.asarray(einv)


@pytest.mark.parametrize("b", [2, 4])
def test_block_dilu_setup_matches_jax_bitwise(b):
    """The block graph's colours, the rows of each colour, the inverted
    E blocks and the block slices of L and U, bit for bit."""
    text = _cfg("MULTICOLOR_DILU", iters=1, monitor=0)
    js, ts = setup_both(text, kron_system(b, (6, 6, 6), coupling=0.3), b)
    jstages, jeinv = _jax_block_dilu(js)
    stages = [[t.numpy() for t in st] for st in ts._params[1]]
    assert len(stages) == len(jstages) == ts.num_colors
    for (rows, einv, *tsl), (jrows, *jsl) in zip(stages, jstages):
        k = rows.shape[0]
        assert np.array_equal(jrows[:k], rows)
        assert np.array_equal(einv, jeinv[rows])
        for (tc, tv), (jc, jv) in zip((tsl[:2], tsl[2:]),
                                      (jsl[:2], jsl[2:])):
            w = tc.shape[1]
            assert tv.shape == (k, w, b, b)
            assert np.array_equal(jc[:k, :w], tc)
            assert np.array_equal(jv[:k, :w], tv)
            assert not np.any(jv[:k, w:])


BLOCK_AMG = (
    ', "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_2",'
    ' "smoother": {"scope": "d", "solver": "MULTICOLOR_DILU",'
    ' "relaxation_factor": 1.0, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1, "cycle": "V",'
    ' "coarse_solver": "DENSE_LU_SOLVER", "monitor_residual": 0}'
)


def _jformat(A):
    if A.has_dia:
        return "DIA"
    if A.has_dense:
        return "dense"
    return "ELL" if A.has_ell else "CSR"


def assert_same_hierarchy(js, ts):
    jl = js.precond.levels if hasattr(js, "precond") else js.levels
    tl = ts.precond.levels if hasattr(ts, "precond") else ts.levels
    assert [(lv.A.n_rows, lv.A.nnz, _jformat(lv.A)) for lv in jl] == [
        (lv.A.n_rows, lv.A.nnz, lv.A.format) for lv in tl]
    assert all(lv.A.block_size == 1 for lv in tl)


@pytest.mark.parametrize("case", ["random_b2", "kron_b4_8cube"])
def test_block_amg_pcg_matches_jax(case):
    if case == "random_b2":
        # tests/test_solvers.py::test_block_matrix_amg_pcg
        from tests.conftest import random_csr

        b, sp = 2, random_csr(64, density=0.15, seed=11, spd=True)
        text = _cfg("PCG", BLOCK_AMG.replace(
            '"relaxation_factor": 1.0, ', '').replace(
            '"presweeps": 1, "postsweeps": 1, ', '').replace(
            ', "coarse_solver": "DENSE_LU_SOLVER"', ''), iters=200)
        rhs = np.random.default_rng(11).standard_normal(sp.shape[0])
    else:
        b, sp = 4, kron_system(4, (8, 8, 8))
        text = _cfg("PCG", BLOCK_AMG, iters=200, tol=1e-6)
        rhs = np.random.default_rng(0).standard_normal(sp.shape[0])
    js, ts = setup_both(text, sp, b)
    assert_same_hierarchy(js, ts)
    if case == "kron_b4_8cube":
        lv0 = ts.precond.levels[0].A
        assert lv0.format == "DIA" and len(lv0.dia_offsets) == 43
    assert_solve_parity(js.solve(rhs), ts.solve(rhs), b)


KRYLOV = {
    "pbicgstab_bj": _cfg("PBICGSTAB", ', "preconditioner": {"scope": "j",'
                         ' "solver": "BLOCK_JACOBI", "max_iters": 2,'
                         ' "monitor_residual": 0}'),
    "gmres_dilu": _cfg("GMRES", ', "gmres_n_restart": 8,'
                       ' "preconditioner": {"scope": "d", "solver":'
                       ' "MULTICOLOR_DILU", "max_iters": 1,'
                       ' "monitor_residual": 0}'),
    "idr_ilu": _cfg("IDR", ', "subspace_dim_s": 4, "preconditioner":'
                    ' {"scope": "i", "solver": "MULTICOLOR_ILU",'
                    ' "max_iters": 1, "monitor_residual": 0}'),
    "sstep_bj": _cfg("SSTEP_PCG", ', "s_step": 2, "preconditioner":'
                     ' {"scope": "j", "solver": "BLOCK_JACOBI",'
                     ' "max_iters": 1, "monitor_residual": 0}'),
    "pcg_chebyshev": _cfg("PCG", ', "preconditioner": {"scope": "c",'
                          ' "solver": "CHEBYSHEV", "max_iters": 1,'
                          ' "monitor_residual": 0}'),
    "pcg_kpz": _cfg("PCG", ', "preconditioner": {"scope": "p",'
                    ' "solver": "KPZ_POLYNOMIAL", "max_iters": 1,'
                    ' "monitor_residual": 0}'),
    "multicolor_gs": _cfg("MULTICOLOR_GS", ', "relaxation_factor": 0.9'),
    "amg_outer": _cfg("AMG", ', "algorithm": "AGGREGATION", "selector":'
                      ' "SIZE_2", "smoother": {"scope": "d", "solver":'
                      ' "MULTICOLOR_DILU", "monitor_residual": 0},'
                      ' "coarse_solver": "DENSE_LU_SOLVER"', iters=50,
                      tol=1e-6),
    "jacobi_l1": _cfg("JACOBI_L1", iters=30, tol=1e-2),
    "pcg_bj_scalar_norm": _cfg("PCG", ', "use_scalar_norm": 1,'
                               ' "preconditioner": {"scope": "j",'
                               ' "solver": "BLOCK_JACOBI", "max_iters": 2,'
                               ' "monitor_residual": 0}'),
    "pcg_bj_scaled": _cfg("PCG", ', "scaling": "DIAGONAL_SYMMETRIC",'
                          ' "preconditioner": {"scope": "j", "solver":'
                          ' "BLOCK_JACOBI", "max_iters": 2,'
                          ' "monitor_residual": 0}'),
}


@pytest.mark.parametrize("name", sorted(KRYLOV))
def test_block_solvers_match_jax(name):
    b = 3
    sp = kron_system(b, (5, 5, 5))
    js, ts = setup_both(KRYLOV[name], sp, b)
    rhs = np.random.default_rng(1).standard_normal(sp.shape[0])
    jr, tr = js.solve(rhs), ts.solve(rhs)
    # GMRES monitors its Arnoldi residual as one norm, as in JAX
    ncomp = 1 if name in ("pcg_bj_scalar_norm", "gmres_dilu") else b
    if name == "jacobi_l1":
        assert tr.iters == int(jr.iters)
        assert tr.history.shape == np.asarray(jr.history).shape
        assert_close(tr.x.numpy(), np.asarray(jr.x), 1e-10)
        return
    assert_solve_parity(jr, tr, ncomp)


def test_block_amg_resetup_matches_jax():
    """``structure_reuse_levels`` on a block system: replace_values on
    the block matrix, resetup (the expansion refreshed, the coarse
    operators re-formed from the plans), the same solve as the JAX
    package's resetup."""
    b = 2
    sp = kron_system(b, (6, 6, 6), coupling=0.1)
    text = _cfg("PCG", BLOCK_AMG.replace(
        '"cycle": "V"', '"cycle": "V", "structure_reuse_levels": -1'),
        tol=1e-8)
    js, ts = setup_both(text, sp, b)
    rhs = np.random.default_rng(4).standard_normal(sp.shape[0])
    jA = JMatrix.from_scipy(sp, block_size=b)
    tA = ts.A
    rng = np.random.default_rng(9)
    v2 = np.asarray(jA.values) * (1.0 + 0.05 * rng.standard_normal(
        np.asarray(jA.values).shape))
    js.resetup(jA.replace_values(v2))
    ts.resetup(tA.replace_values(v2))
    assert ts.A.block_size == b
    assert_same_hierarchy(js, ts)
    for jl, tl in zip(js.precond.levels, ts.precond.levels):
        np.testing.assert_allclose(tl.A.to_dense(), np.asarray(
            jl.A.to_dense()), rtol=1e-12, atol=1e-12)
    assert_solve_parity(js.solve(rhs), ts.solve(rhs), b)


def test_device_match_ranks_equal_host_on_block_expansion():
    """The matcher's preference ranks sorted by torch (as on the card)
    equal the host ``np.lexsort`` ranks on the expansion of a block
    system, whose Galerkin levels the wider torch gate lets match on
    the device; the aggregates equal the host matcher's."""
    from amgx_tpu_torch.amg import aggregation as tagg
    from amgx_tpu_torch.ops.diagonal import scalarized

    sp = kron_system(4, (6, 6, 6))
    S = scalarized(TMatrix.from_scipy(sp, block_size=4, device="cpu"), "x")
    W = tagg.edge_weights(S.host_csr(), 0)
    W.data[::7] = 0.0  # ties at zero, stored
    host = tagg._match_ell_arrays(W, 64)
    dev = tagg._match_ell_arrays(W, 64, device="cpu")
    assert np.array_equal(host[0], dev[0].numpy())
    assert np.array_equal(host[1], dev[1].numpy())
    assert np.array_equal(tagg.pairwise_match_device(W, device="cpu"),
                          tagg.pairwise_match(W))


def test_block4_ell_operators_cover_derived_launches():
    """``chip_smoke.py``'s block path holds the ELL kernels on every ELL
    operator of its hierarchy: the operators' launches per solve add up
    to the ``ell_spmv`` and ``sell_spmv`` launches that the cycle walk
    derives for the solve (12^3 x 4 f32 on the CPU, where level 0's
    transfers are ELL)."""
    import chip_smoke as cs

    s, res, *_ = cs.block4_solve("cpu", cs.BLOCK4_AMG_CFG, 12, np.float32)
    assert res.status == SUCCESS
    amg, iters = s.precond, int(res.iters)
    derived = cs.derived_launches(amg, iters + 1, 0)
    ops = cs.ell_operators(amg, iters)
    assert ops and derived["dia_spmv"] > 0
    assert sum(per for *_, per in ops) == (derived["ell_spmv"]
                                           + derived["sell_spmv"])
