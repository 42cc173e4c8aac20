"""Galerkin plans and ``replace_values`` of the PyTorch port against the
JAX package (CPU).

``amg/spgemm.py``: the symbolic phase is a copy of the JAX package's, so
the plans' index arrays must be equal bit for bit (the port keeps the
offsets of each output's run of pairs for the JAX package's
``out_idx``); ``apply`` sums each
output's pairs in another order than XLA's segment sum, so its values
agree with the JAX package's and with scipy's product to rtol 1e-12 in
f64, and two applies to the same values repeat bit for bit.

``SparseMatrix.replace_values``: for every format (DIA, MATRIX_FREE,
slot-major ELL, sliced ELL, dense, CSR only) the refilled matrix holds
the diagonal, planes, slots, coefficients and dense block that
``from_csr`` builds from the same values, bit for bit, in f32 and f64,
gives the same SpMV bit for bit, and its host CSR reads the new values.

Resetup (the counterparts of the JAX package's ``tests/test_spgemm.py``
resetup tests, each held to the JAX package's run on the same inputs):
after a values-only resetup the coarse operators the plans re-form equal
the JAX package's to rtol 1e-12 and ``R A P`` with the stored
transfers, each level is planned (or not) as in the JAX package, and the
solve takes the same iterations in f64 with x to rtol 1e-10.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.amg import spgemm as j_spgemm
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu_torch.amg import spgemm as t_spgemm
from amgx_tpu_torch.core.matrix import (
    SparseMatrix,
    _build_sell_np,
    sliced_ell,
)
from amgx_tpu_torch.io.poisson import poisson_scipy
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.krylov import KrylovSolver
from test_torch_amg_extras import (
    _cfg,
    _levels,
    _poisson,
    _same_solve,
    _solvers,
)

amgx_tpu.initialize()


def _rand_csr(m, n, density, seed):
    rng = np.random.default_rng(seed)
    sp = sps.random(m, n, density=density, random_state=rng, format="csr")
    sp.sort_indices()
    return sp


def _product_pattern(B, C):
    Out = (B @ C).tocsr()
    Out.sort_indices()
    return Out


def _same_plan(tp, jp):
    for f in ("left_idx", "right_idx"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    # the output position of each pair, from the runs' offsets
    out_idx = np.repeat(np.arange(tp.nnz_out), np.diff(tp.offsets.numpy()))
    np.testing.assert_array_equal(out_idx, np.asarray(jp.out_idx))
    assert tp.nnz_out == jp.nnz_out


SPMM_CASES = [(300, 200, 250, 0.05, 0.04, 1), (120, 120, 90, 0.08, 0.1, 2),
              (64, 400, 64, 0.02, 0.03, 3)]


@pytest.mark.parametrize("m,k,n,db,dc,seed", SPMM_CASES)
def test_plan_spmm_index_arrays_equal_jax(m, k, n, db, dc, seed):
    B = _rand_csr(m, k, db, seed)
    C = _rand_csr(k, n, dc, seed + 10)
    Out = _product_pattern(B, C)
    _same_plan(t_spgemm.plan_spmm(B, C, Out, device="cpu"),
               j_spgemm.plan_spmm(B, C, Out))


@pytest.mark.parametrize("m,k,n,db,dc,seed", SPMM_CASES)
def test_plan_spmm_apply_matches_jax_and_scipy(m, k, n, db, dc, seed):
    B = _rand_csr(m, k, db, seed)
    C = _rand_csr(k, n, dc, seed + 10)
    Out = _product_pattern(B, C)
    tp = t_spgemm.plan_spmm(B, C, Out, device="cpu")
    jp = j_spgemm.plan_spmm(B, C, Out)
    # new values on the same patterns: the numeric phase alone
    rng = np.random.default_rng(seed)
    bv = rng.standard_normal(B.nnz)
    cv = rng.standard_normal(C.nnz)
    got = tp.apply(torch.from_numpy(bv), torch.from_numpy(cv)).numpy()
    np.testing.assert_allclose(got, np.asarray(jp.apply(bv, cv)),
                               rtol=1e-12, atol=1e-14)
    B2 = sps.csr_matrix((bv, B.indices, B.indptr), shape=B.shape)
    C2 = sps.csr_matrix((cv, C.indices, C.indptr), shape=C.shape)
    ref = (B2 @ C2).toarray()
    dense = sps.csr_matrix((got, Out.indices, Out.indptr),
                           shape=Out.shape).toarray()
    np.testing.assert_allclose(dense, ref, rtol=1e-12, atol=1e-13)
    again = tp.apply(torch.from_numpy(bv), torch.from_numpy(cv)).numpy()
    assert again.tobytes() == got.tobytes()


def test_plan_rejects_a_pattern_that_does_not_cover_the_product():
    B = _rand_csr(100, 100, 0.05, 3)
    C = _rand_csr(100, 100, 0.05, 4)
    Out = (B @ C).tocsr()
    mask = np.arange(Out.nnz) % 2 == 0
    trunc = sps.csr_matrix(
        (Out.data[mask], Out.indices[mask],
         np.concatenate([[0], np.cumsum(np.bincount(
             np.repeat(np.arange(100), np.diff(Out.indptr))[mask],
             minlength=100))])),
        shape=Out.shape,
    )
    with pytest.raises(ValueError):
        j_spgemm.plan_spmm(B, C, trunc)
    with pytest.raises(ValueError):
        t_spgemm.plan_spmm(B, C, trunc, device="cpu")


@pytest.mark.parametrize("n,ratio", [(10, 8), (12, 4)])
def test_plan_rap_matches_jax_and_scipy(n, ratio):
    A = poisson_scipy((n, n, n)).tocsr()
    rows = A.shape[0]
    rng = np.random.default_rng(7)
    agg = rng.integers(0, rows // ratio, rows)
    P = sps.coo_matrix((rng.random(rows) + 0.5, (np.arange(rows), agg)),
                       shape=(rows, rows // ratio)).tocsr()
    P.sort_indices()
    R = P.T.tocsr()
    R.sort_indices()
    Ac = (R @ A @ P).tocsr()
    Ac.sort_indices()
    tp = t_spgemm.plan_rap(R, A, P, Ac, device="cpu")
    jp = j_spgemm.plan_rap(R, A, P, Ac)
    _same_plan(tp.ap, jp.ap)
    _same_plan(tp.rap, jp.rap)
    av = A.data * (1.0 + 0.1 * rng.standard_normal(A.nnz))
    got = tp.apply(torch.from_numpy(R.data), torch.from_numpy(av),
                   torch.from_numpy(P.data)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jp.apply(R.data, av, P.data)), rtol=1e-12)
    A2 = sps.csr_matrix((av, A.indices, A.indptr), shape=A.shape)
    ref = (R @ A2 @ P).toarray()
    dense = sps.csr_matrix((got, Ac.indices, Ac.indptr),
                           shape=Ac.shape).toarray()
    np.testing.assert_allclose(dense, ref, rtol=1e-12,
                               atol=1e-13 * np.abs(ref).max())
    assert tp.nbytes() == 4 * 2 * (tp.ap.n_paths + tp.rap.n_paths) + 8 * (
        tp.ap.nnz_out + tp.rap.nnz_out + 2)


# ---------------------------------------------------------------------------
# replace_values


def _stencil_values(sp, rng):
    """New values that keep a 7-point constant stencil a constant
    stencil: one random coefficient per diagonal."""
    rows = np.repeat(np.arange(sp.shape[0]), np.diff(sp.indptr))
    offs = sp.indices.astype(np.int64) - rows
    uniq, k = np.unique(offs, return_inverse=True)
    coef = rng.standard_normal(uniq.shape[0])
    return coef[k]


def _csr_system(fmt):
    """(scipy CSR, accel_formats) of a matrix that uploads as ``fmt``."""
    if fmt in ("DIA", "MATRIX_FREE"):
        formats = ("matrix_free", "dia") if fmt == "MATRIX_FREE" else \
            ("dia", "dense", "ell")
        return poisson_scipy((6, 5, 4)).tocsr(), formats
    sp = (_rand_csr(300, 300, 0.02, 5) + sps.eye(300)).tocsr()
    sp.sort_indices()
    formats = {"dense": ("dense",), "CSR": (), "ELL": ("ell",),
               "SELL": ("ell",)}[fmt]
    return sp, formats


def _upload(sp, values, formats, dtype, sell_sigma):
    A = SparseMatrix.from_csr(sp.indptr, sp.indices, values.astype(dtype),
                              accel_formats=formats, device="cpu")
    if sell_sigma is not None:
        w = int(np.diff(sp.indptr).max())
        A.sell = sliced_ell(_build_sell_np(
            sp.indptr.astype(np.int32), sp.indices.astype(np.int32),
            values.astype(dtype), sp.shape[0], w, sigmas=(sell_sigma,),
            always=True), "cpu")
    return A


FORMATS = ["DIA", "MATRIX_FREE", "ELL", "SELL", "dense", "CSR"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fmt", FORMATS)
def test_replace_values_refills_every_format_bitwise(fmt, dtype):
    sp, formats = _csr_system(fmt)
    rng = np.random.default_rng(11)
    # the sliced layout at its sorting windows (1: no sorting)
    for sigma in ((1, 128) if fmt == "SELL" else (None,)):
        A = _upload(sp, sp.data, formats, dtype, sigma)
        stencil = fmt == "MATRIX_FREE"
        v = _stencil_values(sp, rng) if stencil else \
            rng.standard_normal(sp.nnz)
        B = A.replace_values(v.astype(dtype))
        ref = _upload(sp, v, formats, dtype, sigma)
        want = {"DIA": "DIA", "MATRIX_FREE": "MATRIX_FREE", "ELL": "ELL",
                "SELL": "ELL", "dense": "dense", "CSR": "CSR"}[fmt]
        assert A.format == B.format == ref.format == want
        for f in ("values", "diag", "dia_vals", "mf_coefs", "dense",
                  "ell_cols", "ell_vals"):
            a, b = getattr(B, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), f
        if fmt == "SELL":
            assert torch.equal(B.sell.vals, ref.sell.vals)
            assert torch.equal(B.sell.cols, ref.sell.cols)
        x = torch.from_numpy(rng.standard_normal(sp.shape[1]).astype(dtype))
        assert torch.equal(spmv(B, x), spmv(ref, x))
        # the host triple reads the new values
        np.testing.assert_array_equal(B.host_csr().data, v.astype(dtype))
        np.testing.assert_array_equal(B.to_scipy().toarray(),
                                      ref.to_scipy().toarray())
        # the old matrix keeps its values
        np.testing.assert_array_equal(A.host_csr().data,
                                      sp.data.astype(dtype))


def test_replace_values_matches_the_jax_package():
    """The refilled DIA planes, diagonal and ELL slots equal the JAX
    package's ``replace_values`` on the same matrix (its ELL row-major,
    the port's slot-major)."""
    rng = np.random.default_rng(3)
    for sp, formats in (_csr_system("DIA"), _csr_system("ELL")):
        v = rng.standard_normal(sp.nnz)
        Aj = JMatrix.from_scipy(sp, dtype=np.float64,
                                accel_formats=formats).replace_values(v)
        At = SparseMatrix.from_scipy(sp, device="cpu",
                                     accel_formats=formats).replace_values(v)
        np.testing.assert_array_equal(At.diag.numpy(), np.asarray(Aj.diag))
        if At.has_dia:
            assert At.dia_offsets == tuple(Aj.dia_offsets)
            np.testing.assert_array_equal(At.dia_vals.numpy(),
                                          np.asarray(Aj.dia_vals))
        else:
            np.testing.assert_array_equal(At.ell_vals.numpy().T,
                                          np.asarray(Aj.ell_vals))


def test_replace_values_shares_its_source_maps():
    """The maps are derived once, on the first call, and every matrix
    derived from it shares them; a matrix never refilled holds none."""
    sp, formats = _csr_system("ELL")
    A = SparseMatrix.from_scipy(sp, device="cpu", accel_formats=formats)
    assert A._src is None
    B = A.replace_values(sp.data * 2)
    C = B.replace_values(sp.data * 3)
    assert A._src is B._src is C._src
    assert set(A._src) == {"diag", "ell", "sell"} or set(A._src) == {
        "diag", "ell"}


def test_replace_values_rejects_wrong_length_and_block_values():
    sp, formats = _csr_system("DIA")
    A = SparseMatrix.from_scipy(sp, device="cpu", accel_formats=formats)
    with pytest.raises(ValueError, match="values for"):
        A.replace_values(np.ones(sp.nnz + 1))
    with pytest.raises(NotImplementedError, match="block"):
        A.replace_values(np.ones((sp.nnz, 2, 2)))


# ---------------------------------------------------------------------------
# resetup with structure reuse


def _perturbed(sp, seed):
    """The same pattern with new values (a stronger diagonal keeps it
    SPD)."""
    rng = np.random.default_rng(seed)
    sp2 = sp.copy()
    sp2.data = sp2.data * (1.0 + 0.1 * rng.standard_normal(sp2.nnz))
    sp2 = (sp2 + sps.diags_array(
        np.asarray(np.abs(sp2).sum(axis=1)).ravel() * 0.1)).tocsr()
    sp2.sort_indices()
    assert (sp2.indptr == sp.indptr).all()
    assert (sp2.indices == sp.indices).all()
    return sp2


def _reuse_cfg(reuse, algorithm="AGGREGATION", extra="", **kw):
    sel = "SIZE_4" if algorithm == "AGGREGATION" else "PMIS"
    return _cfg(selector=sel, algorithm=algorithm,
                extra=f', "structure_reuse_levels": {reuse}{extra}', **kw)


def _resetup_both(js, ts, A_t, sp2):
    js.resetup(JMatrix.from_scipy(sp2, dtype=sp2.dtype))
    ts.resetup(A_t.replace_values(sp2.data))


def _planned(amg):
    return [lv.rap_plan is not None for lv in amg.levels]


def _assert_coarse_equal_jax_and_rap(ts, js):
    for lt, lj in zip(ts.precond.levels, js.precond.levels):
        np.testing.assert_allclose(lt.A.values.numpy(),
                                   np.asarray(lj.A.values), rtol=1e-12,
                                   atol=1e-14)
    lv = ts.precond.levels
    for i in range(len(lv) - 1):
        ref = (lv[i].R.to_scipy() @ lv[i].A.to_scipy()
               @ lv[i].P.to_scipy()).toarray()
        np.testing.assert_allclose(lv[i + 1].A.to_dense(), ref, rtol=1e-12,
                                   atol=1e-13 * np.abs(ref).max())


@pytest.mark.parametrize("algorithm", ["AGGREGATION", "CLASSICAL"])
def test_resetup_full_depth_matches_jax(algorithm):
    sp = _poisson(12)
    sp2 = _perturbed(sp, 5)
    text = _reuse_cfg(-1, algorithm)
    js, ts = _solvers(text, sp)
    A_t = ts.A
    assert _planned(ts.precond) == _planned(js.precond)
    assert all(_planned(ts.precond)[:-1])
    n_levels = len(ts.precond.levels)
    P0 = ts.precond.levels[0].P
    _resetup_both(js, ts, A_t, sp2)
    amg = ts.precond
    assert len(amg.levels) == n_levels
    assert amg.levels[0].P is P0  # the transfers are kept
    assert amg.setup_stats["coarsen_calls"] == 0
    assert amg.setup_profile["rap_execute"] > 0
    _assert_coarse_equal_jax_and_rap(ts, js)
    b = poisson_rhs(sp.shape[0], dtype=np.float64)
    _, tr = _same_solve(js, ts, b)
    rel = np.linalg.norm(b - sp2 @ tr.x.numpy()) / np.linalg.norm(b)
    assert rel < 1e-7


def test_resetup_partial_depth_matches_jax():
    """structure_reuse_levels 1: the top product re-forms from its plan,
    the levels below are re-coarsened on the host, as in the JAX
    package (the same values either way as a fresh setup: scaling A
    scales every Galerkin product)."""
    sp = _poisson(12)
    sp2 = sp.copy()
    sp2.data = sp2.data * 1.5
    text = _reuse_cfg(1)
    js, ts = _solvers(text, sp)
    _resetup_both(js, ts, ts.A, sp2)
    assert ts.precond.setup_stats["coarsen_calls"] == 1
    _, fresh = _solvers(text, sp2)
    assert _levels(ts.precond) == _levels(js.precond, jax=True) == \
        _levels(fresh.precond)
    for la, lj, lf in zip(ts.precond.levels, js.precond.levels,
                          fresh.precond.levels):
        np.testing.assert_allclose(la.A.values.numpy(),
                                   np.asarray(lj.A.values), rtol=1e-12)
        np.testing.assert_allclose(la.A.values.numpy(),
                                   lf.A.values.numpy(), rtol=1e-12)
    assert _planned(ts.precond) == _planned(js.precond)
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float64))


def test_resetup_with_another_pattern_sets_up_anew():
    sp1, sp2 = _poisson(10), _poisson(12)
    text = _reuse_cfg(-1)
    js, ts = _solvers(text, sp1)
    js.resetup(JMatrix.from_scipy(sp2, dtype=np.float64))
    ts.resetup(SparseMatrix.from_scipy(sp2, device="cpu"))
    assert ts.precond.setup_stats["coarsen_calls"] == 1
    assert _levels(ts.precond) == _levels(js.precond, jax=True)
    assert ts.precond.levels[0].n_rows == sp2.shape[0]
    _same_solve(js, ts, poisson_rhs(sp2.shape[0], dtype=np.float64))


def test_resetup_twice_with_the_same_values_repeats_bitwise():
    sp = _poisson(12)
    sp2 = _perturbed(sp, 9)
    ts = T.create_solver(T.AMGConfig.from_string(_reuse_cfg(-1)),
                         "default", device="cpu")
    A = SparseMatrix.from_scipy(sp, device="cpu")
    ts.setup(A)
    A2 = A.replace_values(sp2.data)
    ts.resetup(A2)
    first = [lv.A.values.clone() for lv in ts.precond.levels]
    b = poisson_rhs(sp.shape[0], dtype=np.float64)
    x1 = ts.solve(b).x
    ts.resetup(A.replace_values(sp2.data))
    for v, lv in zip(first, ts.precond.levels):
        assert torch.equal(v, lv.A.values)
    assert torch.equal(x1, ts.solve(b).x)


def test_resetup_matrix_free_keeps_every_level_matrix_free():
    """Backward-Euler steps L + I/dt of a 7-point Laplacian: the stencil
    stays constant, every level stays MATRIX_FREE after the resetup, and
    the solve equals the DIA hierarchy's bit for bit."""
    L = _poisson(16)
    eye = sps.eye(L.shape[0], format="csr")
    steps = [(L + eye / dt).tocsr() for dt in (1.0, 0.5)]
    for m in steps:
        m.sort_indices()
    b = poisson_rhs(L.shape[0], dtype=np.float64)
    xs = {}
    for mf in (0, 1):
        text = _reuse_cfg(-1, extra=f', "matrix_free": {mf}')
        ts = T.create_solver(T.AMGConfig.from_string(text), "default",
                             device="cpu")
        formats = ("matrix_free", "dia", "dense", "ell") if mf else \
            ("dia", "dense", "ell")
        A = SparseMatrix.from_scipy(steps[0], device="cpu",
                                    accel_formats=formats)
        ts.setup(A)
        before = [lv["format"] for lv in ts.precond.level_summary()]
        ts.resetup(A.replace_values(steps[1].data))
        after = [lv["format"] for lv in ts.precond.level_summary()]
        assert before == after
        assert ts.A.format == ("MATRIX_FREE" if mf else "DIA")
        if mf:
            assert all(f == "MATRIX_FREE" for f in after[:-1])
        xs[mf] = ts.solve(b).x
    assert torch.equal(xs[0], xs[1])


def test_classical_plans_match_jax_on_the_device_pipeline():
    """setup_location DEVICE: the device pipelines of both packages,
    each level planned or not alike, and the resetup's solve equal."""
    sp = _poisson(10)
    text = _reuse_cfg(-1, "CLASSICAL", extra=', "setup_location": "DEVICE"')
    js, ts = _solvers(text, sp)
    assert ts.precond.setup_stats["device_levels"] >= 2
    assert _planned(ts.precond) == _planned(js.precond)
    _resetup_both(js, ts, ts.A, _perturbed(sp, 4))
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float64))


@pytest.mark.parametrize("reestimate", [0, 2])
def test_chebyshev_bound_cache_matches_jax(reestimate):
    """CHEBYSHEV smoothers of a reused hierarchy resetup in place:
    ``bound_staleness`` counts the resetups served off the cached bounds
    and ``reestimate_eigs`` re-runs the power iteration every Nth, with
    lmax equal to the JAX package's."""
    sp = _poisson(12)
    text = _reuse_cfg(-1, smoother="CHEBYSHEV",
                      extra=f', "reestimate_eigs": {reestimate}').replace(
        '"relaxation_factor": 0.8,',
        f'"relaxation_factor": 0.8, "reestimate_eigs": {reestimate},')
    js, ts = _solvers(text, sp)
    A = ts.A
    b = poisson_rhs(sp.shape[0], dtype=np.float64)
    for k in range(3):
        _resetup_both(js, ts, A, _perturbed(sp, 20 + k))
        for lt, lj in zip(ts.precond.levels[:-1], js.precond.levels[:-1]):
            assert lt.smoother.bound_staleness == lj.smoother.bound_staleness
            assert lt.smoother.bound_staleness == (
                (k + 1) % reestimate if reestimate else k + 1)
            np.testing.assert_allclose(lt.smoother.lmax, lj.smoother.lmax,
                                       rtol=1e-12)
        _same_solve(js, ts, b)


def test_inexact_coarse_solver_resetup_matches_jax():
    sp = _poisson(12)
    text = _reuse_cfg(-1).replace('"coarse_solver": "DENSE_LU_SOLVER"',
                                  '"coarse_solver": "INEXACT"')
    js, ts = _solvers(text, sp)
    _resetup_both(js, ts, ts.A, _perturbed(sp, 6))
    assert ts.precond.setup_stats["coarsen_calls"] == 0
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float64))


def test_scaled_system_resetup_sets_up_anew():
    """A solver that scaled its system at setup cannot refresh values in
    place: its resetup is a full setup, as in the JAX package."""
    sp = _poisson(12)
    sp2 = _perturbed(sp, 8)
    text = _reuse_cfg(-1, outer_extra=', "scaling": "DIAGONAL_SYMMETRIC"')
    js, ts = _solvers(text, sp)
    _resetup_both(js, ts, ts.A, sp2)
    assert ts.precond.setup_stats["coarsen_calls"] == 1
    _, fresh = _solvers(text, sp2)
    b = poisson_rhs(sp.shape[0], dtype=np.float64)
    _, tr = _same_solve(js, ts, b)
    assert torch.equal(tr.x, fresh.solve(b).x)


KRYLOV = ["PCG", "CG", "PCGF", "PBICGSTAB", "BICGSTAB", "FGMRES", "GMRES",
          "IDR", "IDRMSYNC", "SSTEP_PCG"]


@pytest.mark.parametrize("name", KRYLOV)
def test_krylov_solvers_resetup_in_place(name):
    """Every Krylov solver inherits the values-only resetup: its
    preconditioner resetups and the solve equals a fresh setup's bit for
    bit."""
    sp = _poisson(8)
    sp2 = _perturbed(sp, 2)
    text = (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{name}", "max_iters": 200, "tolerance": 1e-8,'
        ' "monitor_residual": 1, "preconditioner": {"scope": "p",'
        ' "solver": "BLOCK_JACOBI", "max_iters": 1}}}'
    )
    ts = T.create_solver(T.AMGConfig.from_string(text), "default",
                         device="cpu")
    assert type(ts)._resetup_impl is KrylovSolver._resetup_impl
    A = SparseMatrix.from_scipy(sp, device="cpu")
    ts.setup(A)
    calls = []
    impl = type(ts).setup
    ts.setup = lambda M: calls.append(M) or impl(ts, M)
    ts.resetup(A.replace_values(sp2.data))
    assert calls == []
    fresh = T.create_solver(T.AMGConfig.from_string(text), "default",
                            device="cpu")
    fresh.setup(SparseMatrix.from_scipy(sp2, device="cpu"))
    b = poisson_rhs(sp.shape[0], dtype=np.float64)
    r1, r2 = ts.solve(b), fresh.solve(b)
    assert r1.status == 0 and r1.iters == r2.iters
    assert torch.equal(r1.x, r2.x)


def test_resetup_rejects_a_matrix_on_another_device():
    sp = _poisson(4)
    ts = T.create_solver(T.AMGConfig.from_string(_reuse_cfg(-1)),
                         "default", device="cpu")
    A = SparseMatrix.from_scipy(sp, device="cpu")
    ts.setup(A)
    A_meta = SparseMatrix(**{**A.__dict__, "values": A.values.to("meta")})
    with pytest.raises(ValueError, match="meta"):
        ts.resetup(A_meta)
