"""Aggregation-AMG extras of the PyTorch port against the JAX package
(CPU): scaled coarse correction (``error_scaling`` 2-5) and the
K-cycles CG and CGF.  The values-only resetup with
``structure_reuse_levels`` is held to the JAX package in
``test_torch_spgemm.py``, beside the Galerkin plans it runs on (this
module's helpers serve both).

Each input, made from ``np.random.default_rng(seed)``, goes through
both packages.  Hierarchies must be equal (rows, nnz and format per
level); solves end with the same status and, in f64, the same
iterations with x to rtol 1e-10 (in f32 the iterations within one).
"""

import numpy as np
import pytest
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.io.poisson import poisson_scipy

amgx_tpu.initialize()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(outer="PCG", cycle="V", extra="", selector="SIZE_2",
         algorithm="AGGREGATION", smoother="BLOCK_JACOBI", sweeps=(1, 1),
         tol=1e-8, outer_extra=""):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "{outer}", "max_iters": 100, "tolerance": {tol},'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI"'
        f'{outer_extra},'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        f' "algorithm": "{algorithm}", "selector": "{selector}",'
        f' "smoother": {{"scope": "sm", "solver": "{smoother}",'
        ' "relaxation_factor": 0.8, "monitor_residual": 0},'
        f' "presweeps": {sweeps[0]}, "postsweeps": {sweeps[1]},'
        ' "max_iters": 1, "min_coarse_rows": 32, "max_levels": 20,'
        f' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "{cycle}",'
        f' "monitor_residual": 0{extra}}}}}}}'
    )


def _jformat(A):
    if A.has_matrix_free:
        return "MATRIX_FREE"
    if A.has_dia:
        return "DIA"
    if A.has_dense:
        return "dense"
    return "ELL" if A.has_ell else "CSR"


def _levels(amg, jax=False):
    if jax:
        return [(lv.A.n_rows, lv.A.nnz, _jformat(lv.A)) for lv in amg.levels]
    return [(lv["rows"], lv["nnz"], lv["format"])
            for lv in amg.level_summary()]


def _solvers(text, sp, dtype=np.float64, **kw):
    """The config set up on ``sp`` in both packages: (jax, torch)."""
    js = j_create(JConfig.from_string(text), "default")
    js.setup(JMatrix.from_scipy(sp.astype(dtype), dtype=dtype))
    ts = T.create_solver(T.AMGConfig.from_string(text), "default",
                         device="cpu")
    ts.setup(SparseMatrix.from_scipy(sp.astype(dtype), device="cpu", **kw))
    return js, ts


def _same_solve(js, ts, b, dtype=np.float64):
    jr, tr = js.solve(b), ts.solve(b)
    assert tr.status == int(jr.status) == 0
    xj, xt = np.asarray(jr.x), tr.x.numpy()
    if dtype == np.float64:
        assert tr.iters == int(jr.iters)
        np.testing.assert_allclose(xt, xj, rtol=1e-10,
                                   atol=1e-10 * np.abs(xj).max())
    else:
        assert abs(tr.iters - int(jr.iters)) <= 1
    return jr, tr


def _poisson(n):
    return poisson_scipy((n, n, n)).tocsr()


# ---------------------------------------------------------------------------
# scaled coarse correction and K-cycles


@pytest.mark.parametrize("cycle", ["V", "W", "F"])
@pytest.mark.parametrize("scaling", [2, 3, 4, 5])
def test_error_scaling_matches_jax(scaling, cycle):
    sp = _poisson(12)
    text = _cfg(cycle=cycle, extra=f', "error_scaling": {scaling}',
                sweeps=(2, 2))
    js, ts = _solvers(text, sp)
    assert _levels(ts.precond) == _levels(js.precond, jax=True)
    assert len(ts.precond.levels) >= 4
    assert ts.precond.cycle_passes_per_iteration() == \
        js.precond.cycle_passes_per_iteration()
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float64))


@pytest.mark.parametrize("outer,cycle,scaling", [
    ("PBICGSTAB", "W", 2), ("PCG", "F", 5)])
def test_error_scaling_f32_matches_jax(outer, cycle, scaling):
    sp = _poisson(12)
    text = _cfg(outer=outer, cycle=cycle, sweeps=(2, 2), tol=1e-6,
                extra=f', "error_scaling": {scaling}')
    js, ts = _solvers(text, sp, np.float32)
    assert _levels(ts.precond) == _levels(js.precond, jax=True)
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float32),
                np.float32)


def test_error_scaling_is_ignored_off_aggregation():
    """As in the reference, only aggregation levels scale the
    correction: a classical hierarchy's cycle is the plain one."""
    text = _cfg(algorithm="CLASSICAL", selector="PMIS",
                extra=', "error_scaling": 3')
    ts = T.create_solver(T.AMGConfig.from_string(text), "default",
                         device="cpu")
    assert ts.precond.error_scaling == 0


@pytest.mark.parametrize("cycle", ["CG", "CGF"])
def test_k_cycle_aggregation_matches_jax(cycle):
    sp = _poisson(12)
    text = _cfg(cycle=cycle, extra=', "cycle_iters": 2')
    js, ts = _solvers(text, sp)
    assert _levels(ts.precond) == _levels(js.precond, jax=True)
    assert len(ts.precond.levels) >= 4
    assert ts.precond.cycle_passes_per_iteration() == \
        js.precond.cycle_passes_per_iteration()
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float64))


@pytest.mark.parametrize("iters", [1, 3])
def test_k_cycle_classical_outer_amg_matches_jax(iters):
    """AMG as the outer solver with a CG K-cycle on classical levels
    (the host builder), the shape of AmgX's AMG_CLASSICAL_CG."""
    sp = _poisson(14)
    text = (
        '{"config_version": 2, "solver": {"scope": "main", "solver": "AMG",'
        ' "algorithm": "CLASSICAL", "max_iters": 100, "tolerance": 1e-8,'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
        f' "cycle": "CG", "cycle_iters": {iters}, "max_levels": 20,'
        ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
        ' "monitor_residual": 0}, "presweeps": 1, "postsweeps": 1}}'
    )
    js = j_create(JConfig.from_string(text), "default")
    js.setup(JMatrix.from_scipy(sp, dtype=np.float64))
    ts = T.create_solver(T.AMGConfig.from_string(text), "default",
                         device="cpu")
    ts.setup(SparseMatrix.from_scipy(sp, device="cpu"))
    assert _levels(ts) == _levels(js, jax=True)
    assert len(ts.levels) >= 4
    assert ts.cycle_passes_per_iteration() == \
        js.cycle_passes_per_iteration()
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float64))


def test_k_cycle_f32_matches_jax():
    sp = _poisson(14)
    text = _cfg(cycle="CGF", tol=1e-6)
    js, ts = _solvers(text, sp, np.float32)
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float32),
                np.float32)


# ---------------------------------------------------------------------------
# the card paths' configs and launch derivation (chip_smoke.py)


@pytest.mark.parametrize("name,n", [("PBICGSTAB_AGG_W_CFG", 16),
                                    ("AMG_CLASSICAL_CG_CFG", 16)])
def test_chip_smoke_configs_match_jax(name, n):
    """``chip_smoke.py``'s W-cycle and K-cycle paths run these configs:
    at a small size in f64 both packages build the same levels and take
    the same iterations to the same x."""
    import chip_smoke

    text = getattr(chip_smoke, name)
    sp = _poisson(n)
    js = j_create(JConfig.from_string(text), "default")
    js.setup(JMatrix.from_scipy(sp, dtype=np.float64))
    ts = T.create_solver(T.AMGConfig.from_string(text), "default",
                         device="cpu")
    ts.setup(SparseMatrix.from_scipy(sp, device="cpu"))
    jamg = getattr(js, "precond", None) or js
    tamg = getattr(ts, "precond", None) or ts
    assert _levels(tamg) == _levels(jamg, jax=True)
    assert len(tamg.levels) >= 3
    _same_solve(js, ts, poisson_rhs(sp.shape[0], dtype=np.float64))


@pytest.mark.parametrize("cycle,extra", [
    ("V", ""), ("W", ', "error_scaling": 2'), ("F", ', "error_scaling": 4'),
    ("CG", ""), ("CGF", ', "cycle_iters": 3, "error_scaling": 3'),
    ("CG", ', "cycle_iters": 0')])
def test_cycle_walk_counts_every_spmv_of_a_cycle(monkeypatch, cycle, extra):
    """``chip_smoke.cycle_walk`` derives the card paths' launch counts
    from the cycle's structure: it must count the A, P and R SpMVs one
    cycle makes, operator by operator."""
    import chip_smoke
    from amgx_tpu_torch.amg import hierarchy

    sp = _poisson(12)
    ts = T.create_solver(T.AMGConfig.from_string(_cfg(
        cycle=cycle, extra=extra, sweeps=(2, 1))), "default", device="cpu")
    ts.setup(SparseMatrix.from_scipy(sp, device="cpu"))
    amg = ts.precond
    where = {}
    for lv in amg.levels:
        for f in ("A", "P", "R"):
            m = getattr(lv, f)
            if m is not None:
                where[id(m)] = (lv.level_id, f)
    calls = {}
    real = hierarchy.spmv

    def counting(A, x, *a, **kw):
        key = where[id(A)]
        calls[key] = calls.get(key, 0) + 1
        return real(A, x, *a, **kw)

    # the cycle's SpMVs and those of its BLOCK_JACOBI sweeps (the base
    # class's residual step)
    monkeypatch.setattr(hierarchy, "spmv", counting)
    monkeypatch.setattr("amgx_tpu_torch.solvers.base.spmv", counting)
    z = torch.zeros(sp.shape[0], dtype=torch.float64)
    amg.make_cycle()(amg.apply_params(), z + 1.0, z)
    assert calls == chip_smoke.cycle_walk(amg)


def test_variable_diffusion_keeps_the_poisson_pattern():
    """The resetup path's operators: -div(kappa grad u) has the pattern
    of ``poisson_3d_7pt`` and is symmetric with a dominant diagonal; the
    heat steps add I / dt to the Laplacian's diagonal."""
    import chip_smoke

    P = _poisson(6)
    for k in (1, 2):
        A = chip_smoke.variable_diffusion_3d(6, k)
        assert np.array_equal(A.indptr, P.indptr)
        assert np.array_equal(A.indices, P.indices)
        assert abs(A - A.T).max() == 0
        # off-diagonal row sums: the diagonal's in the interior, less at
        # the walls
        off = np.asarray(abs(A).sum(axis=1)).ravel() - 2 * A.diagonal()
        assert (off <= 1e-12 * A.diagonal()).all() and (off < 0).any()
    H = chip_smoke.heat_step_3d(6, 0.25)
    np.testing.assert_array_equal((H - P).toarray(),
                                  4.0 * np.eye(P.shape[0]))
