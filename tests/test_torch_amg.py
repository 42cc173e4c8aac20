"""Aggregation-AMG parity of the PyTorch port with the JAX package (CPU).

The slice as a whole: PCG preconditioned by one aggregation-AMG V-cycle
(BLOCK_JACOBI smoothing, DENSE_LU coarse solve) on 3D Poisson, in the
two configs the repository runs — ``__graft_entry__.entry()`` (16^3,
SIZE_2) and ``bench.py``'s solve (SIZE_8), here at 24^3.  Both packages
must build the same hierarchy (level count, rows, nnz and format per
level), end with the same status, take the same iterations in f64 (one
more or fewer in f32) and agree on x: rtol 1e-10 in f64 (a whole solve
chains many reductions summed in another order than XLA's) and 1e-4 in
f32.  The solve phase is also held to JAX on the JAX package's own
hierarchy, carried across with ``hierarchy_from_numpy``.
"""

import numpy as np
import pytest
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.io.poisson import poisson_3d_7pt as j_poisson
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu_torch.amg.hierarchy import AMGSolver, hierarchy_from_numpy
from amgx_tpu_torch.io.poisson import poisson_3d_7pt as t_poisson

amgx_tpu.initialize()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _amg_cfg(selector="SIZE_8", min_coarse=512, max_iters=100, tol=1e-6,
             cycle="V", extra="", norm=""):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "PCG", "max_iters": {max_iters}, "tolerance": {tol},'
        f' "monitor_residual": 1, "convergence": "RELATIVE_INI"{norm},'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        f' "algorithm": "AGGREGATION", "selector": "{selector}",'
        ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
        ' "relaxation_factor": 0.8, "monitor_residual": 0},'
        ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
        f' "min_coarse_rows": {min_coarse}, "max_levels": 20,'
        f' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "{cycle}",'
        f' "monitor_residual": 0{extra}}}}}}}'
    )


BENCH = _amg_cfg()  # bench.py:_solve_record
ENTRY = _amg_cfg("SIZE_2", min_coarse=32, max_iters=20, tol=1e-5,
                 norm=', "norm": "L2"')  # __graft_entry__.entry()


def _jformat(A):
    if A.has_matrix_free:
        return "MATRIX_FREE"
    if A.has_dia:
        return "DIA"
    if A.has_dense:
        return "dense"
    return "ELL" if A.has_ell else "CSR"


def _run_jax(cfg_text, n, dtype):
    A = j_poisson(n, dtype=dtype)
    b = poisson_rhs(A.n_rows, dtype=dtype)
    s = j_create(JConfig.from_string(cfg_text), "default")
    s.setup(A)
    return s, s.solve(b), b


def _run_torch(cfg_text, n, dtype):
    A = t_poisson(n, dtype=dtype, device="cpu")
    b = poisson_rhs(A.n_rows, dtype=dtype)
    s = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                        device="cpu")
    s.setup(A)
    return s, s.solve(b), b


def _levels_jax(s):
    return [(lv.A.n_rows, lv.A.nnz, _jformat(lv.A))
            for lv in s.precond.levels]


def _levels_torch(s):
    return [(lv["rows"], lv["nnz"], lv["format"])
            for lv in s.precond.level_summary()]


def _assert_solves_match(jr, tr, dtype):
    assert tr.status == int(jr.status) == 0
    xj, xt = np.asarray(jr.x), tr.x.numpy()
    if dtype == np.float64:
        assert tr.iters == int(jr.iters)
        rtol = 1e-10
    else:
        assert abs(tr.iters - int(jr.iters)) <= 1
        rtol = 1e-4
    np.testing.assert_allclose(xt, xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())


_JAX_RUNS = {}


def _jax_run(key, cfg_text, n, dtype):
    """JAX solves shared by the tests of this module (each costs a
    compile)."""
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run_jax(cfg_text, n, dtype)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("config", ["entry_16", "bench_24"])
def test_slice_matches_jax(config, dtype):
    cfg_text, n = {"entry_16": (ENTRY, 16), "bench_24": (BENCH, 24)}[config]
    js, jr, _ = _jax_run((config, dtype), cfg_text, n, dtype)
    ts, tr, b = _run_torch(cfg_text, n, dtype)
    assert _levels_torch(ts) == _levels_jax(js)
    assert ts.precond.cycle_passes_per_iteration() == \
        js.precond.cycle_passes_per_iteration()
    _assert_solves_match(jr, tr, dtype)
    if config == "bench_24":
        # BENCH_r05.json: 13 iterations over 3 DIA levels at 24^3
        assert [f for _, _, f in _levels_torch(ts)] == ["DIA"] * 3
        if dtype == np.float32:
            assert tr.iters == 13


def test_bench_24_transfers_are_ell():
    ts, _, _ = _run_torch(BENCH, 24, np.float32)
    summary = ts.precond.level_summary()
    assert (summary[0]["P"], summary[0]["R"]) == ("ELL", "ELL")
    assert tuple(ts.precond.levels[0].R.ell_vals.shape) == (8, 1728)
    assert tuple(ts.precond.levels[0].P.ell_vals.shape) == (1, 13824)


def _export(js):
    """Per-level CSR numpy arrays of the JAX package's hierarchy."""
    def csr(M):
        return (np.asarray(M.row_offsets), np.asarray(M.col_indices),
                np.asarray(M.values), (M.n_rows, M.n_cols))

    levels = []
    for i, lv in enumerate(js.precond.levels):
        d = {"A": csr(lv.A)}
        if i + 1 < len(js.precond.levels):
            d["P"], d["R"] = csr(lv.P), csr(lv.R)
        levels.append(d)
    return levels


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_on_jax_hierarchy(dtype):
    js, jr, b = _jax_run(("bench_24", dtype), BENCH, 24, dtype)
    ts = hierarchy_from_numpy(_export(js), T.AMGConfig.from_string(BENCH),
                              device="cpu")
    amg = ts.precond
    assert isinstance(amg, AMGSolver)
    assert _levels_torch(ts) == _levels_jax(js)
    for lt, lj in zip(amg.levels[:-1], js.precond.levels[:-1]):
        np.testing.assert_array_equal(lt.P.to_dense(),
                                      np.asarray(lj.P.to_scipy().todense()))
    _assert_solves_match(jr, ts.solve(b), dtype)


def test_hierarchy_from_numpy_rejects_mismatch():
    js, _, _ = _jax_run(("bench_24", np.float64), BENCH, 24, np.float64)
    levels = _export(js)
    cfg = T.AMGConfig.from_string(
        '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
        ' "preconditioner": "NOSOLVER"}}'
    )
    with pytest.raises(ValueError, match="no AMG"):
        hierarchy_from_numpy(levels, cfg, device="cpu")


@pytest.mark.parametrize("cycle", ["W", "F"])
def test_w_and_f_cycles_match_jax(cycle):
    cfg_text = _amg_cfg("SIZE_2", min_coarse=64, cycle=cycle)
    js, jr, _ = _run_jax(cfg_text, 10, np.float64)
    ts, tr, _ = _run_torch(cfg_text, 10, np.float64)
    assert _levels_torch(ts) == _levels_jax(js)
    assert ts.precond.cycle_passes_per_iteration() == \
        js.precond.cycle_passes_per_iteration()
    _assert_solves_match(jr, tr, np.float64)


def test_matching_aggregation_matches_jax():
    """structured_aggregation=0: the host pairwise matcher, copied."""
    cfg_text = _amg_cfg("SIZE_4", min_coarse=64,
                        extra=', "structured_aggregation": 0')
    js, jr, _ = _run_jax(cfg_text, 10, np.float64)
    ts, tr, _ = _run_torch(cfg_text, 10, np.float64)
    assert _levels_torch(ts) == _levels_jax(js)
    for lt, lj in zip(ts.precond.levels[:-1], js.precond.levels[:-1]):
        np.testing.assert_array_equal(lt.P.to_dense(),
                                      np.asarray(lj.P.to_scipy().todense()))
    _assert_solves_match(jr, tr, np.float64)


@pytest.mark.parametrize("extra,match", [
    (', "hierarchy_dtype": "BFLOAT16"', "hierarchy_dtype"),
    (', "hierarchy_dtype": "FLOAT32"', "hierarchy_dtype"),
    (', "algorithm": "CLASSICAL", "hierarchy_dtype": "BF16"',
     "hierarchy_dtype"),
    (', "error_scaling": 2, "structure_reuse_levels": -1,'
     ' "hierarchy_dtype": "FLOAT32"', "hierarchy_dtype"),
])
def test_unported_amg_options_raise(extra, match):
    cfg_text = _amg_cfg(extra=extra)
    s = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                        device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        s.setup(t_poisson(6, device="cpu"))


def test_printed_stats_match_jax(capsys):
    """print_solve_stats, convergence_analysis, print_aggregation_info
    and print_grid_stats print what the JAX package prints (the grid
    table's last column is memory there and the format here)."""
    cfg_text = _amg_cfg(min_coarse=64, extra=(
        ', "print_grid_stats": 1, "verbosity_level": 3,'
        ' "print_aggregation_info": 1'
    )).replace('"max_iters": 100,', '"max_iters": 100,'
               ' "print_solve_stats": 1, "verbosity_level": 3,'
               ' "convergence_analysis": 3,')
    _run_jax(cfg_text, 12, np.float64)
    # the port keeps no per-level memory accounting
    jout = [ln for ln in capsys.readouterr().out.splitlines()
            if "Total Memory Usage" not in ln]
    _run_torch(cfg_text, 12, np.float64)
    tout = capsys.readouterr().out.splitlines()
    assert len(tout) == len(jout) > 30
    for lt, lj in zip(tout, jout):
        if "LVL" in lt or "(D)" in lt:
            assert lt.split()[:4] == lj.split()[:4]
        else:
            assert lt == lj
