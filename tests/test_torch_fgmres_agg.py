"""The FGMRES_AGGREGATION slice as a whole: parity of the PyTorch port
with the JAX package (CPU).

AmgX's FGMRES_AGGREGATION config (FGMRES, restart 10, preconditioned by
an aggregation-AMG V-cycle with SIZE_2 selection, MULTICOLOR_DILU
post-smoothing and a DENSE_LU coarse solve) with ``monitor_residual``
1, as AmgX ships it, on the 7-point Poisson problem through both
packages' ``create_solver(cfg, "default") -> setup(A) -> solve(b)``.
The hierarchies must match (level count; rows, nnz and format per
level), the coloring must give the same colour count per level, the
solves the same status and iteration count in f64 with x at rtol 1e-10;
in f32, iterations within one and x at rtol 1e-4.
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
from amgx_tpu_torch.io.poisson import poisson_3d_7pt as t_poisson

amgx_tpu.initialize()

# tests/test_config.py's FGMRES_AGG string plus "monitor_residual": 1
FGMRES_AGG = """
{
    "config_version": 2,
    "solver": {
        "preconditioner": {
            "algorithm": "AGGREGATION",
            "solver": "AMG",
            "smoother": "MULTICOLOR_DILU",
            "presweeps": 0,
            "selector": "SIZE_2",
            "coarse_solver": "DENSE_LU_SOLVER",
            "max_iters": 1,
            "postsweeps": 3,
            "min_coarse_rows": 32,
            "relaxation_factor": 0.75,
            "scope": "amg",
            "max_levels": 50,
            "cycle": "V"
        },
        "use_scalar_norm": 1,
        "monitor_residual": 1,
        "solver": "FGMRES",
        "max_iters": 100,
        "gmres_n_restart": 10,
        "convergence": "RELATIVE_INI",
        "scope": "main",
        "tolerance": 1e-06,
        "norm": "L2"
    }
}
"""


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jformat(A):
    if A.has_matrix_free:
        return "MATRIX_FREE"
    if A.has_dia:
        return "DIA"
    if A.has_dense:
        return "dense"
    return "ELL" if A.has_ell else "CSR"


def _levels(s, fmt):
    return [
        (lv.A.n_rows, lv.A.nnz, fmt(lv.A),
         lv.smoother.num_colors if lv.smoother else None)
        for lv in s.precond.levels
    ]


def _run_both(n, dtype):
    b = poisson_rhs(n ** 3, dtype=dtype)
    js = j_create(JConfig.from_string(FGMRES_AGG), "default")
    js.setup(j_poisson(n, dtype=dtype))
    jr = js.solve(b)
    ts = T.create_solver(T.AMGConfig.from_string(FGMRES_AGG), "default",
                         device="cpu")
    ts.setup(t_poisson(n, dtype=dtype, device="cpu"))
    tr = ts.solve(b)
    return js, jr, ts, tr


@pytest.mark.parametrize("n,dtype,jax_iters", [
    (16, np.float64, 7),
    (24, np.float64, 8),
    (16, np.float32, 7),
])
def test_fgmres_aggregation_slice_matches_jax(n, dtype, jax_iters):
    js, jr, ts, tr = _run_both(n, dtype)
    assert _levels(ts, lambda A: A.format) == _levels(js, _jformat)
    assert all(lv.A.format == "DIA" for lv in ts.precond.levels)
    assert type(ts).__name__ == "FGMRESSolver"
    assert ts.precond.levels[0].smoother.registry_name == "MULTICOLOR_DILU"
    assert tr.status == int(jr.status) == 0
    assert int(jr.iters) == jax_iters
    xj, xt = np.asarray(jr.x), tr.x.numpy()
    if dtype == np.float64:
        assert tr.iters == int(jr.iters)
        rtol = 1e-10
    else:
        assert abs(tr.iters - int(jr.iters)) <= 1
        rtol = 1e-4
    np.testing.assert_allclose(xt, xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())
    k = min(tr.iters, int(jr.iters)) + 1
    np.testing.assert_allclose(
        tr.history[:k], np.asarray(jr.history)[:k], rtol=rtol * 10,
        atol=rtol * float(np.asarray(jr.initial_norm).max()),
    )
    # the solve converged for real, not only by its implicit estimate
    A = t_poisson(n, dtype=np.float64, device="cpu").host_csr()
    b64 = poisson_rhs(n ** 3, dtype=dtype).astype(np.float64)
    rel = np.linalg.norm(b64 - A @ xt.astype(np.float64)) / np.linalg.norm(
        b64)
    assert rel <= (1e-6 if dtype == np.float64 else 1e-5)
