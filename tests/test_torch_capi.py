"""The port's C API handle layer (``amgx_tpu_torch.api.capi``) against
the JAX package's (``amgx_tpu.api.capi``) on the CPU, ``h`` modes in
both: the same handle sequence (config, resources, matrix upload,
vectors, solver create / setup / solve, status, iterations, the
residual history, download) through both packages, for the
``tests/test_capi.py`` config (PCG + BLOCK_JACOBI), the bench
aggregation AMG config and PCG_CLASSICAL_V_JACOBI, in every mode of the
mode table (hFBI with BLOCK_JACOBI only: the JAX package cannot factor
a bf16 DENSE_LU level, ROADMAP.md queue C).

Tolerances:
  * f64 (and complex128) vectors: status and iterations equal, x and
    every ``solver_get_iteration_residual`` to rtol 1e-10;
  * f32 (and complex64) vectors: status equal, iterations within one,
    x to rtol 1e-4 (the port's parity rule: both sum dots and norms in
    their own order);
  * an AMG hierarchy in f32 under f64 vectors (hDFI, hIFI, hZCI): both
    packages run the whole cycle in the hierarchy's f32
    (``make_step``'s boundary cast), where the ELL restriction (XLA's
    ``jnp.sum`` against the port's slot order) and the f32 dense LU
    round differently, 5e-8 and 4e-7 relative at 12^3.  So the
    residual history agrees to rtol 1e-5 there; status, iterations and
    x (to 1e-10 of its largest entry) as with f64 vectors.
"""

import numpy as np
import pytest

from amgx_tpu.api import capi as J
from amgx_tpu_torch.api import capi as T
from amgx_tpu_torch.io.poisson import poisson_scipy

CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "tolerance": 1e-08, "max_iters": 300,'
    ' "preconditioner": {"scope": "p", "solver": "BLOCK_JACOBI",'
    ' "max_iters": 2, "monitor_residual": 0}}}'
)
# the bench config (bench.py:_solve_record; chip_smoke.BENCH_CFG)
BENCH = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-6,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 512, "max_levels": 20,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)
# AmgX's PCG_CLASSICAL_V_JACOBI (chip_smoke.PCG_CLASSICAL)
CLASSICAL = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG", "cycle": "V",'
    ' "max_iters": 1, "presweeps": 1, "postsweeps": 1, "max_levels": 100,'
    ' "monitor_residual": 0,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}}'
)
CONFIGS = {"jacobi": CFG, "bench": BENCH, "classical": CLASSICAL}
MODES = ("hDDI", "hDFI", "hIDI", "hIFI", "hFFI", "hFBI", "hZZI", "hCCI",
         "hZCI")
CASES = [(c, m) for c in CONFIGS for m in MODES
         if m != "hFBI" or c == "jacobi"]


@pytest.fixture(autouse=True)
def _init():
    J.initialize()
    T.initialize()
    yield
    J.finalize()
    T.finalize()


def poisson_csr(n_side):
    sp = poisson_scipy((n_side,) * 3).tocsr()
    sp.sort_indices()
    return sp


def rhs_for(mode, n, seed=1):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n)
    if mode[1] in "ZC":
        b = b + 1j * rng.standard_normal(n)
    return b


def handle_flow(C, mode, cfg, n_side=12, seed=1, sp=None, rhs=None):
    """The AMGX_* sequence of a host code through package ``C`` on the
    CSR ``sp`` (default the n_side^3 Poisson matrix) and ``rhs``
    (default a seeded random one): (status, iterations, x, residual
    history, handles)."""
    c = C.config_create(cfg)
    r = C.resources_create_simple(c)
    sp = poisson_csr(n_side) if sp is None else sp
    n = sp.shape[0]
    A = C.matrix_create(r, mode)
    assert C.matrix_upload_all(
        A, n, sp.nnz, 1, 1, sp.indptr.astype(np.int32),
        sp.indices.astype(np.int32), sp.data) == C.RC_OK
    b = C.vector_create(r, mode)
    x = C.vector_create(r, mode)
    C.vector_upload(b, n, 1, rhs_for(mode, n, seed) if rhs is None else rhs)
    C.vector_set_zero(x, n, 1)
    C.vector_bind(x, A)
    s = C.solver_create(r, mode, c)
    assert C.solver_setup(s, A) == C.RC_OK
    assert C.solver_solve(s, b, x) == C.RC_OK
    iters = C.solver_get_iterations_number(s)
    hist = [C.solver_get_iteration_residual(s, i) for i in range(iters + 1)]
    return (C.solver_get_status(s), iters, C.vector_download(x),
            np.array(hist), dict(cfg=c, res=r, A=A, b=b, x=x, s=s, n=n))


def wide_vectors(mode):
    return mode[1] in "DIZ"


def hierarchy_in_f32_under_f64(cfg_name, mode):
    return cfg_name != "jacobi" and mode in ("hDFI", "hIFI", "hZCI")


def assert_same_solve(mode, cfg_name, j, t):
    (sj, ij, xj, hj, _), (st, it, xt, ht, _) = j, t
    assert st == sj == T.SOLVE_SUCCESS
    assert xt.dtype == xj.dtype == np.dtype(
        {"D": np.float64, "I": np.float64, "F": np.float32,
         "Z": np.complex128, "C": np.complex64}[mode[1]])
    scale = float(np.max(np.abs(xj)))
    if wide_vectors(mode):
        assert it == ij
        np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-10 * scale)
        rtol = 1e-5 if hierarchy_in_f32_under_f64(cfg_name, mode) \
            else 1e-10
        np.testing.assert_allclose(ht, hj, rtol=rtol)
    else:
        assert abs(it - ij) <= 1
        np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("cfg_name,mode", CASES,
                         ids=[f"{c}-{m}" for c, m in CASES])
def test_handle_flow_matches_the_jax_package(cfg_name, mode):
    cfg = CONFIGS[cfg_name]
    assert_same_solve(mode, cfg_name, handle_flow(J, mode, cfg),
                      handle_flow(T, mode, cfg))


@pytest.mark.parametrize("mode", ["hDDI", "hFFI"])
def test_warm_start_and_zero_initial_guess(mode):
    """solver_solve starts from the solution vector's contents,
    solve_with_0_initial_guess from zero, in both packages."""
    out = {}
    for C in (J, T):
        st, it, x, _, h = handle_flow(C, mode, CFG)
        C.vector_upload(h["x"], h["n"], 1, 0.5 * x)
        C.solver_solve(h["s"], h["b"], h["x"])
        warm = C.solver_get_iterations_number(h["s"])
        C.solver_solve_with_0_initial_guess(h["s"], h["b"], h["x"])
        cold = C.solver_get_iterations_number(h["s"])
        out[C] = (it, warm, cold, C.vector_download(h["x"]))
    (ij, wj, cj, xj), (it_, wt, ct, xt) = out[J], out[T]
    assert ct == it_
    assert abs(wt - wj) <= (0 if mode == "hDDI" else 1)
    assert abs(ct - cj) <= (0 if mode == "hDDI" else 1)
    tol = 1e-10 if mode == "hDDI" else 1e-4
    np.testing.assert_allclose(xt, xj, rtol=tol,
                               atol=tol * float(np.max(np.abs(xj))))


def test_mode_table_matches_the_jax_package():
    from amgx_tpu.core.types import _MODES as JMODES
    from amgx_tpu_torch.core.types import _MODES as TMODES

    assert sorted(JMODES) == sorted(TMODES)
    for name in JMODES:
        assert T.mode_itemsizes(name) == J.mode_itemsizes(name), name
        assert TMODES[name].device == ("cuda" if name[0] == "d" else "cpu")
