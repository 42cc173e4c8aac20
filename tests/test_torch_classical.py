"""Classical (Ruge-Stueben) AMG in the port against the JAX package (CPU).

The host pipeline (``amg/classical.py``, ``amg/energymin.py``) is a copy
of the JAX package's, so every stage must give the same arrays bit for
bit: strength (AHAT, ALL, AFFINITY), the C/F selectors, the D1 / D2 /
MULTIPASS interpolators, truncation, whole levels.  Inputs are the
three matrices of the JAX package's device-setup tests, made from a
seed.  Whole solves: AmgX's PCG_CLASSICAL_V_JACOBI config (no
``algorithm`` key: classical is the default) with host setup in both
packages gives the same iterations in f64 with x at rtol 1e-10, and
iterations within one with x at rtol 1e-4 in f32; ENERGYMIN likewise.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
from amgx_tpu.amg import classical as j_host
from amgx_tpu.amg import energymin as j_em
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.io.poisson import poisson_3d_7pt as j_poisson
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.solvers import create_solver as j_create

import amgx_tpu_torch as T
from amgx_tpu_torch.amg import classical as t_host
from amgx_tpu_torch.amg import energymin as t_em
from amgx_tpu_torch.io.poisson import poisson_3d_7pt as t_poisson

amgx_tpu.initialize()

# AmgX's PCG_CLASSICAL_V_JACOBI.json
PCG_CLASSICAL = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG", "cycle": "V",'
    ' "max_iters": 1, "presweeps": 1, "postsweeps": 1, "max_levels": 100,'
    ' "monitor_residual": 0,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}}'
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problems():
    rng = np.random.default_rng(1234)
    A1 = j_poisson(8, dtype=np.float64).to_scipy().tocsr()
    n = 300
    B = sps.random(n, n, density=0.02,
                   random_state=np.random.RandomState(7))
    B = B + B.T
    A2 = (sps.eye(n) * (np.abs(B).sum(axis=1).max() + 1) - B).tocsr()
    A3 = A1 + sps.diags_array(
        rng.standard_normal(A1.shape[0] - 1) * 0.05, offsets=1,
        shape=A1.shape,
    ).tocsr()
    out = []
    for A in (A1, A2, A3.tocsr()):
        A = A.tocsr()
        A.sort_indices()
        out.append(A)
    return out


PROBLEMS = _problems()
PIS = [0, 1, 2]


def _same(a, b):
    """Bit-for-bit equality of arrays or scipy matrices."""
    if sps.issparse(a):
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape
        for f in ("indptr", "indices", "data"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mrs", [1.1, 0.9])
@pytest.mark.parametrize("pi", PIS)
def test_strength_ahat_bitwise(pi, mrs):
    A = PROBLEMS[pi]
    St, ft = t_host.strength_ahat(A, 0.25, mrs, return_flags=True)
    Sj, fj = j_host.strength_ahat(A, 0.25, mrs, return_flags=True)
    _same(St, Sj)
    _same(ft, fj)
    _same(t_host.strong_entry_flags(A, St), j_host.strong_entry_flags(A, Sj))


@pytest.mark.parametrize("pi", PIS)
def test_strength_all_and_affinity_bitwise(pi):
    A = PROBLEMS[pi]
    St, ft = t_host.strength_all(A, return_flags=True)
    Sj, fj = j_host.strength_all(A, return_flags=True)
    _same(St, Sj)
    _same(ft, fj)
    _same(t_host.strength_affinity(A, 0.25), j_host.strength_affinity(A, 0.25))


SELECTORS = ["pmis_select", "rs_select", "hmis_select",
             "aggressive_pmis_select", "cr_select"]


@pytest.mark.parametrize("sel", SELECTORS)
@pytest.mark.parametrize("pi", PIS)
def test_selectors_bitwise(pi, sel):
    A = PROBLEMS[pi]
    S = j_host.strength_ahat(A, 0.25, 1.1)
    args = (S, A) if sel == "cr_select" else (S,)
    cf = getattr(t_host, sel)(*args)
    _same(cf, getattr(j_host, sel)(*args))
    assert cf.sum() > 0


INTERPS = ["direct_interpolation", "standard_interpolation",
           "multipass_interpolation"]


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("pi", PIS)
def test_interpolators_and_truncation_bitwise(pi, interp):
    A = PROBLEMS[pi]
    S = j_host.strength_ahat(A, 0.25, 1.1)
    cf = j_host.pmis_select(S)
    Pt = getattr(t_host, interp)(A, S, cf)
    Pj = getattr(j_host, interp)(A, S, cf)
    _same(Pt, Pj)
    for trunc, max_el in ((0.3, -1), (1.1, 2), (0.5, 3)):
        _same(t_host.truncate_interp(Pt, trunc, max_el),
              j_host.truncate_interp(Pj, trunc, max_el))


LEVEL_CFGS = {
    "default": "",
    "D2 aggressive max4": ', "interpolator": "D2", "aggressive_levels": 1,'
                          ' "interp_max_elements": 4',
    "MULTIPASS": ', "interpolator": "MULTIPASS"',
    "HMIS ALL": ', "selector": "HMIS", "strength": "ALL"',
    "RS D2": ', "selector": "RS", "interpolator": "D2"',
    "structure reuse": ', "structure_reuse_levels": 1',
}


def _level_cfg(extra, algorithm="CLASSICAL"):
    return (
        '{"config_version": 2, "solver": {"scope": "main", '
        f'"solver": "AMG", "algorithm": "{algorithm}"{extra}}}}}'
    )


@pytest.mark.parametrize("case", list(LEVEL_CFGS))
@pytest.mark.parametrize("pi", PIS)
def test_build_classical_level_bitwise(pi, case):
    A = PROBLEMS[pi]
    text = _level_cfg(LEVEL_CFGS[case])
    got = t_host.build_classical_level(A, T.AMGConfig.from_string(text),
                                       "main", 0)
    ref = j_host.build_classical_level(A, JConfig.from_string(text),
                                       "main", 0)
    for a, b in zip(got, ref):
        _same(a, b)


@pytest.mark.parametrize("case", list(LEVEL_CFGS))
@pytest.mark.parametrize("pi", PIS)
def test_reference_forms_bitwise(monkeypatch, pi, case):
    """``AMGX_TPU_TORCH_SETUP_FASTPATH=0`` (the ``ufunc.at`` reference
    forms) gives the JAX package's fast-path level bit for bit; the JAX
    package's own switch leaves the port on its fast path."""
    from amgx_tpu_torch.core.profiling import setup_fastpath_enabled

    monkeypatch.setenv("AMGX_TPU_SETUP_FASTPATH", "0")
    assert setup_fastpath_enabled()
    monkeypatch.delenv("AMGX_TPU_SETUP_FASTPATH")
    A = PROBLEMS[pi]
    text = _level_cfg(LEVEL_CFGS[case])
    ref = j_host.build_classical_level(A, JConfig.from_string(text),
                                       "main", 0)
    monkeypatch.setenv("AMGX_TPU_TORCH_SETUP_FASTPATH", "0")
    assert not setup_fastpath_enabled()
    got = t_host.build_classical_level(A, T.AMGConfig.from_string(text),
                                       "main", 0)
    for a, b in zip(got, ref):
        _same(a, b)


@pytest.mark.parametrize("selector", ["", ', "selector": "PMIS"'])
@pytest.mark.parametrize("pi", PIS)
def test_energymin_level_bitwise(pi, selector):
    A = PROBLEMS[pi]
    text = _level_cfg(selector, "ENERGYMIN")
    got = t_em.build_energymin_level(A, T.AMGConfig.from_string(text),
                                     "main")
    ref = j_em.build_energymin_level(A, JConfig.from_string(text), "main")
    for a, b in zip(got, ref):
        _same(a, b)


def _cfg(extra=""):
    return PCG_CLASSICAL.replace(
        '"monitor_residual": 0,', f'"monitor_residual": 0{extra},', 1)


def _solve_both(cfg_text, n, dtype):
    b = poisson_rhs(n ** 3, dtype=dtype)
    js = j_create(JConfig.from_string(cfg_text), "default")
    js.setup(j_poisson(n, dtype=dtype))
    jr = js.solve(b)
    ts = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                         device="cpu")
    ts.setup(t_poisson(n, dtype=dtype, device="cpu"))
    return js, jr, ts, ts.solve(b)


def _levels(js, ts):
    jl = [(lv.n_rows, lv.nnz) for lv in js.precond.levels]
    tl = [(lv.n_rows, lv.nnz) for lv in ts.precond.levels]
    return jl, tl


@pytest.mark.parametrize("extra", [
    ', "setup_location": "HOST"',
    ', "algorithm": "ENERGYMIN"',
], ids=["PCG_CLASSICAL", "ENERGYMIN"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_matches_jax(dtype, extra):
    js, jr, ts, tr = _solve_both(_cfg(extra), 12, dtype)
    jl, tl = _levels(js, ts)
    assert tl == jl and len(tl) > 2
    assert tr.status == int(jr.status) == 0
    x, xj = tr.x.numpy(), np.asarray(jr.x)
    if dtype == np.float64:
        assert tr.iters == int(jr.iters)
        rtol = 1e-10
    else:
        assert abs(tr.iters - int(jr.iters)) <= 1
        rtol = 1e-4
    np.testing.assert_allclose(x, xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())


def test_classical_is_the_default_algorithm():
    """No ``algorithm`` key: the AMG solver runs classical coarsening,
    with the dense-LU trigger of 128 rows stopping it."""
    s = T.create_solver(T.AMGConfig.from_string(PCG_CLASSICAL), "default",
                        device="cpu")
    assert s.precond.algorithm == "CLASSICAL"
    s.setup(t_poisson(10, device="cpu"))
    lv = s.precond.levels
    assert lv[-1].n_rows <= 128 < lv[-2].n_rows
    assert s.precond.setup_stats["levels_built"] == len(lv) - 1
    assert set(s.precond.setup_profile) >= {"strength", "cf_split",
                                            "interp", "rap_execute"}
    assert s.solve(poisson_rhs(1000)).status == 0
