"""Reduced-precision hierarchies of the PyTorch port against the JAX
package (CPU): ``hierarchy_dtype`` / ``level_dtype_policy``, the kernels'
plain versions in every dtype pair the cycle feeds them, and the
refinement guardrail.

* Per-level dtypes of A, P and R under FLOAT32 / BFLOAT16 x COARSE /
  ALL equal the JAX package's (its tests/test_precision.py), and every
  cast level's values (CSR, diagonal, DIA planes, ELL, dense) equal the
  JAX package's ``astype`` bit for bit: both round to nearest even.
* Each SpMV format's plain version (DIA, MATRIX_FREE, slot-major and
  sliced ELL, dense, CSR) against the JAX package's ``spmv`` on the
  same matrix and x, for (values, x) in (bf16, bf16), (bf16, f32),
  (f32, f64), (f32, f32), (f64, f64): the same output dtype (JAX's
  promotion); f32 results at rtol 2e-5 and f64 at 1e-12 of the row's
  |A||x|; bf16 results within 2 bf16 ulps of the row's |A||x| (both
  round every product and sum to bf16, in orders that may differ).
* The cycle and step output dtypes, the smoothers' and the coarse
  solver's state in the level dtype, a bf16 level's dense LU factored
  in f32, and a values-only resetup that keeps every level's dtype.
* Refinement around a bf16 hierarchy converges to a true residual below
  1e-8 with the JAX package's corrections (+-1); the precision
  guardrail trips and recovers on a full-precision twin, stays off when
  disarmed, and stays inert where nothing was cast.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu.ops.spmv import spmv as j_spmv
from amgx_tpu.solvers.registry import create_solver as j_create
from amgx_tpu.solvers.registry import make_nested as j_nested
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.ops.spmv import spmv as t_spmv

amgx_tpu.initialize()

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _poisson(shape=(24, 24), seed=0):
    sp = poisson_scipy(shape).tocsr()
    sp.sort_indices()
    rng = np.random.default_rng(seed)
    return sp, rng.standard_normal(sp.shape[0])


def _amg_cfg(coarse="DENSE_LU_SOLVER", extra_amg="", outer_tol=1e-10,
             smoother="OPT_POLYNOMIAL"):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "PCG", "max_iters": 200,'
        f' "tolerance": {outer_tol}, "monitor_residual": 1,'
        ' "convergence": "RELATIVE_INI",'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
        + extra_amg +
        f' "smoother": {{"scope": "sm", "solver": "{smoother}",'
        ' "chebyshev_polynomial_order": 2, "monitor_residual": 0},'
        ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
        ' "min_coarse_rows": 32, "max_levels": 10,'
        ' "structure_reuse_levels": -1,'
        f' "coarse_solver": "{coarse}", "cycle": "V",'
        ' "monitor_residual": 0}}}'
    )


def _refine_cfg(hier_dtype="FLOAT32", policy="ALL", coarse="INEXACT",
                extra_outer="", max_iters=60):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        f' "solver": "ITERATIVE_REFINEMENT", "max_iters": {max_iters},'
        ' "tolerance": 1e-8, "monitor_residual": 1,'
        f' "convergence": "RELATIVE_INI", {extra_outer}'
        ' "preconditioner": {"scope": "inner", "solver": "PCG",'
        ' "max_iters": 8, "monitor_residual": 0,'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
        f' "hierarchy_dtype": "{hier_dtype}",'
        f' "level_dtype_policy": "{policy}",'
        ' "smoother": {"scope": "sm", "solver": "OPT_POLYNOMIAL",'
        ' "chebyshev_polynomial_order": 2, "monitor_residual": 0},'
        ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
        ' "min_coarse_rows": 32, "max_levels": 10,'
        ' "structure_reuse_levels": -1,'
        f' "coarse_solver": "{coarse}", "cycle": "V",'
        ' "monitor_residual": 0}}}}'
    )


def _both(cfg_text, sp, dtype=np.float64):
    """The config set up on ``sp`` in both packages: (jax, torch)."""
    sp = sp.astype(dtype)
    js = j_nested(j_create(JConfig.from_string(cfg_text), "default"))
    js.setup(JMatrix.from_scipy(sp))
    ts = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(sp, device="cpu"))
    return js, ts


def _amg(s):
    inner = getattr(s, "inner", None)
    return inner.precond if inner is not None else s.precond


def _name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _host(t):
    """A tensor or JAX array on the host as f64 (bf16 exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().astype(np.float64) \
            if t.dtype == BF16 else t.detach().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(t).astype(jnp.float64))


POLICIES = [("FLOAT32", "COARSE"), ("F32", "ALL"), ("BFLOAT16", "COARSE"),
            ("BF16", "ALL")]


@pytest.mark.parametrize("hd,policy", POLICIES)
def test_level_dtypes_and_cast_values_match_jax(hd, policy):
    sp, _ = _poisson()
    # INEXACT: the JAX package's dense LU cannot densify a bf16 level
    # (scipy has no bf16; test_dense_lu_of_bf16_level_factors_in_f32)
    cfg = _amg_cfg("INEXACT", f' "hierarchy_dtype": "{hd}",'
                              f' "level_dtype_policy": "{policy}",')
    js, ts = _both(cfg, sp)
    jl, tl = _amg(js).levels, _amg(ts).levels
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        for name in ("A", "P", "R"):
            mj, mt = getattr(j, name), getattr(t, name)
            assert (mj is None) == (mt is None)
            if mt is None:
                continue
            assert _name(mt.dtype) == _name(mj.values.dtype), (name, t)
            # bit for bit JAX's astype (round to nearest even in both)
            for attr in ("values", "diag", "dia_vals", "dense"):
                a, b = getattr(mt, attr), getattr(mj, attr, None)
                if a is None:
                    continue
                np.testing.assert_array_equal(_host(a), _host(b))
            if mt.ell_vals is not None:
                np.testing.assert_array_equal(_host(mt.ell_vals).T,
                                              _host(mj.ell_vals))
    first = 0 if policy == "ALL" else 1
    want = BF16 if hd.startswith("BF") else torch.float32
    for t in tl[first:]:
        assert t.A.dtype == want
    assert tl[0].A.dtype == (want if policy == "ALL" else torch.float64)


def _sell_matrix(rng):
    m, k = 3000, 700
    lens = rng.integers(0, 12, m)
    lens[rng.random(m) < 0.2] = 0
    r = np.repeat(np.arange(m), lens)
    c = rng.integers(0, k, r.shape[0])
    sp = sps.csr_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                        shape=(m, k))
    sp.sum_duplicates()
    return sp


def _csr_matrix(rng):
    n = 600
    sp = sps.random(n, n, density=0.004, random_state=rng, format="csr")
    sp = (sp + sps.csr_matrix(
        (rng.standard_normal(150), (np.zeros(150, int),
                                    rng.choice(n, 150, replace=False))),
        shape=(n, n))).tocsr()  # one long row: past every ELL gate
    sp.sum_duplicates()
    return sp


def _format_case(fmt):
    rng = np.random.default_rng(7)
    if fmt in ("DIA", "MATRIX_FREE"):
        sp = poisson_scipy((12, 12, 12)).tocsr()
        formats = ("dia",) if fmt == "DIA" else ("matrix_free",)
    elif fmt == "ELL":
        agg = np.arange(24 ** 3) // 8
        n = agg.shape[0]
        sp = sps.csr_matrix((rng.standard_normal(n), (np.arange(n), agg)),
                            shape=(n, n // 8)).T.tocsr()
        formats = ("ell",)
    elif fmt == "SELL":
        sp, formats = _sell_matrix(rng), ("ell",)
    elif fmt == "dense":
        sp = sps.random(300, 300, density=0.05, random_state=rng,
                        format="csr")
        formats = ("dense",)
    else:
        sp, formats = _csr_matrix(rng), ()
    sp.sort_indices()
    return sp, formats


PAIRS = [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
         ("float32", "float64"), ("float32", "float32"),
         ("float64", "float64")]


@pytest.mark.parametrize("vals,xdt", PAIRS)
@pytest.mark.parametrize("fmt", ["DIA", "MATRIX_FREE", "ELL", "SELL",
                                 "dense", "CSR"])
def test_plain_spmv_every_dtype_pair_matches_jax(fmt, vals, xdt):
    sp, formats = _format_case(fmt)
    At = TMatrix.from_scipy(sp, device="cpu", accel_formats=formats)
    Aj = JMatrix.from_scipy(sp, accel_formats=formats)
    assert At.format == (fmt if fmt != "SELL" else "ELL")
    assert (At.sell is not None) == (fmt == "SELL")
    lanes = None if At.sell is None else At.sell.lanes
    At = At.astype(vals)
    if lanes is not None:
        # the bf16 sliced kernel takes one lane a row (ops/ell.py)
        assert lanes > 1
        assert At.sell.lanes == (1 if vals == "bfloat16" else lanes)
    Aj = Aj.astype(jnp.dtype(vals))
    rng = np.random.default_rng(11)
    x = rng.standard_normal(sp.shape[1])
    xt = torch.from_numpy(x).to(getattr(torch, xdt))
    xj = jnp.asarray(x).astype(jnp.dtype(xdt))
    np.testing.assert_array_equal(_host(xt), _host(xj))
    yt = t_spmv(At, xt)
    yj = j_spmv(Aj, xj)
    assert _name(yt.dtype) == _name(yj.dtype)
    assert _name(yt.dtype) == jnp.result_type(jnp.dtype(vals),
                                              jnp.dtype(xdt)).name
    # the row's |A||x| in f64 of the cast values
    absA = abs(sps.csr_matrix((_host(At.values), At.host_csr().indices,
                               At.host_csr().indptr), shape=sp.shape))
    scale = absA @ np.abs(_host(xt))
    d = np.abs(_host(yt) - _host(yj))
    if yt.dtype == BF16:
        ulp = np.exp2(np.floor(np.log2(np.maximum(scale, 1e-300))) - 7)
        assert np.all(d <= 2 * ulp), float(np.max(d / np.maximum(ulp, 1e-300)))
    else:
        rtol = 2e-5 if yt.dtype == torch.float32 else 1e-12
        assert np.all(d <= rtol * scale + 1e-300), float(np.max(d))


@pytest.mark.parametrize("smoother", ["OPT_POLYNOMIAL", "BLOCK_JACOBI",
                                      "CHEBYSHEV", "JACOBI_L1"])
@pytest.mark.parametrize("hd", ["F32", "BF16"])
def test_cycle_and_smoother_state_in_level_dtype(smoother, hd):
    sp, _ = _poisson((12, 12))
    cfg = _amg_cfg("INEXACT", f' "hierarchy_dtype": "{hd}",'
                              ' "level_dtype_policy": "ALL",',
                   smoother=smoother)
    ts = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(sp, device="cpu"))
    amg = ts.precond
    want = BF16 if hd == "BF16" else torch.float32

    def leaves(p):
        if isinstance(p, torch.Tensor):
            yield p
        elif isinstance(p, (tuple, list)):
            for q in p:
                yield from leaves(q)
        elif hasattr(p, "values") and hasattr(p, "diag"):
            yield p.values

    for lvl in amg.levels[:-1]:
        for t in leaves(lvl.smoother.apply_params()):
            if t.is_floating_point():
                assert t.dtype == want, (smoother, lvl.level_id, t.dtype)
    for t in leaves(amg.coarse_solver.apply_params()):
        if t.is_floating_point():
            assert t.dtype == want
    # the cycle works in the level dtype; the step answers in the caller's
    b = torch.from_numpy(np.ones(sp.shape[0]))
    x = amg.make_step()(amg.apply_params(), b, torch.zeros_like(b))
    assert x.dtype == torch.float64 and bool(torch.isfinite(x).all())
    xc = amg.make_cycle()(amg.apply_params(), b.to(want),
                          torch.zeros_like(b, dtype=want))
    assert xc.dtype == want


def test_dense_lu_of_bf16_level_factors_in_f32():
    """A bf16 coarsest level's DENSE_LU factors in f32 and corrects in
    f32.  The JAX package means to do the same (``dense_lu.py:67-71``)
    but its densify goes through scipy, which has no bf16, and raises;
    its reference here is therefore its DENSE_LU on the bf16 level's
    values read as f32, which is what the port factors."""
    from amgx_tpu.solvers.dense_lu import DenseLUSolver as JDenseLU

    sp, b = _poisson((12, 12))
    cfg = _amg_cfg(extra_amg=' "hierarchy_dtype": "BF16",'
                             ' "level_dtype_policy": "ALL",')
    ts = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(sp, device="cpu"))
    tc = _amg(ts).coarse_solver
    Ac = _amg(ts).levels[-1].A
    assert Ac.dtype == BF16
    jc = JDenseLU(JConfig.from_string(cfg), "default")
    jc.setup(JMatrix.from_scipy(Ac.host_csr()))
    _, lu, _ = tc.apply_params()
    _, jlu, _ = jc.apply_params()
    assert lu.dtype == torch.float32 and jlu.dtype == jnp.float32
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-5,
                               atol=1e-6)
    r = torch.from_numpy(np.linspace(-1, 1, lu.shape[0])).to(BF16)
    z = tc.make_apply()(tc.apply_params(), r)
    # the JAX package's triangular solve takes no bf16 right-hand side
    # beside f32 factors: its apply on r promoted to f32
    zj = jc.make_apply()(jc.apply_params(), jnp.asarray(r.float().numpy()))
    assert z.dtype == torch.float32 and zj.dtype == jnp.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-4,
                               atol=1e-5)
    res = ts.solve(b)
    assert res.status == 0


@pytest.mark.parametrize("policy", ["COARSE", "ALL"])
def test_resetup_keeps_level_dtypes(policy):
    sp, b = _poisson()
    cfg = _amg_cfg("INEXACT", ' "hierarchy_dtype": "BF16",'
                              f' "level_dtype_policy": "{policy}",')
    ts = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                         device="cpu")
    A0 = TMatrix.from_scipy(sp, device="cpu")
    ts.setup(A0)
    before = [(lv.A.dtype, None if lv.P is None else lv.P.dtype,
               None if lv.R is None else lv.R.dtype)
              for lv in ts.precond.levels]
    sp2 = sp.copy()
    sp2.data = sp2.data * 1.5
    A1 = A0.replace_values(torch.from_numpy(sp2.data))
    ts.resetup(A1)
    after = [(lv.A.dtype, None if lv.P is None else lv.P.dtype,
              None if lv.R is None else lv.R.dtype)
             for lv in ts.precond.levels]
    assert after == before
    assert ts.precond.setup_stats["coarsen_calls"] == 0
    r1 = ts.solve(b)
    fresh = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                            device="cpu")
    fresh.setup(TMatrix.from_scipy(sp2, device="cpu"))
    r2 = fresh.solve(b)
    assert r1.status == 0 and abs(r1.iters - r2.iters) <= 1


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bf16_refinement_converges_with_jax_corrections(dtype):
    sp, b = _poisson()
    cfg = _refine_cfg("BFLOAT16", "ALL", "INEXACT")
    js, ts = _both(cfg, sp, dtype)
    for lvl in _amg(ts).levels:
        assert lvl.A.dtype == BF16
    b = b.astype(dtype)
    jr = js.solve(b)
    tr = ts.solve(b)
    assert tr.status == 0 and int(jr.status) == 0
    assert abs(tr.iters - int(jr.iters)) <= 1
    assert ts.last_inner_iters == tr.iters * 8
    assert ts.precision_fallbacks == 0
    spd = sp.astype(np.float64)
    rel = np.linalg.norm(b - spd @ tr.x.numpy()) / np.linalg.norm(b)
    assert rel < 1e-8, rel


def test_precision_fallback_guardrail_trips_and_recovers():
    sp, b = _poisson()
    ts = T.create_solver(T.AMGConfig.from_string(_refine_cfg(
        "FLOAT32", "ALL", "INEXACT",
        extra_outer='"precision_fallback": 1, "refine_iteration_guard": 1,'
    )), "default", device="cpu")
    ts.setup(TMatrix.from_scipy(sp, device="cpu"))
    res = ts.solve(b)
    assert ts.precision_fallbacks == 1
    assert res.status == 0
    for lvl in ts._fallback_solver.inner.precond.levels:
        assert lvl.A.dtype == torch.float64
    rel = np.linalg.norm(b - sp @ res.x.numpy()) / np.linalg.norm(b)
    assert rel < 1e-8
    # the JAX package trips on the same solve
    js = j_nested(j_create(JConfig.from_string(_refine_cfg(
        "FLOAT32", "ALL", "INEXACT",
        extra_outer='"precision_fallback": 1, "refine_iteration_guard": 1,'
    )), "default"))
    js.setup(JMatrix.from_scipy(sp))
    js.solve(b)
    assert js.precision_fallbacks == 1


def test_precision_fallback_disarmed():
    sp, b = _poisson()
    ts = T.create_solver(T.AMGConfig.from_string(_refine_cfg(
        "FLOAT32", "ALL", "INEXACT",
        extra_outer='"precision_fallback": 0, "refine_iteration_guard": 1,'
    )), "default", device="cpu")
    ts.setup(TMatrix.from_scipy(sp, device="cpu"))
    ts.solve(b)
    assert ts.precision_fallbacks == 0 and ts._fallback_solver is None


@pytest.mark.parametrize("hd", ["SAME", "FLOAT64"])
def test_all_f64_refinement_never_falls_back(hd):
    """Nothing cast (SAME, or FLOAT64 on an f64 operator): the guardrail
    stays inert even on a solve that does not converge."""
    sp, b = _poisson((12, 12))
    cfg = T.AMGConfig.from_string(_refine_cfg(
        hd, "ALL", "DENSE_LU_SOLVER",
        extra_outer='"refine_iteration_guard": 1,', max_iters=1))
    cfg.set("tolerance", 1e-14, "main")
    ts = T.create_solver(cfg, "default", device="cpu")
    ts.setup(TMatrix.from_scipy(sp, device="cpu"))
    res = ts.solve(b)
    assert res.status != 0
    assert ts.precision_fallbacks == 0 and ts._fallback_solver is None


@pytest.mark.parametrize("grid", [(16, 16, 16), (17, 23, 31), (40, 30, 1)])
def test_bf16_matrix_free_spmv_bitwise_equals_dia(grid):
    """The bitwise contract of ``ops/stencil.py`` in bf16: both plain
    versions round each product and sum to bf16 in offsets order."""
    sp = poisson_scipy(grid[::-1]).tocsr()
    M = TMatrix.from_scipy(sp, accel_formats=("matrix_free",),
                           device="cpu").astype(BF16)
    D = TMatrix.from_scipy(sp, accel_formats=("dia",),
                           device="cpu").astype(BF16)
    assert (M.format, D.format) == ("MATRIX_FREE", "DIA")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        sp.shape[0])).to(BF16)
    y_mf, y_dia = t_spmv(M, x), t_spmv(D, x)
    assert y_mf.dtype == BF16 and torch.equal(y_mf, y_dia)


@pytest.mark.parametrize("name", ["hierarchy_dtype", "level_dtype_policy",
                                  "precision_fallback",
                                  "refine_iteration_guard"])
def test_precision_params_registered_as_in_jax(name):
    from amgx_tpu.config import params as jparams
    from amgx_tpu_torch.config import params as tparams

    t, j = tparams.get_description(name), jparams.get_description(name)
    assert (t.type, t.default, t.allowed) == (j.type, j.default, j.allowed)


def test_bf16_dot_norm_and_inverse_diagonal_dtypes_match_jax():
    """Dots and norms of bf16 vectors stay bf16, as in the JAX package,
    and the inverse diagonal of a bf16 level is its bf16 rounding of
    the reciprocal, bit for bit."""
    from amgx_tpu.core.types import NormType as JNorm
    from amgx_tpu.ops.blas import dot as j_dot
    from amgx_tpu.ops.diagonal import invert_diag as j_invert
    from amgx_tpu.ops.norms import norm as j_norm
    from amgx_tpu_torch.core.types import NormType as TNorm
    from amgx_tpu_torch.ops.blas import dot as t_dot
    from amgx_tpu_torch.ops.diagonal import invert_diag as t_invert
    from amgx_tpu_torch.ops.norms import norm as t_norm

    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(500), rng.standard_normal(500)
    ta, tb = (torch.from_numpy(v).to(BF16) for v in (a, b))
    ja, jb = (jnp.asarray(v).astype(jnp.bfloat16) for v in (a, b))
    assert _name(t_dot(ta, tb).dtype) == _name(j_dot(ja, jb).dtype)
    np.testing.assert_allclose(_host(t_dot(ta, tb)), _host(j_dot(ja, jb)),
                               rtol=2 ** -6)
    for nt in ("L1", "L2", "LMAX"):
        tn, jn = t_norm(ta, TNorm(nt)), j_norm(ja, JNorm(nt))
        assert _name(tn.dtype) == _name(jn.dtype) == "bfloat16"
        np.testing.assert_allclose(_host(tn), _host(jn), rtol=2 ** -6)
    sp, _ = _poisson((12, 12))
    sp = sp.tocsr()
    sp.setdiag(rng.uniform(1, 3, sp.shape[0]))
    ti = t_invert(TMatrix.from_scipy(sp, device="cpu").astype(BF16))
    ji = j_invert(JMatrix.from_scipy(sp).astype(jnp.bfloat16))
    assert ti.dtype == BF16 and _name(ji.dtype) == "bfloat16"
    np.testing.assert_array_equal(_host(ti), _host(ji))
