"""Float-float arithmetic and ITERATIVE_REFINEMENT of the PyTorch port
against the JAX package (CPU).

* ``two_sum`` and ``two_prod`` give the JAX package's pairs bit for bit
  (both error-free: the eager torch operations round each step as the
  JAX package's barriers pin them), and are exact against f64.
* ``ff_residual_dia`` (a DIA operator) and ``ff_residual`` (the
  dominant-term form of other formats) agree with the JAX package's
  within the ff error bound, a few 2^-48 of |b| + |A||x| a row, and
  resolve what an f32 residual cannot.
* ITERATIVE_REFINEMENT around PCG + aggregation AMG in f32 reaches a
  true relative residual below 2e-8 at 32^3 where plain f32 PCG stalls
  above it, with the JAX package's number of corrections; without an
  inner solver it raises, as the JAX package does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_3d_7pt as j_poisson
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.ops import ff as jff
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.ops import ff as tff

amgx_tpu.initialize()


def _pairs(seed=3, n=4000):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)).astype(
        np.float32)
    # the split's overflow guard; no subnormal (XLA on the CPU flushes
    # them to zero, torch keeps them)
    a[:3] = (3e37, -1e35, 1e-30)
    return a, b


@pytest.mark.parametrize("fn", ["two_sum", "two_prod"])
def test_eft_bitwise_equal_jax_and_exact(fn):
    a, b = _pairs()
    s_t, e_t = getattr(tff, fn)(torch.from_numpy(a), torch.from_numpy(b))
    s_j, e_j = getattr(jff, fn)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    got = s_t.numpy().astype(np.float64) + e_t.numpy().astype(np.float64)
    if fn == "two_sum":
        np.testing.assert_array_equal(got, a64 + b64)
    else:
        ok = np.abs(a64 * b64) < 1e30  # the product's error term in range
        np.testing.assert_allclose(got[ok], (a64 * b64)[ok], rtol=1e-14,
                                   atol=0)


def test_ff_add_and_helpers_equal_jax():
    a, b = _pairs(seed=4)
    c, d = _pairs(seed=5)
    x_t = tff.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    y_t = tff.two_sum(torch.from_numpy(c), torch.from_numpy(d))
    x_j = jff.two_sum(jnp.asarray(a), jnp.asarray(b))
    y_j = jff.two_sum(jnp.asarray(c), jnp.asarray(d))
    for t, j in ((tff.ff_add(x_t, y_t), jff.ff_add(x_j, y_j)),
                 (tff.ff_add_f(x_t, y_t[0]), jff.ff_add_f(x_j, y_j[0])),
                 (tff.ff_neg(x_t), jff.ff_neg(x_j)),
                 (tff.ff(x_t[0]), jff.ff(x_j[0]))):
        for u, v in zip(t, j):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v))
    np.testing.assert_array_equal(tff.ff_to_f(x_t).numpy(),
                                  np.asarray(jff.ff_to_f(x_j)))


def _system(n=16, fmt="dia"):
    A = j_poisson(n, dtype=np.float32)
    sp = A.to_scipy()
    rng = np.random.default_rng(0)
    x = rng.standard_normal(sp.shape[0]).astype(np.float32)
    b = (sp.astype(np.float64) @ x.astype(np.float64)).astype(np.float32)
    formats = ("dia",) if fmt == "dia" else ("ell",)
    At = TMatrix.from_scipy(sp, device="cpu", accel_formats=formats)
    Aj = JMatrix.from_scipy(sp, accel_formats=formats)
    return sp, At, Aj, x, b


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_ff_residual_matches_jax(fmt):
    sp, At, Aj, x, b = _system(fmt=fmt)
    assert At.has_dia == (fmt == "dia") and Aj.has_dia == At.has_dia
    rng = np.random.default_rng(1)
    xl = (x * 2.0 ** -30 * rng.standard_normal(x.shape[0])).astype(
        np.float32)
    r_t = tff.ff_residual(At, tff.ff(torch.from_numpy(b)),
                          (torch.from_numpy(x), torch.from_numpy(xl)))
    r_j = jff.ff_residual(Aj, jff.ff(jnp.asarray(b)),
                          (jnp.asarray(x), jnp.asarray(xl)))
    got = r_t[0].numpy().astype(np.float64) + r_t[1].numpy()
    ref = np.asarray(r_j[0], np.float64) + np.asarray(r_j[1], np.float64)
    sp64 = sp.astype(np.float64)
    x64 = x.astype(np.float64) + xl.astype(np.float64)
    scale = np.abs(b).astype(np.float64) + abs(sp64) @ np.abs(x64)
    bound = 8 * 2.0 ** -48 * scale
    if fmt == "dia":
        np.testing.assert_array_less(np.abs(got - ref), bound + 1e-300)
        exact = b.astype(np.float64) - sp64 @ x64
        np.testing.assert_array_less(np.abs(got - exact), bound + 1e-300)
    else:
        # dominant terms only, in both packages: the same operations
        np.testing.assert_array_equal(r_t[0].numpy(), np.asarray(r_j[0]))
        np.testing.assert_array_equal(r_t[1].numpy(), np.asarray(r_j[1]))


def test_ff_residual_dia_resolves_below_f32():
    """The ff residual of f32 data is exact to ~2^-48 where b - A x in
    f32 is off by ~2^-24 of its terms."""
    sp, At, _, x, b = _system()
    r_t = tff.ff_residual(At, tff.ff(torch.from_numpy(b)),
                          tff.ff(torch.from_numpy(x)))
    r64 = b.astype(np.float64) - sp.astype(np.float64) @ x.astype(
        np.float64)
    r_ff = r_t[0].numpy().astype(np.float64) + r_t[1].numpy()
    from amgx_tpu_torch.ops.spmv import spmv

    r_f32 = (torch.from_numpy(b) - spmv(At, torch.from_numpy(x))).numpy()
    err_ff = np.linalg.norm(r_ff - r64)
    err_f32 = np.linalg.norm(r_f32.astype(np.float64) - r64)
    assert err_ff < err_f32 / 50, (err_ff, err_f32)


INNER = (
    '"preconditioner": {"scope": "inner", "solver": "PCG",'
    ' "max_iters": 60, "tolerance": 1e-4, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8}, "max_iters": 1, "cycle": "V",'
    ' "min_coarse_rows": 64, "coarse_solver": "DENSE_LU_SOLVER"}}'
)
REFINE = ('{"config_version":2,"solver":{"scope":"main",'
          '"solver":"ITERATIVE_REFINEMENT","max_iters":12,'
          '"tolerance":1e-8,"monitor_residual":1,' + INNER + "}}")
PLAIN = (
    '{"config_version":2,"solver":{"scope":"main","solver":"PCG",'
    '"max_iters":100,"tolerance":1e-9,"monitor_residual":1,'
    '"convergence":"RELATIVE_INI",'
    '"preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8}, "max_iters": 1, "cycle": "V",'
    ' "min_coarse_rows": 64, "coarse_solver": "DENSE_LU_SOLVER"}}}'
)


def test_iterative_refinement_beats_f32_stagnation():
    n = 32
    A = j_poisson(n, dtype=np.float32)
    b = poisson_rhs(A.n_rows, dtype=np.float32)
    sp64 = A.to_scipy().astype(np.float64)
    b64 = b.astype(np.float64)
    At = TMatrix.from_scipy(A.to_scipy(), device="cpu")
    s = T.create_solver(T.AMGConfig.from_string(REFINE), "default",
                        device="cpu").setup(At)
    res = s.solve(b)
    assert res.x.dtype == torch.float64  # the pair summed on the host
    rel = np.linalg.norm(b64 - sp64 @ res.x.numpy()) / np.linalg.norm(b64)
    assert rel < 2e-8, rel
    assert res.status == 0 and res.iters <= 5
    js = j_create(JConfig.from_string(REFINE), "default")
    js.setup(A)
    jr = js.solve(b)
    assert abs(int(jr.iters) - res.iters) <= 1
    # plain f32 PCG on the same hierarchy settles above refinement's
    p = T.create_solver(T.AMGConfig.from_string(PLAIN), "default",
                        device="cpu").setup(At)
    pr = p.solve(b)
    prel = np.linalg.norm(b64 - sp64 @ pr.x.numpy().astype(np.float64)) \
        / np.linalg.norm(b64)
    assert prel > rel, (prel, rel)


def test_refinement_requires_inner_solver():
    cfg = T.AMGConfig.from_string(
        '{"config_version":2,"solver":{"scope":"main",'
        '"solver":"ITERATIVE_REFINEMENT"}}')
    with pytest.raises(ValueError, match="inner solver"):
        T.create_solver(cfg, "default", device="cpu")
    with pytest.raises(ValueError):
        j_create(JConfig.from_string(
            '{"config_version":2,"solver":{"scope":"main",'
            '"solver":"ITERATIVE_REFINEMENT"}}'), "default")
