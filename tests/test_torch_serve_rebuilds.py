"""The batch rebuilds of JACOBI_L1, POLYNOMIAL, KPZ_POLYNOMIAL,
CHEBYSHEV (OPT_POLYNOMIAL), INEXACT, s-step PCG and
ITERATIVE_REFINEMENT (``make_batch_params`` and the batched iterations
they feed) against the JAX package's on the CPU: both services solve the
same jittered families, and the port must batch where the JAX package
batches, with its counters, statuses and iterations.

Tolerances (ROADMAP.md's parity rules): x to rtol 1e-10 of its largest
entry in f64 and 1e-4 in f32, iterations equal in f64 and within one in
f32; s-step PCG at s = 4 to 1.1e-9 of max|x| (the JAX package's own
batched and sequential solves differ by up to 1.08e-9 there).  Batched
forms against the port's own unbatched forms (the float-float residual,
the rebuilt diagonals) are held bit for bit.
"""

import numpy as np
import pytest
import torch

import amgx_tpu
from amgx_tpu.serve import BatchedSolveService as JService
from amgx_tpu_torch.config.amg_config import AMGConfig
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.io.poisson import jittered_poisson_family
from amgx_tpu_torch.serve import (
    CHEAP_PRECONDITIONER_CONFIG,
    COMM_AVOIDING_CONFIG,
    BatchedSolveService,
    make_batched_solve,
)
from amgx_tpu_torch.solvers.registry import create_solver, make_nested

amgx_tpu.initialize()

COUNTERS = ("batches", "setups", "compiles", "fallback_solves",
            "quarantines", "failed_groups", "submitted", "solved")


def _main(solver, precond=None, **kw):
    """A monitored main solver (RELATIVE_INI 1e-8) over ``precond``."""
    d = {"scope": "main", "solver": solver, "max_iters": 100,
         "tolerance": 1e-8, "monitor_residual": 1,
         "convergence": "RELATIVE_INI", **kw}
    if precond is not None:
        d["preconditioner"] = precond
    return d


def _amg(smoother, selector="SIZE_8", cycle="V", coarse="DENSE_LU_SOLVER",
         **kw):
    return {"scope": "amg", "solver": "AMG", "algorithm": "AGGREGATION",
            "selector": selector, "smoother": smoother, "presweeps": 1,
            "postsweeps": 1, "max_iters": 1, "min_coarse_rows": 8,
            "max_levels": 10, "structure_reuse_levels": -1,
            "coarse_solver": coarse, "cycle": cycle, "monitor_residual": 0,
            **kw}


def _cfg(main):
    import json

    return json.dumps({"config_version": 2, "solver": main})


SM = {"scope": "sm", "monitor_residual": 0}
CONFIGS = {
    # the re-anchor case of ROADMAP.md A.7.1, which the batch rebuilds
    # (make_batch_params, solvers/batched_loop.py) closed: two patterns,
    # two batches
    "jacobi_l1_w": _cfg(_main("PCG", _amg(
        {**SM, "solver": "JACOBI_L1"}, selector="SIZE_2", cycle="W"))),
    "polynomial": _cfg(_main("PCG", _amg(
        {**SM, "solver": "POLYNOMIAL", "kpz_order": 3}))),
    "kpz_polynomial": _cfg(_main("PCG", {
        "scope": "p", "solver": "KPZ_POLYNOMIAL", "kpz_order": 4,
        "kpz_mu": 8, "max_iters": 1, "monitor_residual": 0})),
    "chebyshev": _cfg(_main("PCG", _amg(
        {**SM, "solver": "CHEBYSHEV", "chebyshev_polynomial_order": 3}))),
    "chebyshev_nested": _cfg(_main("PCG", _amg(
        {**SM, "solver": "CHEBYSHEV", "chebyshev_polynomial_order": 2,
         "preconditioner": {"scope": "cp", "solver": "JACOBI_L1",
                            "monitor_residual": 0}}))),
    "opt_polynomial_inexact": _cfg(_main("PCG", _amg(
        {**SM, "solver": "OPT_POLYNOMIAL",
         "chebyshev_polynomial_order": 3},
        coarse="INEXACT", inexact_coarse_solver="OPT_POLYNOMIAL"))),
    # an s-step coarse solve short enough to stay clear of breakdown (a
    # Krylov block past the coarsest level's rank amplifies roundoff,
    # in either package, batched or not)
    "inexact_sstep": _cfg(_main("PCG", _amg(
        {**SM, "solver": "BLOCK_JACOBI"}, coarse="INEXACT",
        max_coarse_iters=4,
        inexact_coarse_solver={"scope": "cs", "solver": "SSTEP_PCG",
                               "s_step": 2, "monitor_residual": 0}))),
    "sstep_s4": _cfg(_main("SSTEP_PCG", {
        "scope": "j", "solver": "BLOCK_JACOBI", "relaxation_factor": 0.8,
        "max_iters": 1, "monitor_residual": 0}, s_step=4,
        max_iters=200)),
    "refinement_monitored": _cfg(_main("ITERATIVE_REFINEMENT", {
        "scope": "inner", "solver": "PCG", "max_iters": 30,
        "tolerance": 1e-3, "monitor_residual": 1,
        "convergence": "RELATIVE_INI",
        "preconditioner": _amg({**SM, "solver": "BLOCK_JACOBI"})},
        max_iters=20)),
    "comm_avoiding": COMM_AVOIDING_CONFIG,
    "cheap_preconditioner": CHEAP_PRECONDITIONER_CONFIG,
}
# s-step PCG's Gram systems amplify the last bits (module docstring)
SSTEP_RTOL = 1.1e-9
LOOSE = {"sstep_s4", "comm_avoiding", "inexact_sstep"}
GMRES_CFG = _cfg(_main("GMRES", None, gmres_n_restart=20))
IDR_CFG = _cfg(_main("IDR", None, subspace_dim_s=4))


def host_x(r):
    x = r.x
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def counters(svc):
    return {k: svc.metrics.get(k) for k in COUNTERS}


def family(dtype):
    """Two patterns: 6 systems of 12 x 11 and 3 of 9 x 8 (the PCG + AMG
    case of ROADMAP.md A.7.1, closed by the batch rebuilds), in
    ``dtype``."""
    out = (jittered_poisson_family((12, 11), 6, seed=1)
           + jittered_poisson_family((9, 8), 3, seed=2))
    return [(sp.astype(dtype), b.astype(dtype)) for sp, b in out]


def both(cfg, systems, **kw):
    ts = BatchedSolveService(config=cfg, device="cpu", **kw)
    js = JService(config=cfg, **kw)
    return ts.solve_many(systems), js.solve_many(systems), ts, js


def hold(tr, jr, rtol, iters_within=0):
    worst = 0.0
    for a, b in zip(tr, jr):
        assert int(a.status) == int(b.status)
        assert abs(int(a.iters) - int(b.iters)) <= iters_within
        xb = host_x(b).astype(np.float64)
        worst = max(worst, float(np.abs(host_x(a) - xb).max()
                                 / max(np.abs(xb).max(), 1e-300)))
    assert worst <= rtol, worst


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rebuild_batches_as_jax_f64(name):
    systems = family(np.float64)
    tr, jr, ts, js = both(CONFIGS[name], systems, max_batch=8)
    assert counters(ts) == counters(js)
    assert ts.metrics.get("fallback_solves") == 0
    assert ts.metrics.get("batches") == 2
    hold(tr, jr, SSTEP_RTOL if name in LOOSE else 1e-10)
    assert all(int(r.status) == 0 for r in tr)


@pytest.mark.parametrize("name", ["jacobi_l1_w", "kpz_polynomial",
                                  "chebyshev_nested", "sstep_s4",
                                  "comm_avoiding"])
def test_rebuild_batches_as_jax_f32(name):
    cfg = CONFIGS[name].replace('"tolerance": 1e-08', '"tolerance": 1e-05')
    systems = family(np.float32)
    tr, jr, ts, js = both(cfg, systems, max_batch=8)
    assert counters(ts) == counters(js)
    assert ts.metrics.get("batches") == 2
    hold(tr, jr, 1e-4, iters_within=1)


def test_cheap_preconditioner_is_one_batch_as_jax():
    """The re-anchor case of ROADMAP.md A.7.1 (closed by the batch
    rebuilds): CHEAP_PRECONDITIONER_CONFIG on 6 jittered 20 x 18
    systems is one batch (6 ``fallback_solves`` before the rebuilds),
    with the JAX package's corrections."""
    systems = jittered_poisson_family((20, 18), 6, seed=0)
    tr, jr, ts, js = both(CHEAP_PRECONDITIONER_CONFIG, systems,
                          max_batch=8)
    assert counters(ts) == counters(js)
    assert ts.metrics.get("batches") == 1
    assert ts.metrics.get("fallback_solves") == 0
    hold(tr, jr, 1e-10)
    for (sp, b), r in zip(systems, tr):
        assert (np.linalg.norm(b - sp @ host_x(r))
                <= 1e-8 * np.linalg.norm(b))


def test_rebuilds_match_sequential_port_solves():
    """Each batched instance against the port's own sequential solve of
    its system (one set-up solver, values-only resetups): the same
    statuses and iterations, x to rtol 1e-10 (s-step 1.1e-9).  256 rows
    fill their bucket: padded identity rows would change a polynomial
    smoother's power-iteration window and the padded template's
    coarse levels, and with them the last digits."""
    systems = jittered_poisson_family((16, 16), 4, seed=5)
    for name in ("jacobi_l1_w", "kpz_polynomial", "opt_polynomial_inexact",
                 "sstep_s4", "cheap_preconditioner"):
        cfg = CONFIGS[name]
        res = BatchedSolveService(config=cfg, device="cpu",
                                  max_batch=4).solve_many(systems)
        s = make_nested(create_solver(AMGConfig.from_string(cfg),
                                      "default", device="cpu"))
        s.setup(SparseMatrix.from_scipy(systems[0][0], device="cpu"))
        for (sp, b), r in zip(systems, res):
            s.resetup(SparseMatrix.from_scipy(sp, device="cpu"))
            ref = s.solve(b)
            assert int(r.iters) == int(ref.iters), name
            xr = host_x(ref)
            err = np.abs(host_x(r) - xr).max() / np.abs(xr).max()
            assert err <= (SSTEP_RTOL if name in LOOSE else 1e-10), name


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["gmres", "idr"])
def test_make_batched_solve_none_only_for_gmres_and_idr(name):
    cfg = {"gmres": GMRES_CFG, "idr": IDR_CFG}.get(name) or CONFIGS[name]
    sp = jittered_poisson_family((9, 8), 1, seed=3)[0][0]
    s = make_nested(create_solver(AMGConfig.from_string(cfg), "default",
                                  device="cpu"))
    s.setup(SparseMatrix.from_scipy(sp, device="cpu"))
    assert (make_batched_solve(s) is None) == (name in ("gmres", "idr"))


# ---------------------------------------------------------------------
# batched forms against the port's own unbatched ones, bit for bit


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_ff_residual_batched_bitwise_per_instance(fmt):
    from amgx_tpu_torch.ops import ff as ffm

    sp = jittered_poisson_family((9, 7), 1, seed=4)[0][0]
    A = SparseMatrix.from_scipy(sp, accel_formats=(fmt,), device="cpu")
    assert A.format == fmt.upper()
    rng = np.random.default_rng(6)
    B = 3
    V = torch.from_numpy(sp.data[None, :]
                         * (1.0 + 0.05 * rng.standard_normal((B, sp.nnz))))
    Ab = A.replace_values_batched(V)
    xh = torch.from_numpy(rng.standard_normal((B, A.n_rows)))
    xl = xh * 1e-17
    b = torch.from_numpy(rng.standard_normal((B, A.n_rows)))
    for Am in (Ab, A):  # batched planes, and planes shared by the batch
        rh, rl = ffm.ff_residual(Am, ffm.ff(b), (xh, xl))
        for i in range(B):
            Ai = A.replace_values(V[i]) if Am is Ab else A
            h, lo = ffm.ff_residual(Ai, ffm.ff(b[i]), (xh[i], xl[i]))
            assert torch.equal(rh[i], h) and torch.equal(rl[i], lo)


@pytest.mark.parametrize("name", ["jacobi_l1", "polynomial",
                                  "kpz_polynomial", "chebyshev"])
def test_diagonal_rebuilds_bitwise_per_instance(name):
    """The rebuilt params of each instance equal those of a setup on its
    own values: the inverted (L1) diagonals bit for bit, the KPZ window
    to rtol 1e-15."""
    solver = {"jacobi_l1": "JACOBI_L1", "polynomial": "POLYNOMIAL",
              "kpz_polynomial": "KPZ_POLYNOMIAL",
              "chebyshev": "CHEBYSHEV"}[name]
    cfg = _cfg({"scope": "main", "solver": solver, "max_iters": 2,
                "monitor_residual": 0})
    systems = jittered_poisson_family((8, 7), 3, seed=8)
    V = torch.from_numpy(np.stack([sp.data for sp, _ in systems]))

    def setup(sp):
        s = create_solver(AMGConfig.from_string(cfg), "default",
                          device="cpu")
        return s.setup(SparseMatrix.from_scipy(sp, device="cpu"))

    s0 = setup(systems[0][0])
    tmpl, fn = s0.make_batch_params()
    Ab, Mp = fn(tmpl, V)
    for i, (sp, _) in enumerate(systems):
        ref = setup(sp).apply_params()[1]
        if name == "kpz_polynomial":
            for c, r in zip(Mp, ref):
                np.testing.assert_allclose(float(c[i, 0]), float(r),
                                           rtol=1e-15)
        else:
            assert torch.equal(Mp[i], ref)


@pytest.mark.parametrize("cfg", ["comm_avoiding", "cheap_preconditioner"])
def test_chip_smoke_rebuild_walks_count_every_batched_spmv(monkeypatch, cfg):
    """``chip_smoke.comm_walk`` / ``cheap_walk`` (the launches the card
    run holds its serve groups j and k to) against every batched SpMV
    the group makes, entry point by entry point: at 32^3 the SIZE_8
    transfers are slot-major ELL (``ell_spmv_batched``), and the cheap
    config's cycle runs on its f32 levels beside PCG's f64 operator."""
    import chip_smoke
    from amgx_tpu_torch.ops import kernels
    from amgx_tpu_torch.ops import spmv as spmv_mod

    seen = {}
    real = spmv_mod._spmv_batched

    def record(A, x):
        c = chip_smoke.BATCHED.get(chip_smoke.counter_of(A))
        if c is not None:
            name = c if c == "csr" else kernels.entry_point(c, A.dtype,
                                                            x.dtype)
            seen[name] = seen.get(name, 0) + 1
        return real(A, x)

    monkeypatch.setattr(spmv_mod, "_spmv_batched", record)
    systems = chip_smoke.serve_family((32, 32, 32), 2, seed=1)
    svc = BatchedSolveService(config=CONFIGS[cfg], max_batch=2,
                              device="cpu")
    res = svc.solve_many(systems)
    assert svc.metrics.get("batches") == 1
    it = max(int(r.iters) for r in res)
    s = next(iter(svc.cache._entries.values())).solver
    if cfg == "comm_avoiding":
        want = chip_smoke.comm_walk(s, it)
        assert set(want) == {"dia_spmv_batched_f64", "ell_spmv_batched_f64"}
    else:
        want = chip_smoke.cheap_walk(s, it)
        assert set(want) == {"dia_spmv_batched_f64", "dia_spmv_batched_f32",
                             "ell_spmv_batched_f32"}
    assert seen == want


def test_batched_refinement_keeps_a_non_success_status_as_jax():
    """A batched CHEAP_PRECONDITIONER_CONFIG instance that ends
    NOT_CONVERGED keeps its status: the JAX service's batched path runs
    no precision fallback, and neither does the port's (no quarantine,
    no re-solve)."""
    cfg = CHEAP_PRECONDITIONER_CONFIG.replace(
        '"max_iters": 40', '"max_iters": 1').replace(
        '"tolerance": 1e-8', '"tolerance": 1e-14')
    assert cfg != CHEAP_PRECONDITIONER_CONFIG
    systems = jittered_poisson_family((16, 16), 4, seed=7)
    tr, jr, ts, js = both(cfg, systems, max_batch=4)
    assert counters(ts) == counters(js)
    assert ts.metrics.get("batches") == 1
    assert ts.metrics.get("quarantines") == 0
    assert all(int(r.status) != 0 for r in tr)
    hold(tr, jr, 1e-10)
