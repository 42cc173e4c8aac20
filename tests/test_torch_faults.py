"""Fault injection and solve retries of the PyTorch port
(``amgx_tpu_torch.core.faults``) against the JAX package's, on the CPU.

The scenarios of ``tests/test_robustness.py`` and ``tests/test_capi.py``
run through both packages on the same seeded inputs (a 12 x 12 Poisson
grid, f64), each package with its own budget armed the same way:
``smoother_nan`` with and without ``solve_retries``, ``dot_breakdown``
with a stagnation window, at budgets 1, 2 and -1, on stationary, Krylov
and AMG-preconditioned solvers; ``coarse_lu_zero_pivot`` under
REGULARIZE and RAISE; the retry build cached across solves;
``serve_compile`` into a quarantine; ``capi_internal`` to an RC;
determinism with everything disarmed; ``AMGX_TPU_FAULTS``.  Held equal:
status, iterations, ``fired`` and ``solve_retries_used``; x to rtol
1e-10 where a solve converges.  The port takes a fault's decision when
it builds a solve (the JAX package when it traces one), so these counts
pin that emulation: one decision a place, held for the build.
"""

import warnings

import numpy as np
import pytest
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core import faults as jfaults
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu_torch.core import faults as tfaults
from amgx_tpu_torch.core.errors import SingularDiagonalError
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix

amgx_tpu.initialize()

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _clean_faults():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    for f in (jfaults, tfaults):
        f.disarm()
        f.reset_counters()
    yield
    for f in (jfaults, tfaults):
        f.disarm()
        f.reset_counters()
    torch.set_num_threads(prev)


def _jacobi(retries, omega=0.9, iters=800, extra=""):
    return (
        '{"config_version": 2, "solver": {"scope": "m",'
        ' "solver": "BLOCK_JACOBI", "monitor_residual": 1,'
        ' "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
        f' "max_iters": {iters}, "relaxation_factor": {omega},'
        f' "solve_retries": {retries}{extra}}}}}'
    )


def _krylov(solver, retries=0, precond="jacobi", extra=""):
    prec = {
        "jacobi": (', "preconditioner": {"scope": "j", "solver":'
                   ' "BLOCK_JACOBI", "max_iters": 2,'
                   ' "monitor_residual": 0}'),
        "amg": (', "preconditioner": {"scope": "amg", "solver": "AMG",'
                ' "algorithm": "AGGREGATION", "selector": "SIZE_2",'
                ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
                ' "monitor_residual": 0},'
                ' "coarse_solver": "DENSE_LU_SOLVER",'
                ' "min_coarse_rows": 16, "max_iters": 1,'
                ' "monitor_residual": 0}'),
    }[precond]
    return (
        '{"config_version": 2, "solver": {"scope": "m",'
        f' "solver": "{solver}", "max_iters": 100, "tolerance": 1e-8,'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
        f' "stagnation_window": 5, "solve_retries": {retries}'
        f'{extra}{prec}}}}}'
    )


def _system(m=12, seed=0):
    sp = poisson_scipy((m, m)).tocsr()
    sp.sort_indices()
    b = np.random.default_rng(seed).standard_normal(sp.shape[0])
    return sp, b


def _run(pkg, cfg, site=None, times=1, sp=None, b=None, solves=1):
    """Set up in ``pkg``, arm ``site``, solve ``solves`` times; (the last
    result, the solver, fired)."""
    if sp is None:
        sp, b = _system()
    if pkg == "jax":
        s = j_create(JConfig.from_string(cfg), "default")
        s.setup(JMatrix.from_scipy(sp))
        f = jfaults
    else:
        s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                            device="cpu")
        s.setup(TMatrix.from_scipy(sp, device="cpu"))
        f = tfaults
    f.reset_counters()
    if site is not None:
        f.arm(site, times)
    for _ in range(solves):
        res = s.solve(b)
    f.disarm()
    return res, s, (f.fired(site) if site is not None else 0)


def _hold(cfg, site, times, solves=1):
    """Both packages: status, iterations, fired and retries used equal,
    x to RTOL where the solve converged."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr, js, jfired = _run("jax", cfg, site, times, solves=solves)
        tr, ts, tfired = _run("torch", cfg, site, times, solves=solves)
    got = (tr.status, tr.iters, tfired, ts.solve_retries_used)
    want = (int(jr.status), int(jr.iters), jfired, js.solve_retries_used)
    assert got == want
    if tr.status == 0:
        xj = np.asarray(jr.x)
        np.testing.assert_allclose(tr.x.numpy(), xj, rtol=RTOL,
                                   atol=RTOL * np.abs(xj).max())
    return tr, ts


@pytest.mark.parametrize("retries", [0, 1])
@pytest.mark.parametrize("times", [1, 2, -1])
def test_smoother_nan_jacobi(retries, times):
    """The residual-carrying monitored loop: one place, whose decision
    holds for every iteration of the build; a retry builds afresh."""
    tr, ts = _hold(_jacobi(retries), "smoother_nan", times)
    if retries and times == 1:
        assert tr.status == 0 and ts.solve_retries_used == 1


@pytest.mark.parametrize("retries", [0, 1])
@pytest.mark.parametrize("times", [1, 2, -1])
def test_smoother_nan_amg_pcg(retries, times):
    """PCG over an aggregation V-cycle: the smoother's places (each
    level's pre- and post-smoothing, in the initial residual's cycle
    and in the loop body's) fire in the JAX package's trace order."""
    _hold(_krylov("PCG", retries, "amg"), "smoother_nan", times)


@pytest.mark.parametrize("times", [1, 2, -1])
def test_dot_breakdown_stagnation(times):
    """test_robustness.py's PCG + Jacobi with a stagnation window:
    unlimited, the window reports DIVERGED with finite x."""
    tr, _ = _hold(_krylov("PCG"), "dot_breakdown", times)
    assert torch.isfinite(tr.x).all()
    if times == -1:
        assert tr.status == 2 and tr.iters <= 10


@pytest.mark.parametrize("times", [1, 2, -1])
def test_dot_breakdown_amg_with_retry(times):
    _hold(_krylov("PCG", 1, "amg"), "dot_breakdown", times)


@pytest.mark.parametrize("solver", ["CG", "PCGF", "PBICGSTAB"])
@pytest.mark.parametrize("times", [1, 2])
def test_dot_breakdown_krylov_family(solver, times):
    """``dot`` and ``fused_dots`` sites of the other Krylov solvers."""
    _hold(_krylov(solver), "dot_breakdown", times)


@pytest.mark.parametrize("times", [1, -1])
def test_dot_breakdown_sstep_gram_block(times):
    """The s-step solver's Gram block breaks down as a unit."""
    _hold(_krylov("SSTEP_PCG", extra=', "s_step": 2'), "dot_breakdown",
          times)


@pytest.mark.parametrize("times", [1, 2, -1])
def test_smoother_nan_fgmres_amg(times):
    """FGMRES over AMG: the restart and Arnoldi loops are one region
    each, as the JAX package's while_loops are."""
    _hold(_krylov("FGMRES", 0, "amg", extra=', "gmres_n_restart": 10'),
          "smoother_nan", times)


def test_coarse_lu_zero_pivot_regularize_and_raise():
    """REGULARIZE switches the coarse solve to the pseudoinverse and
    PCG converges as in the JAX package; RAISE raises at setup."""
    sp, b = _system(16)
    cfg = _krylov("PCG", 0, "amg")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jfaults.inject("coarse_lu_zero_pivot"):
            js = j_create(JConfig.from_string(cfg), "default")
            js.setup(JMatrix.from_scipy(sp))
        jr = js.solve(b)
        with tfaults.inject("coarse_lu_zero_pivot"):
            ts = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                                 device="cpu")
            ts.setup(TMatrix.from_scipy(sp, device="cpu"))
        tr = ts.solve(b)
    assert ts.precond.coarse_solver._pinv_mode
    assert (tr.status, tr.iters) == (int(jr.status), int(jr.iters)) \
        and tr.status == 0
    xj = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), xj, rtol=RTOL,
                               atol=RTOL * np.abs(xj).max())
    assert tfaults.fired("coarse_lu_zero_pivot") == 1
    raising = cfg.replace('"DENSE_LU_SOLVER",',
                          '"DENSE_LU_SOLVER", "dense_lu_zero_pivot":'
                          ' "RAISE",')
    ts2 = T.create_solver(T.AMGConfig.from_string(raising), "default",
                          device="cpu")
    with pytest.raises(SingularDiagonalError):
        with tfaults.inject("coarse_lu_zero_pivot"):
            ts2.setup(TMatrix.from_scipy(sp, device="cpu"))


def test_retry_build_cached_across_solves():
    """test_robustness.py's diverging Jacobi: the retry build is made
    once and cached under its ``("retry", attempt)`` slot; the main
    build is evicted by each retry; relaxation halves from the second
    attempt on, so attempt 2 converges where 1 diverged."""
    import scipy.sparse as sps

    sp = sps.csr_matrix(np.array([[1.0, 3.0], [3.0, 1.0]]))
    b = np.ones(2)
    cfg = _jacobi(1, omega=1.0, iters=40, extra=', "rel_div_tolerance": '
                  '10.0').replace('1e-6', '1e-10')
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr, js, _ = _run("jax", cfg, sp=sp, b=b)
        ts = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                             device="cpu")
        ts.setup(TMatrix.from_scipy(sp, device="cpu"))
        tr = ts.solve(b)
    assert (tr.status, tr.iters, ts.solve_retries_used) == (
        int(jr.status), int(jr.iters), js.solve_retries_used)
    assert ts.solve_retries_used == 1 and tr.status == 2
    assert "solve" not in ts._cache
    fn1 = ts._cache[("retry", 1)]
    tr2 = ts.solve(b)
    assert ts._cache[("retry", 1)] is fn1
    assert (tr2.status, tr2.iters) == (tr.status, tr.iters)
    # two attempts: the second halves the relaxation factor
    cfg2 = cfg.replace('"solve_retries": 1', '"solve_retries": 2')
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr2, js2, _ = _run("jax", cfg2, sp=sp, b=b)
        tr3, ts3, _ = _run("torch", cfg2, sp=sp, b=b)
    assert (tr3.status, tr3.iters, ts3.solve_retries_used) == (
        int(jr2.status), int(jr2.iters), js2.solve_retries_used)
    assert ts3.relaxation_factor == 1.0
    assert set(k for k in ts3._cache if k[0] == "retry") == {
        ("retry", 1), ("retry", 2)}


def test_spent_budget_leaves_the_build_corrupt_until_a_rebuild():
    """The decision holds for the build: the same solver solves again
    with the fault spent and stays FAILED (its build is the corrupted
    one), in both packages; a new setup rebuilds and converges."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr, js, jf = _run("jax", _jacobi(0), "smoother_nan", 1, solves=2)
        tr, ts, tf = _run("torch", _jacobi(0), "smoother_nan", 1,
                          solves=2)
    assert (tr.status, tr.iters, tf) == (int(jr.status), int(jr.iters),
                                         jf) == (1, 1, 1)
    ts.setup(ts.A)
    assert ts.solve(_system()[1]).status == 0


@pytest.mark.parametrize("retries", [1, 2])
def test_solve_retries_config_solves_cleanly(retries):
    """``solve_retries`` sets up and solves (it raised before it was
    ported): a healthy solve uses no retry and builds none."""
    tr, ts = _hold(_krylov("PCG", retries), None, 1)
    assert tr.status == 0 and ts.solve_retries_used == 0
    assert not any(isinstance(k, tuple) for k in ts._cache)


def test_serve_compile_quarantines_the_group():
    """test_robustness.py's serve_compile: the group quarantines, every
    request solves alone to its sequential answer, in both packages."""
    from amgx_tpu.serve import BatchedSolveService as JService
    from amgx_tpu_torch.serve import BatchedSolveService as TService

    sp, _ = _system(8)
    rng = np.random.default_rng(2)
    bs = [rng.standard_normal(sp.shape[0]) for _ in range(2)]
    out = {}
    for name, svc, f in (("jax", JService(max_batch=2), jfaults),
                         ("torch", TService(max_batch=2, device="cpu"),
                          tfaults)):
        with f.inject("serve_compile", times=1):
            ts = [svc.submit(sp, b) for b in bs]
            svc.flush()
        res = [t.result() for t in ts]
        out[name] = (res, svc.metrics.get("quarantines"),
                     svc.metrics.get("quarantined_solves"),
                     f.fired("serve_compile"))
    (jres, *jcounts), (tres, *tcounts) = out["jax"], out["torch"]
    assert tcounts == jcounts == [1, 2, 1]
    for j, t in zip(jres, tres):
        assert (t.status, t.iters) == (int(j.status), int(j.iters))
        xj = np.asarray(j.x)
        np.testing.assert_allclose(t.x.numpy(), xj, rtol=RTOL,
                                   atol=RTOL * np.abs(xj).max())


def test_smoother_nan_in_a_served_batch():
    """A batched build under smoother_nan: the fault reaches every
    instance (the JAX package vmaps the instance iteration), with the
    JAX package's statuses and iterations."""
    from amgx_tpu.serve import BatchedSolveService as JService
    from amgx_tpu_torch.serve import BatchedSolveService as TService

    cfg = _krylov("PCG", 0, "amg")
    sp, _ = _system(8)
    rng = np.random.default_rng(4)
    bs = [rng.standard_normal(sp.shape[0]) for _ in range(3)]
    got = {}
    for name, svc, f in (
            ("jax", JService(config=cfg, max_batch=4), jfaults),
            ("torch", TService(config=cfg, max_batch=4, device="cpu"),
             tfaults)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with f.inject("smoother_nan", times=1):
                ts = [svc.submit(sp, b) for b in bs]
                svc.flush()
                res = [t.result() for t in ts]
        got[name] = ([(int(r.status), int(r.iters)) for r in res],
                     f.fired("smoother_nan"))
    assert got["torch"] == got["jax"]


def test_capi_internal_is_an_rc_and_the_handle_survives():
    """capi_internal inside AMGX_solver_solve comes back as the JAX
    package's RC (the catch-all maps the RuntimeError to RC_UNKNOWN);
    the next solve gives RC 0 and x bit for bit a clean solve's."""
    from amgx_tpu.api import capi as J
    from amgx_tpu_torch.api import capi as C

    sp, b = _system(8)
    n = sp.shape[0]
    cfg_text = _krylov("PCG")
    rcs, xs = {}, {}
    for name, api, f in (("jax", J, jfaults), ("torch", C, tfaults)):
        api.initialize()
        try:
            cfg = api.config_create(cfg_text)
            res = api.resources_create_simple(cfg)
            A = api.matrix_create(res, "hDDI")
            api.matrix_upload_all(A, n, sp.nnz, 1, 1,
                                  sp.indptr.astype(np.int32),
                                  sp.indices.astype(np.int32), sp.data)
            vb, vx = api.vector_create(res, "hDDI"), api.vector_create(
                res, "hDDI")
            api.vector_upload(vb, n, 1, b)
            api.vector_set_zero(vx, n, 1)
            slv = api.solver_create(res, "hDDI", cfg)
            api.solver_setup(slv, A)
            with f.inject("capi_internal"):
                with pytest.raises(api.AMGXError) as e:
                    api.solver_solve(slv, vb, vx)
            rcs[name] = (e.value.rc, f.fired("capi_internal"))
            assert api.solver_solve(slv, vb, vx) == api.RC_OK
            assert api.solver_get_status(slv) == api.SOLVE_SUCCESS
            xs[name] = np.asarray(api.vector_download(vx))
        finally:
            api.finalize()
    assert rcs["torch"] == rcs["jax"] == (C.RC_UNKNOWN, 1)
    np.testing.assert_allclose(xs["torch"], xs["jax"], rtol=RTOL,
                               atol=RTOL * np.abs(xs["jax"]).max())
    # the recovered handle solves as a clean direct solve, bit for bit
    clean, _, _ = _run("torch", cfg_text, sp=sp, b=b)
    np.testing.assert_array_equal(xs["torch"], clean.x.numpy())


def test_disarmed_determinism_bit_for_bit():
    """With every site disarmed, two fresh solves are bit for bit (the
    decisions leave no residue), and equal a solve made before any site
    was ever armed in this test."""
    cfg = _krylov("PCG", 1, "amg")
    first, _, _ = _run("torch", cfg)
    _run("torch", cfg, "smoother_nan", -1)
    _run("torch", cfg, "dot_breakdown", 2)
    xs = [_run("torch", cfg)[0].x.numpy() for _ in range(2)]
    np.testing.assert_array_equal(xs[0], xs[1])
    np.testing.assert_array_equal(xs[0], first.x.numpy())


def test_environment_arms_the_port_with_its_own_budget(monkeypatch):
    """``AMGX_TPU_FAULTS`` arms both packages, each with its own budget:
    one armed fire in each."""
    monkeypatch.setenv("AMGX_TPU_FAULTS", "smoother_nan")
    for f in (jfaults, tfaults):
        monkeypatch.setattr(f, "_armed", {})
        monkeypatch.setattr(f, "_env_loaded", [False])
        f.reset_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = j_create(JConfig.from_string(_jacobi(0)), "default")
        sp, b = _system()
        js.setup(JMatrix.from_scipy(sp))
        jr = js.solve(b)
        ts = T.create_solver(T.AMGConfig.from_string(_jacobi(0)),
                             "default", device="cpu")
        ts.setup(TMatrix.from_scipy(sp, device="cpu"))
        tr = ts.solve(b)
    assert (tr.status, tfaults.fired("smoother_nan")) == (
        int(jr.status), jfaults.fired("smoother_nan")) == (1, 1)
    assert not tfaults.armed("smoother_nan")


def test_unknown_site_in_the_environment_warns(monkeypatch):
    monkeypatch.setenv("AMGX_TPU_FAULTS", "smother_nan,dot_breakdown:2")
    monkeypatch.setattr(tfaults, "_armed", {})
    monkeypatch.setattr(tfaults, "_env_loaded", [False])
    with pytest.warns(UserWarning, match="unknown fault site 'smother_nan'"):
        assert tfaults.armed("dot_breakdown")
    assert not tfaults.armed("smoother_nan")
    with pytest.raises(ValueError, match="unknown fault site"):
        tfaults.arm("smother_nan")


_SERVE_SITES = ("gateway_shed", "admission_quota", "drain_timeout",
                "device_lost_dispatch", "device_lost_fetch", "fetch_hang")


def _serve_site_outcome(pkg, site):
    """Arm ``site`` once in ``pkg`` ("jax" or "torch") and drive the
    path that meets it on two Poisson 8 x 8 systems: (what the path
    gave, the site's fires, the service's counters)."""
    if pkg == "jax":
        from amgx_tpu.core import errors
        from amgx_tpu.core import faults
        from amgx_tpu.serve import BatchedSolveService, SolveGateway

        kw = {}
    else:
        from amgx_tpu_torch.core import errors
        from amgx_tpu_torch.core import faults
        from amgx_tpu_torch.serve import BatchedSolveService, SolveGateway

        kw = {"device": "cpu"}
    sp = poisson_scipy((8, 8)).tocsr()
    sp.sort_indices()
    rng = np.random.default_rng(3)
    bs = [rng.standard_normal(sp.shape[0]) for _ in range(2)]
    svc = BatchedSolveService(max_batch=2, fetch_watchdog_s=0.5, **kw)
    gw = SolveGateway(svc)
    with faults.inject(site, 1):
        if site in ("gateway_shed", "admission_quota"):
            try:
                gw.submit(sp, bs[0])
                got = "admitted"
            except errors.AdmissionRejected as e:
                got = (type(e).__name__, e.reason, e.retry_after_s)
        elif site == "drain_timeout":
            ts = [gw.submit(sp, b) for b in bs]
            got = gw.drain(timeout_s=30.0)
            got = (got["settled"], got["timed_out"],
                   [type(_outcome(t)).__name__ for t in ts])
        else:
            ts = [svc.submit(sp, b) for b in bs]
            svc.flush()
            got = [int(t.result().status) for t in ts]
        fired = faults.fired(site)
    keys = ("gateway_sheds", "shed_overloaded", "shed_quota",
            "resilience_failovers", "resilience_watchdog_fires",
            "quarantines", "batches", "failed_groups")
    return got, fired, {k: svc.metrics.get(k) for k in keys}


def _outcome(ticket):
    try:
        return ticket.result()
    except Exception as e:  # noqa: BLE001 — the typed outcome
        return e


@pytest.mark.parametrize("site", _SERVE_SITES)
def test_sites_and_sites_without_a_call_site(site, monkeypatch):
    """The twelve sites of the JAX package; the six of the serving tier
    (the gateway, admission, the drain, device-loss failover and the
    fetch watchdog) each fire once on their own path, with the JAX
    package's outcome and counters."""
    assert tfaults.SITES == jfaults.SITES and len(tfaults.SITES) == 12
    assert set(_SERVE_SITES) <= set(tfaults.SITES)
    monkeypatch.setenv("AMGX_TPU_FAULT_HANG_S", "1.5")
    assert tfaults.hang_seconds() == jfaults.hang_seconds() == 1.5
    jgot, jfired, jm = _serve_site_outcome("jax", site)
    tgot, tfired, tm = _serve_site_outcome("torch", site)
    assert tfired == jfired == 1
    assert tgot == jgot
    assert tm == jm
    assert not tfaults.armed(site)


def test_decisions_hold_for_a_build_and_loops_share_their_places():
    """The mechanism itself: a built function decides each place once,
    a loop body's places are the same every iteration, a rebuild
    decides afresh, and outside a build every call consults the
    budget."""
    seen = []

    def body():
        seen.append(tfaults.decide("dot_breakdown"))
        region = tfaults.loop()
        for _ in range(3):
            with region:
                seen.append(tfaults.decide("dot_breakdown"))
        return seen

    tfaults.arm("dot_breakdown", 2)
    fn = tfaults.built(body)
    fn()
    assert seen == [True, True, True, True]
    fn()
    assert seen[4:] == [True, True, True, True]
    assert tfaults.fired("dot_breakdown") == 2
    seen.clear()
    tfaults.built(body)()
    assert seen == [False] * 4
    tfaults.arm("dot_breakdown", 2)
    assert [tfaults.decide("dot_breakdown") for _ in range(3)] == [
        True, True, False]
    x = torch.ones((2, 3), dtype=torch.float64)
    tfaults.arm("smoother_nan", 1)
    y = tfaults.corrupt_nan("smoother_nan", x)
    assert torch.isnan(y[:, 0]).all() and not torch.isnan(x).any()
    assert tfaults.corrupt_nan("smoother_nan", x) is x
