"""Streaming solve sessions (``amgx_tpu_torch.sessions``) against the
JAX package's (``amgx_tpu.sessions``) on the CPU: the flows of
``tests/test_sessions.py`` that need no warm boot, gateway or
telemetry, through both packages, with the same statuses, iterations and
x (rtol 1e-10 of its largest entry, f64; f32 iterations within one and x
to 1e-4); the values-only fast path (no CSR extraction and no pattern
hash after ``open``); lockstep groups; the documented differences (a
service that is not started: no overlap, iterations + 2 host syncs a
group); placement, tenants and a gateway front; the C API's session
round trip in an ``h`` mode.
The overlap of an asynchronous step and persistence are ``tests/test_torch_async.py`` and
``tests/test_torch_warmboot.py``."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
from amgx_tpu.serve import BatchedSolveService as JService
from amgx_tpu.sessions import SessionManager as JManager
from amgx_tpu_torch.config.amg_config import AMGConfig
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.io.poisson import poisson_scipy
from amgx_tpu_torch.serve import BatchedSolveService
from amgx_tpu_torch.sessions import SessionManager
from amgx_tpu_torch.solvers.registry import create_solver, make_nested

amgx_tpu.initialize()

# tests/test_sessions.py's time-stepping config: ABSOLUTE convergence
# (RELATIVE_INI would move the goalpost with the warm start)
STEP_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 300, "tolerance": 1e-6,'
    ' "monitor_residual": 1, "convergence": "ABSOLUTE",'
    ' "preconditioner": {"scope": "jac", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.9, "max_iters": 2,'
    ' "monitor_residual": 0}}}'
)
AMG_STEP_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "ABSOLUTE",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 16, "max_levels": 10,'
    ' "structure_reuse_levels": -1,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)
RTOL = 1e-10


def _heat_workload(nx=12, dt=2.0, seed=0):
    """tests/test_sessions.py's implicit-Euler heat sequence on an nx^2
    grid: (A0 csr, values(k), u0, f, n)."""
    base = poisson_scipy((nx, nx)).tocsr()
    base.sort_indices()
    n = base.shape[0]
    rid = np.repeat(np.arange(n), np.diff(base.indptr))
    dpos = np.flatnonzero(rid == base.indices)

    def values(k):
        v = dt * (1.0 + 0.02 * np.sin(0.4 * k)) * base.data.copy()
        v[dpos] += 1.0 + dt * 0.5
        return v

    A0 = sps.csr_matrix((values(0), base.indices, base.indptr),
                        shape=base.shape)
    A0.sort_indices()
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal(n)
    xx, yy = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, nx))
    f = (np.sin(np.pi * xx) * np.sin(np.pi * yy)).ravel()
    return A0, values, u0, f, n


def _rhs(u0, f, dt=2.0):
    return lambda sess: (
        (u0 if sess.last_x is None else sess.last_x) + dt * f)


def managers(cfg=STEP_CFG, **kw):
    """(port manager, JAX manager) over fresh services."""
    return (SessionManager(BatchedSolveService(config=cfg, max_batch=4,
                                               device="cpu"), **kw),
            JManager(JService(config=cfg, max_batch=4), **kw))


def same(tres, jres, rtol=RTOL):
    assert int(tres.status) == int(jres.status)
    assert int(tres.iters) == int(jres.iters)
    xj = np.asarray(jres.x)
    np.testing.assert_allclose(tres.x.cpu().numpy(), xj, rtol=0,
                               atol=rtol * np.abs(xj).max())


# ---------------------------------------------------------------------
# streaming correctness, through both packages


@pytest.mark.parametrize("cfg", ["jacobi", "amg"])
def test_session_stream_matches_reference(cfg):
    """A streamed sequence gives the JAX package's steps, and follows
    the port's own direct solves from the same x0 (warm starts change
    the iteration path, not the answer).  The AMG stream runs on 256
    rows, which fill their bucket: padded identity rows would give the
    service's hierarchy other aggregates than the direct solver's."""
    cfg, nx = {"jacobi": (STEP_CFG, 12), "amg": (AMG_STEP_CFG, 16)}[cfg]
    A0, values, u0, f, n = _heat_workload(nx)
    tm, jm = managers(cfg)
    ts, js = tm.open(A0, session_id="ref"), jm.open(A0, session_id="ref")
    solver = make_nested(create_solver(AMGConfig.from_string(cfg), "default",
                                       device="cpu"))
    for k in range(4):
        x_prev = ts.last_x
        tt = ts.step(values(k), _rhs(u0, f))
        jt = js.step(values(k), _rhs(u0, f))
        tm.flush()
        jm.flush()
        same(tt.result(), jt.result())
        A = SparseMatrix.from_scipy(sps.csr_matrix(
            (values(k), A0.indices, A0.indptr), shape=A0.shape),
            device="cpu")
        if k == 0:
            solver.setup(A)
        else:
            solver.resetup(A)
        b = (u0 if x_prev is None else x_prev) + 2.0 * f
        ref = solver.solve(b, x0=x_prev)
        assert int(ref.iters) == int(tt.result().iters)
        np.testing.assert_allclose(ts.last_x, ref.x.numpy(), rtol=0,
                                   atol=1e-9 * np.abs(ref.x.numpy()).max())
    assert ts.step_idx == js.step_idx == 4
    assert isinstance(ts.last_x, np.ndarray)


def test_warm_start_strictly_fewer_iterations():
    A0, values, u0, f, n = _heat_workload()

    def run(mgr, warm: bool):
        sess = mgr.open(A0, session_id="w")
        total, iters, x = 0, [], u0
        for k in range(6):
            b = x + 2.0 * f
            if warm:
                t = sess.step(values(k), b)
            else:
                sess.prestage(values(k), b)
                sess._last_status = None  # warm start suppressed
                t = sess.commit()
            mgr.flush()
            res = t.result()
            assert int(res.status) == 0
            iters.append(int(res.iters))
            x = np.asarray(sess.last_x)
        return iters

    got = {}
    for name, mk in (("t", lambda: managers()[0]),
                     ("j", lambda: managers()[1])):
        got[name] = (run(mk(), True), run(mk(), False))
    assert got["t"] == got["j"]
    warm, cold = got["t"]
    assert sum(warm) < sum(cold)


def test_diverged_step_not_reused_as_x0():
    cfg = STEP_CFG.replace('"max_iters": 300', '"max_iters": 1') \
                  .replace('"tolerance": 1e-6', '"tolerance": 1e-30')
    A0, values, u0, f, n = _heat_workload()
    tm, jm = managers(cfg)
    for mgr in (tm, jm):
        sess = mgr.open(A0, session_id="div")
        for k in range(3):
            t = sess.step(values(k), u0)
            mgr.flush()
            assert int(t.result().status) != 0
        assert sess.last_x is not None  # kept, just not reused
    snap = tm.counters()
    jsnap = jm.telemetry_snapshot()
    assert snap["cold_starts_total"] == jsnap["cold_starts_total"] == 3
    assert snap.get("warm_starts_total", 0) == 0
    assert jsnap.get("warm_starts_total", 0) == 0


def test_deferred_rhs_callable_sees_previous_x():
    A0, values, u0, f, n = _heat_workload()
    tm, _ = managers()
    sess = tm.open(A0, session_id="cb")
    seen = []

    def rhs(s):
        seen.append(None if s.last_x is None else np.array(s.last_x))
        return (u0 if s.last_x is None else s.last_x) + 2.0 * f

    for k in range(2):
        sess.prestage(values(k), rhs)
        t = sess.commit()
        tm.flush()
        if k == 0:
            x1 = t.result().x.numpy()
    t.result()
    assert seen[0] is None
    # the second step's rhs saw the first step's solution
    np.testing.assert_array_equal(seen[1], x1)


def test_failed_resolve_does_not_wedge_stream():
    A0, values, u0, f, n = _heat_workload()
    tm, _ = managers()
    sess = tm.open(A0, session_id="boom")
    sess.step(values(0), u0)
    tm.flush()

    class _Boom:
        def result(self):
            raise RuntimeError("boom")

        def done(self):
            return True

    sess._pending.ticket = _Boom()
    with pytest.raises(RuntimeError, match="boom"):
        sess.step(values(1), u0)
    # retry works, and the failed step's x is not the warm start
    t = sess.step(values(2), u0)
    tm.flush()
    assert int(t.result().status) == 0
    snap = tm.counters()
    assert snap["step_failures_total"] == 1
    assert snap["cold_starts_total"] >= 2


def test_step_all_unwinds_on_member_prestage_failure():
    A0, values, u0, f, n = _heat_workload()
    tm, jm = managers()
    for mgr in (tm, jm):
        sessions = [mgr.open(A0, session_id=f"u{i}") for i in range(3)]
        bad = [(s, values(0), u0) for s in sessions[:2]]
        bad.append((sessions[2], values(0)[:-5], u0))  # wrong nnz
        with pytest.raises(ValueError, match="coefficients"):
            mgr.step_all(bad)
        assert all(s._staged is None for s in sessions)
        tickets = mgr.step_all([(s, values(0), u0) for s in sessions])
        assert all(int(t.result().status) == 0 for t in tickets)


def test_prestage_twice_raises_and_step_recovers():
    A0, values, u0, f, n = _heat_workload()
    tm, _ = managers()
    sess = tm.open(A0, session_id="pp")
    sess.prestage(values(0), u0)
    with pytest.raises(RuntimeError, match="prestage called twice"):
        sess.prestage(values(0), u0)
    t = sess.commit()
    tm.flush()
    assert int(t.result().status) == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lockstep_groups_match_jax(dtype):
    """Four sessions of one pattern in lockstep: each step one batched
    group of four (one setup, one built solve over all steps), every
    member's steps as the JAX package's."""
    A0, values, u0, f, n = _heat_workload()
    A0 = A0.astype(dtype)
    tm, jm = managers(AMG_STEP_CFG.replace(
        '"tolerance": 1e-8', '"tolerance": 1e-4'))
    tses = [tm.open(A0, session_id=f"s{i}") for i in range(4)]
    jses = [jm.open(A0, session_id=f"s{i}") for i in range(4)]
    scale = [1.0, 1.1, 0.9, 1.3]
    for k in range(3):
        tt = tm.step_all([(s, values(k) * c, _rhs(u0, f))
                          for s, c in zip(tses, scale)])
        jt = jm.step_all([(s, values(k) * c, _rhs(u0, f))
                          for s, c in zip(jses, scale)])
        for a, b in zip(tt, jt):
            ra, rb = a.result(), b.result()
            assert int(ra.status) == int(rb.status) == 0
            if dtype == np.float64:
                same(ra, rb)
            else:
                assert abs(int(ra.iters) - int(rb.iters)) <= 1
                xb = np.asarray(rb.x)
                np.testing.assert_allclose(ra.x.numpy(), xb, rtol=0,
                                           atol=1e-4 * np.abs(xb).max())
    m = tm.service.metrics
    assert (m.get("batches"), m.get("setups"), m.get("compiles")) == (
        3, 1, 1) == (jm.service.metrics.get("batches"),
                     jm.service.metrics.get("setups"),
                     jm.service.metrics.get("compiles"))
    assert tm.counters()["step_groups_total"] == 3


# ---------------------------------------------------------------------
# the values-only fast path


def test_steps_extract_no_csr_and_hash_no_pattern(monkeypatch):
    from amgx_tpu_torch.core import matrix as cm
    from amgx_tpu_torch.serve import bucketing, service

    A0, values, u0, f, n = _heat_workload()
    tm, _ = managers()
    sessions = [tm.open(A0, session_id=f"h{i}") for i in range(2)]
    svc = tm.service
    # the opens hashed the pattern and padded it, once
    hashes = svc.metrics.get("pattern_hashes")
    assert hashes == 2

    def refuse(*a, **k):
        raise AssertionError("a session step extracted a CSR or hashed")

    for mod in (service, cm):
        monkeypatch.setattr(mod, "sparsity_fingerprint", refuse)
    monkeypatch.setattr(service, "_host_csr", refuse)
    monkeypatch.setattr(bucketing, "pad_pattern", refuse)
    for k in range(4):
        tickets = tm.step_all([(s, values(k), _rhs(u0, f))
                               for s in sessions])
        assert all(int(t.result().status) == 0 for t in tickets)
    assert svc.metrics.get("pattern_hashes") == hashes
    assert svc.metrics.get("batches") == 4


def test_resetup_every_refreshes_the_entry_per_fingerprint():
    A0, values, u0, f, n = _heat_workload()
    tm, jm = managers(resetup_every=3)
    for mgr, snap in ((tm, tm.counters), (jm, jm.telemetry_snapshot)):
        sessions = [mgr.open(A0, session_id=f"r{i}") for i in range(2)]
        for k in range(4):
            mgr.step_all([(s, values(k), u0) for s in sessions])
        # 8 steps of one fingerprint: refreshes at the 3rd and 6th
        assert snap()["entry_resetups_total"] == 2
        assert mgr.service.metrics.get("entry_resetups") == 2
    # the cached solver carries the values of the 6th step (step 2)
    svc = tm.service
    pat = svc._patterns[tm.sessions()[0].fingerprint]
    entry = svc.cache.peek(pat.fingerprint, svc.cfg_key,
                           np.dtype(np.float64))
    got = pat.extract_values(entry.solver.A.values.numpy())
    np.testing.assert_array_equal(got, values(2))


# ---------------------------------------------------------------------
# the documented differences: a service that is not started


def test_syncs_and_overlap_of_a_synchronous_solve():
    """Over a service that is not started a step group has run when its
    flush returns: no prestage overlaps a loop (``resetup_overlap_s``
    0, the JAX package's > 0); and a step group reads its norms every
    iteration: iterations + 2 host syncs a group (the JAX package's
    one)."""
    A0, values, u0, f, n = _heat_workload()
    tm, _ = managers()
    sessions = [tm.open(A0, session_id=f"o{i}") for i in range(2)]
    svc = tm.service
    want = 0
    for k in range(4):
        h0 = svc.metrics.get("host_syncs")
        tickets = tm.step_all([(s, values(k), _rhs(u0, f))
                               for s in sessions])
        it = max(int(t.result().iters) for t in tickets)
        want += it + 2
        assert svc.metrics.get("host_syncs") - h0 == it + 2
    for s in sessions:
        s.finish()
    assert tm.resetup_overlap_s == 0.0 and tm.resetup_s > 0.0


# ---------------------------------------------------------------------
# the service's resetup_entry


def test_resetup_entry_refreshes_cached_hierarchy():
    A0, values, u0, f, n = _heat_workload()
    svc = BatchedSolveService(config=STEP_CFG, max_batch=4, device="cpu")
    res = svc.solve_many([(A0, u0)])
    assert int(res[0].status) == 0
    raw_fp = getattr(A0, "_amgx_tpu_fp")
    v1 = values(3)
    assert svc.resetup_entry(raw_fp, v1) is None
    assert svc.metrics.get("entry_resetups") == 1
    pat = svc._patterns[raw_fp]
    entry = svc.cache.peek(pat.fingerprint, svc.cfg_key,
                           np.dtype(np.float64))
    got = pat.extract_values(entry.solver.A.values.numpy())
    assert np.array_equal(got, v1)
    res2 = svc.resetup_entry(raw_fp, v1, b=u0)
    assert int(res2.status) == 0
    A1 = sps.csr_matrix((v1, A0.indices, A0.indptr), shape=A0.shape)
    x_ref = svc.solve_many([(A1, u0)])[0].x.numpy()
    assert np.allclose(res2.x.numpy()[:n], x_ref, atol=1e-5)


def test_resetup_entry_unknown_fingerprint_raises():
    svc = BatchedSolveService(config=STEP_CFG, max_batch=4, device="cpu")
    with pytest.raises(KeyError):
        svc.resetup_entry("no-such-fp", np.ones(5))


# ---------------------------------------------------------------------
# placement, tenants and a gateway front, as in the JAX package


@pytest.mark.parametrize("call", ["placement", "tenant", "gateway"])
def test_unported_session_parts_raise(call):
    """What raised before the gateway's slice now runs as in the JAX
    package: ``placement_device`` is None on one device (before and
    after the first step), a session's tenant and lane reach its
    tickets and records, and a gateway front admits each step (the
    same steps as over the bare service)."""
    from amgx_tpu.serve import SolveGateway as JGateway
    from amgx_tpu_torch.serve import SolveGateway

    A0, values, u0, f, n = _heat_workload()
    tm, jm = managers()
    if call == "gateway":
        tm = SessionManager(SolveGateway(BatchedSolveService(
            config=STEP_CFG, max_batch=4, device="cpu")))
        jm = JManager(JGateway(JService(config=STEP_CFG, max_batch=4)))
        assert tm.gateway is not None and jm.gateway is not None
    kw = {"tenant": "cfd", "lane": "batch"} if call == "tenant" else {}
    ts = tm.open(A0, session_id="stub", **kw)
    js = jm.open(A0, session_id="stub", **kw)
    assert ts.placement_device is js.placement_device is None
    for k in range(2):
        tt = ts.step(values(k), _rhs(u0, f))
        jt = js.step(values(k), _rhs(u0, f))
        tm.flush()
        jm.flush()
        same(tt.result(), jt.result())
    assert ts.placement_device is js.placement_device is None
    assert (ts.tenant, ts.lane) == (js.tenant, js.lane)
    trec = tm.service.recorder.records()[-1]
    jrec = jm.service.recorder.records()[-1]
    assert (trec.lane, trec.tenant) == (jrec.lane, jrec.tenant)
    assert tm.service.metrics.snapshot()["lanes"].keys() == (
        jm.service.metrics.snapshot()["lanes"].keys())
    if call == "gateway":
        for key in ("gateway_admitted", "gateway_completed",
                    "gateway_sheds"):
            assert tm.service.metrics.get(key) == jm.service.metrics.get(
                key), key
        assert tm.service.metrics.get("gateway_admitted") == 2


# ---------------------------------------------------------------------
# the C API


def _capi_session(capi, mode, cfg, steps, A0, values, u0, f, save_dir):
    """Create, ``steps`` steps with replace_coefficients, sync, save to
    ``save_dir``: the (status, iterations, x) of each step."""
    capi.initialize()
    n = A0.shape[0]
    c = capi.config_create(cfg)
    res_h = capi.resources_create_simple(c)
    mtx = capi.matrix_create(res_h, mode)
    rhs = capi.vector_create(res_h, mode)
    sol = capi.vector_create(res_h, mode)
    capi.matrix_upload_all(mtx, n, A0.nnz, 1, 1, A0.indptr, A0.indices,
                           values(0), None)
    slv = capi.solver_create(res_h, mode, c)
    sess_h = capi.solver_session_create(slv, mtx)
    out, x = [], u0
    for k in range(steps):
        capi.matrix_replace_coefficients(mtx, n, A0.nnz, values(k))
        capi.vector_upload(rhs, n, 1, x + 2.0 * f)
        assert capi.solver_session_step(sess_h, mtx, rhs, sol) == 0
        assert capi.solver_session_sync(sess_h) == 0
        x = capi.vector_download(sol)
        out.append((capi.solver_session_get_status(sess_h),
                    capi.solver_session_get_iterations_number(sess_h), x))
    assert capi.solver_session_save(sess_h, str(save_dir)) == capi.RC_OK
    assert any(p.suffix == ".npz" for p in save_dir.iterdir())
    assert capi.solver_session_destroy(sess_h) == 0
    for h, fn in ((slv, capi.solver_destroy), (mtx, capi.matrix_destroy),
                  (rhs, capi.vector_destroy), (sol, capi.vector_destroy)):
        fn(h)
    return out


def test_capi_session_roundtrip_as_python_session_and_jax(tmp_path):
    """tests/test_sessions.py's round trip in hDDI, the save included:
    every RC 0, statuses and iterations as the JAX package's (dDDI, its
    CPU) and as a Python session's, x bit for bit with the Python
    session's and to rtol 1e-10 of the JAX package's."""
    import amgx_tpu.api.capi as J

    from amgx_tpu_torch.api import capi as T

    A0, values, u0, f, n = _heat_workload()
    got = _capi_session(T, "hDDI", STEP_CFG, 3, A0, values, u0, f,
                        tmp_path)
    tm, _ = managers()
    sess = tm.open(A0)
    x = u0
    for (st, it, xc), k in zip(got, range(3)):
        t = sess.step(values(k), x + 2.0 * f)
        tm.flush()
        r = t.result()
        assert (st, it) == (int(r.status), int(r.iters))
        assert st == 0 and it > 0
        np.testing.assert_array_equal(xc, r.x.numpy())
        x = xc
    # the JAX package's round trip (its save needs a store: left out)
    J.initialize()
    c = J.config_create(STEP_CFG)
    res_h = J.resources_create_simple(c)
    mtx, rhs, sol = (J.matrix_create(res_h, "dDDI"),
                     J.vector_create(res_h, "dDDI"),
                     J.vector_create(res_h, "dDDI"))
    J.matrix_upload_all(mtx, n, A0.nnz, 1, 1, A0.indptr, A0.indices,
                        values(0), None)
    slv = J.solver_create(res_h, "dDDI", c)
    sh = J.solver_session_create(slv, mtx)
    x = u0
    for k, (st, it, xc) in enumerate(got):
        J.matrix_replace_coefficients(mtx, n, A0.nnz, values(k))
        J.vector_upload(rhs, n, 1, x + 2.0 * f)
        J.solver_session_step(sh, mtx, rhs, sol)
        J.solver_session_sync(sh)
        assert (J.solver_session_get_status(sh),
                J.solver_session_get_iterations_number(sh)) == (st, it)
        x = J.vector_download(sol)
        np.testing.assert_allclose(xc, x, rtol=0,
                                   atol=RTOL * np.abs(x).max())
    J.solver_session_destroy(sh)


def test_sessions_import_no_jax():
    import subprocess
    import sys

    code = ("import sys, amgx_tpu_torch.sessions, amgx_tpu_torch.api.capi;"
            " bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'amgx_tpu.'))] + (['amgx_tpu'] if 'amgx_tpu' in "
            "sys.modules else []); print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_session_x_is_a_host_copy_and_steps_count():
    A0, values, u0, f, n = _heat_workload()
    tm, _ = managers()
    sess = tm.open(A0, session_id="c")
    t = sess.step(values(0), u0)
    tm.flush()
    r = t.result()
    assert isinstance(r.x, torch.Tensor)
    assert sess.last_x is not None and sess.last_x.dtype == np.float64
    snap = tm.counters()
    assert (snap["opens_total"], snap["steps_total"], snap["open"]) == (
        1, 1, 1)
    sess.close()
    assert tm.counters()["open"] == 0 and sess.closed
