"""Warm boot and session persistence of the port on the CPU: the flows
of ``tests/test_store.py`` (a service served from its store, a corrupt
entry falling back to a fresh setup, another configuration's entries
ignored, evicted builds tombstoned) and ``tests/test_sessions.py``
(drain, warm boot and restore bit for bit; a missing session raising
``StoreError`` and counting ``restore_failures_total``; a restored
solver's ``replace_values`` bit for bit) through the port, and serve
entries and sessions crossing between the packages both ways (the same
iterations and status, x to rtol 1e-10 in f64).  Every store lives
under pytest's ``tmp_path``; every wait has a timeout."""

import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
from amgx_tpu.serve import BatchedSolveService as JService
from amgx_tpu.sessions import SessionManager as JManager
from amgx_tpu_torch.config.amg_config import AMGConfig
from amgx_tpu_torch.core.errors import StoreError
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.io.poisson import jittered_poisson_family, poisson_scipy
from amgx_tpu_torch.serve import DEFAULT_CONFIG, BatchedSolveService
from amgx_tpu_torch.serve.cache import CompileCache, _compile_pool
from amgx_tpu_torch.sessions import SessionManager
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import create_solver, make_nested
from amgx_tpu_torch.store import ArtifactStore
from amgx_tpu_torch.store import warmboot

amgx_tpu.initialize()

WAIT = 60.0
RTOL = 1e-10
PCG_AMG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 32, "max_levels": 10,'
    ' "structure_reuse_levels": -1,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)
# tests/test_sessions.py's configs
STEP_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 300, "tolerance": 1e-6,'
    ' "monitor_residual": 1, "convergence": "ABSOLUTE",'
    ' "preconditioner": {"scope": "jac", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.9, "max_iters": 2,'
    ' "monitor_residual": 0}}}'
)
AMG_CFG = PCG_AMG.replace('"min_coarse_rows": 32', '"min_coarse_rows": 16')


def _serve_systems(shape=(16, 16), count=8):
    return jittered_poisson_family(shape, count, seed=0)


def tsvc(cfg=DEFAULT_CONFIG, **kw):
    return BatchedSolveService(config=cfg, device="cpu", **kw)


def _heat_workload(nx=12, dt=2.0, seed=0):
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
    u0 = np.random.default_rng(seed).standard_normal(n)
    xx, yy = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, nx))
    f = (np.sin(np.pi * xx) * np.sin(np.pi * yy)).ravel()
    return A0, values, u0, f, n


def _rhs(u0, f, dt=2.0):
    return lambda sess: (u0 if sess.last_x is None else sess.last_x) + dt * f


def host_x(r):
    x = r.x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------
# warm-boot serving (tests/test_store.py)


def test_warmboot_service_serves_from_store(tmp_path):
    systems = _serve_systems()
    svc1 = tsvc(max_batch=8, store=str(tmp_path))
    res1 = svc1.solve_many(systems)
    assert all(int(r.status) == 0 for r in res1)
    svc1.flush_store(timeout=WAIT)
    assert svc1.metrics.get("store_exports") >= 1
    assert len(svc1.store) >= 1

    svc2 = tsvc(max_batch=8, store=str(tmp_path))
    assert svc2.warm_boot() >= 1
    res2 = svc2.solve_many(systems)
    m2 = svc2.metrics.snapshot()
    assert m2.get("cache_hits", 0) >= 1
    assert m2.get("cache_misses", 0) == 0
    assert m2.get("setups", 0) == 0
    assert m2.get("warmboot_restores", 0) >= 1
    # the restored entry's batched solve was built ahead of the flush
    assert m2.get("compile_warmups", 0) == 1 and m2.get("bucket_hits") >= 1
    for r1, r2 in zip(res1, res2):
        assert int(r1.iters) == int(r2.iters)
        assert int(r1.status) == int(r2.status)
        assert torch.equal(r1.x, r2.x)


def test_warmboot_corrupt_entry_falls_back_to_fresh_setup(tmp_path):
    systems = _serve_systems()
    svc1 = tsvc(max_batch=8, store=str(tmp_path))
    svc1.solve_many(systems)
    svc1.flush_store(timeout=WAIT)
    for name in os.listdir(svc1.store.root):
        if name.endswith(".npz"):
            with open(os.path.join(svc1.store.root, name), "wb") as fh:
                fh.write(b"rotten")
    svc2 = tsvc(max_batch=8, store=str(tmp_path))
    assert svc2.warm_boot() == 0
    assert svc2.metrics.get("warmboot_failures") >= 1
    res = svc2.solve_many(systems)
    assert all(int(r.status) == 0 for r in res)
    assert svc2.metrics.get("setups") == 1


def test_warmboot_ignores_other_config(tmp_path):
    svc1 = tsvc(max_batch=8, store=str(tmp_path))
    svc1.solve_many(_serve_systems())
    svc1.flush_store(timeout=WAIT)
    svc_other = tsvc(PCG_AMG, max_batch=8, store=str(tmp_path))
    assert svc_other.warm_boot() == 0
    assert svc_other.metrics.get("warmboot_failures") == 0


def test_warmboot_without_waiting_overlaps_traffic(tmp_path):
    """``wait=False`` returns the restores scheduled; once the shared
    worker has run them, the pattern's first group is a hit."""
    systems = _serve_systems()
    svc1 = tsvc(max_batch=8, store=ArtifactStore(str(tmp_path)))
    svc1.solve_many(systems)
    svc1.flush_store(timeout=WAIT)
    svc2 = tsvc(max_batch=8, store=str(tmp_path))
    assert svc2.warm_boot(wait=False) == 1
    _compile_pool().submit(lambda: None).result(timeout=WAIT)
    svc2.solve_many(systems)
    assert svc2.metrics.get("setups") == 0
    assert svc2.metrics.get("warmboot_restores") == 1


def test_export_all_entries_skips_entries_on_disk(tmp_path):
    svc = tsvc(max_batch=8, store=str(tmp_path))
    svc.solve_many(_serve_systems())
    svc.solve_many(_serve_systems(shape=(12, 12), count=4))
    assert svc.export_all_entries() == 2
    assert svc.metrics.get("store_exports") == 2
    assert svc.metrics.get("store_export_skips") == 2
    assert svc.export_all_entries() == 2
    assert svc.metrics.get("store_export_skips") == 4


def test_export_failure_is_counted_never_raised(tmp_path, monkeypatch):
    def broken(service, entry, dtype):
        raise OSError("disk gone")

    monkeypatch.setattr(warmboot, "export_entry", broken)
    svc = tsvc(max_batch=8, store=str(tmp_path))
    res = svc.solve_many(_serve_systems())
    svc.flush_store(timeout=WAIT)
    assert all(int(r.status) == 0 for r in res)
    assert svc.metrics.get("store_export_failures") == 1
    assert svc.metrics.get("store_exports") == 0


def test_no_store_exports_nothing():
    svc = tsvc(max_batch=8)
    svc.solve_many(_serve_systems(count=2))
    assert svc.store is None
    assert svc.export_all_entries() == 0 and svc.warm_boot() == 0
    assert svc.metrics.get("store_exports") == 0


@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, PCG_AMG],
                         ids=["pcg_jacobi", "pcg_amg"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_entries_cross_the_packages(tmp_path, cfg, direction):
    """A serve entry exported by one package's service warm-boots in the
    other's: its first group is a hit with no setup, with the exporter's
    iterations and status and x to rtol 1e-10."""
    systems = _serve_systems()
    make = {"jax": lambda: JService(config=cfg, max_batch=8,
                                    store=str(tmp_path)),
            "port": lambda: tsvc(cfg, max_batch=8, store=str(tmp_path))}
    src, dst = direction.split("_to_")
    exporter = make[src]()
    ref = exporter.solve_many(systems)
    exporter.flush_store()
    booted = make[dst]()
    assert booted.warm_boot() == 1
    got = booted.solve_many(systems)
    m = booted.metrics.snapshot()
    assert m.get("setups", 0) == 0 and m.get("cache_hits", 0) == 1
    for a, r in zip(got, ref):
        assert int(a.status) == int(r.status) == 0
        assert int(a.iters) == int(r.iters)
        xr = host_x(r)
        np.testing.assert_allclose(host_x(a), xr, rtol=0,
                                   atol=RTOL * np.abs(xr).max())


def test_restored_entry_hierarchy_bitwise(tmp_path):
    systems = _serve_systems(shape=(12, 12, 12), count=4)
    svc1 = tsvc(PCG_AMG, max_batch=4, store=str(tmp_path))
    svc1.solve_many(systems)
    svc1.flush_store(timeout=WAIT)
    svc2 = tsvc(PCG_AMG, max_batch=4, store=str(tmp_path))
    assert svc2.warm_boot() == 1
    (key1, e1), = svc1.cache.items()
    (key2, e2), = svc2.cache.items()
    assert key1 == key2
    amg1, amg2 = e1.solver.precond, e2.solver.precond
    assert amg2.setup_stats["coarsen_calls"] == 0
    assert amg2.setup_stats["restored"] is True
    assert len(amg1.levels) == len(amg2.levels)
    for l1, l2 in zip(amg1.levels, amg2.levels):
        assert torch.equal(l1.A.values, l2.A.values)
        assert torch.equal(l1.A.col_indices, l2.A.col_indices)
    assert e1.signature == e2.signature


# ---------------------------------------------------------------------
# the compile cache's eviction (tests/test_store.py)


def test_hierarchy_evict_drops_compile_entries():
    svc = tsvc(max_batch=4, cache_entries=1)
    svc.solve_many(_serve_systems(shape=(8, 8), count=4))
    n_before = len(svc.compile_cache)
    assert n_before >= 1 and len(svc._last_bucket) == 1
    svc.solve_many(_serve_systems(shape=(12, 12), count=4))
    m = svc.metrics.snapshot()
    assert m.get("cache_evictions", 0) >= 1
    assert m.get("compile_evictions", 0) >= 1
    assert len(svc.compile_cache) <= n_before
    assert len(svc._last_bucket) == 1


def test_evict_signature_tombstones_inflight_warmups():
    """A build that finishes after its signature was evicted is handed to
    its waiters and not kept; a later get() of the signature clears the
    tombstone."""
    import concurrent.futures
    from types import SimpleNamespace

    cc = CompileCache()
    cc._compile = lambda entry, Bb: ("FN", Bb)
    entry = SimpleNamespace(signature="S")
    cc._fns[("S", 4)] = ("FN", 4)
    fut = concurrent.futures.Future()
    cc._futures[("S", 8)] = fut
    assert cc.evict_signature("S") == 1
    assert cc.metrics.get("compile_evictions") == 1
    cc._resolve(("S", 8), entry, 8, fut)
    assert fut.result(timeout=WAIT) == ("FN", 8)
    assert len(cc) == 0
    assert cc.get(entry, 8) == ("FN", 8)
    assert len(cc) == 1


def test_warm_builds_on_the_shared_worker():
    """warm() builds on the background worker: a get() in the meantime
    joins that build instead of building again."""
    import threading
    from types import SimpleNamespace

    cc = CompileCache()
    release, names = threading.Event(), []

    def slow(entry, Bb):
        names.append(threading.current_thread().name)
        release.wait(WAIT)
        return ("FN", Bb)

    cc._compile = slow
    entry = SimpleNamespace(signature="S")
    cc.warm(entry, 4)
    assert cc.metrics.get("compile_warmups") == 1
    release.set()
    assert cc.get(entry, 4) == ("FN", 4)
    assert cc.metrics.get("compiles") == 1
    assert names == [n for n in names if n.startswith("serve-compile")]


# ---------------------------------------------------------------------
# sessions: drain, warm boot, restore (tests/test_sessions.py)


def _stream(mgr, sess, values, u0, f, ks):
    for k in ks:
        sess.step(values(k), _rhs(u0, f))
        mgr.flush()


def test_session_drain_warmboot_restore_bitwise(tmp_path):
    A0, values, u0, f, n = _heat_workload()
    svc = tsvc(AMG_CFG, max_batch=4, store=str(tmp_path))
    mgr = SessionManager(svc)
    sess = mgr.open(A0, session_id="restore-me", deadline_s=30.0)
    _stream(mgr, sess, values, u0, f, range(3))
    report = mgr.drain()
    assert report["sessions_saved"] == 1
    assert report["entries_exported"] >= 1
    saved_x = np.array(sess.last_x)
    entry1 = svc.cache.peek(sess._padded_fp, svc.cfg_key,
                            np.dtype(np.float64))

    svc2 = tsvc(AMG_CFG, max_batch=4, store=str(tmp_path))
    assert svc2.warm_boot() >= 1
    mgr2 = SessionManager(svc2)
    sess2 = mgr2.restore("restore-me")
    assert sess2.step_idx == 3
    assert sess2.deadline_s == 30.0
    assert np.array_equal(sess2.last_x, saved_x)
    entry2 = svc2.cache.peek(sess._padded_fp, svc2.cfg_key,
                             np.dtype(np.float64))
    amg1, amg2 = entry1.solver.precond, entry2.solver.precond
    assert amg2.setup_stats["coarsen_calls"] == 0
    assert amg2.setup_stats["restored"] is True
    assert len(amg1.levels) == len(amg2.levels)
    for l1, l2 in zip(amg1.levels, amg2.levels):
        assert torch.equal(l1.A.values, l2.A.values)
        assert torch.equal(l1.A.col_indices, l2.A.col_indices)

    t = sess2.step(values(3), _rhs(u0, f))
    mgr2.flush()
    assert int(t.result().status) == 0
    assert sess2.step_idx == 4
    m = svc2.metrics.snapshot()
    assert m.get("cache_hits", 0) >= 1 and m.get("setups", 0) == 0
    assert amg2.setup_stats["coarsen_calls"] == 0
    # the uninterrupted stream's step 3, bit for bit
    t1 = sess.step(values(3), _rhs(u0, f))
    mgr.flush()
    assert torch.equal(t.result().x, t1.result().x)
    sess.finish()
    sess2.finish()
    assert np.array_equal(sess2.last_x, sess.last_x)
    snap = mgr2.telemetry_snapshot()
    assert snap["restores_total"] == 1
    assert svc2.metrics.get("resilience_restores") == 1


def test_restore_missing_session_raises(tmp_path):
    svc = tsvc(STEP_CFG, max_batch=4, store=str(tmp_path))
    mgr = SessionManager(svc)
    with pytest.raises(StoreError):
        mgr.restore("never-saved")
    assert mgr.telemetry_snapshot().get("restore_failures_total", 0) == 1


def test_restore_without_a_store_raises():
    mgr = SessionManager(tsvc(STEP_CFG, max_batch=4))
    with pytest.raises(StoreError):
        mgr.restore("s")
    A0, values, u0, f, n = _heat_workload()
    sess = mgr.open(A0)
    assert sess.save() is False
    assert mgr.counters()["save_failures_total"] == 1


def test_restore_refuses_another_config(tmp_path):
    A0, values, u0, f, n = _heat_workload()
    mgr = SessionManager(tsvc(STEP_CFG, max_batch=4, store=str(tmp_path)))
    sess = mgr.open(A0, session_id="s")
    _stream(mgr, sess, values, u0, f, range(1))
    assert sess.save() is True
    other = SessionManager(tsvc(AMG_CFG, max_batch=4, store=str(tmp_path)))
    with pytest.raises(StoreError):
        other.restore("s")
    assert other.counters()["restore_failures_total"] == 1


def test_checkpoint_every_and_recover(tmp_path):
    """checkpoint_every=2 saves at steps 2 and 4; recover resumes from the
    last checkpoint and retires the live session."""
    A0, values, u0, f, n = _heat_workload()
    svc = tsvc(STEP_CFG, max_batch=4, store=str(tmp_path))
    mgr = SessionManager(svc, checkpoint_every=2)
    sess = mgr.open(A0, session_id="ck")
    xs = []
    for k in range(5):
        sess.step(values(k), _rhs(u0, f))
        mgr.flush()
        sess.finish()
        xs.append(np.array(sess.last_x))
    assert mgr.counters()["checkpoints_total"] == 2
    assert svc.metrics.get("resilience_checkpoints") == 2
    back = mgr.recover("ck")
    assert back.step_idx == 4 and np.array_equal(back.last_x, xs[3])
    assert sess.closed and mgr.get("ck") is back
    assert mgr.counters()["recoveries_total"] == 1
    with pytest.raises(StoreError):
        mgr.recover("never-saved")


def test_checkpoint_default_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("AMGX_TPU_SESSION_CHECKPOINT_EVERY", "3")
    svc = tsvc(STEP_CFG, max_batch=4, store=str(tmp_path))
    assert SessionManager(svc).checkpoint_every == 3
    monkeypatch.delenv("AMGX_TPU_SESSION_CHECKPOINT_EVERY")
    assert SessionManager(svc).checkpoint_every == 16
    assert SessionManager(svc, checkpoint_every=0).checkpoint_every == 0


def test_save_all_and_a_manager_store(tmp_path):
    """A manager's own store (a path) takes the manifests; save_all
    finishes and saves every open session."""
    A0, values, u0, f, n = _heat_workload()
    mgr = SessionManager(tsvc(STEP_CFG, max_batch=4),
                         store=str(tmp_path / "sessions"))
    sessions = [mgr.open(A0, session_id=f"s{i}") for i in range(2)]
    mgr.step_all([(s, values(0), _rhs(u0, f)) for s in sessions])
    assert mgr.save_all() == 2
    assert len(mgr.store) == 2
    back = mgr.restore("s1")
    assert back.step_idx == 1
    assert np.array_equal(back.last_x, sessions[1].last_x)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sessions_cross_the_packages(tmp_path, direction):
    """A session drained by one package resumes in the other after its
    warm boot: the step counter and x bit for bit, the next step as the
    uninterrupted stream's (iterations equal, x to rtol 1e-10)."""
    A0, values, u0, f, n = _heat_workload()
    make = {
        "jax": lambda: JManager(JService(config=AMG_CFG, max_batch=4,
                                         store=str(tmp_path))),
        "port": lambda: SessionManager(tsvc(AMG_CFG, max_batch=4,
                                            store=str(tmp_path))),
    }
    src, dst = direction.split("_to_")
    mgr = make[src]()
    sess = mgr.open(A0, session_id="x")
    _stream(mgr, sess, values, u0, f, range(2))
    assert mgr.drain()["sessions_saved"] == 1
    saved_x = np.array(sess.last_x)
    mgr2 = make[dst]()
    assert mgr2.service.warm_boot() >= 1
    sess2 = mgr2.restore("x")
    assert sess2.step_idx == 2
    assert np.array_equal(np.asarray(sess2.last_x), saved_x)
    t2 = sess2.step(values(2), _rhs(u0, f))
    mgr2.flush()
    t1 = sess.step(values(2), _rhs(u0, f))
    mgr.flush()
    r1, r2 = t1.result(), t2.result()
    assert int(r1.status) == int(r2.status) == 0
    assert int(r1.iters) == int(r2.iters)
    x1 = host_x(r1)
    np.testing.assert_allclose(host_x(r2), x1, rtol=0,
                               atol=RTOL * np.abs(x1).max())
    assert mgr2.service.metrics.snapshot().get("setups", 0) == 0


def test_capi_session_save_then_restore(tmp_path):
    """``solver_session_save`` settles the step in flight, writes the
    session into the store at its path and answers RC_OK; a manager
    over that store restores it with the C API's x."""
    from amgx_tpu_torch.api import capi as C

    A0, values, u0, f, n = _heat_workload()
    C.initialize()
    c = C.config_create(STEP_CFG)
    r = C.resources_create_simple(c)
    mtx, rhs, sol = (C.matrix_create(r, "hDDI"), C.vector_create(r, "hDDI"),
                     C.vector_create(r, "hDDI"))
    C.matrix_upload_all(mtx, n, A0.nnz, 1, 1, A0.indptr, A0.indices,
                        values(0), None)
    slv = C.solver_create(r, "hDDI", c)
    sh = C.solver_session_create(slv, mtx)
    x = u0
    for k in range(2):
        C.matrix_replace_coefficients(mtx, n, A0.nnz, values(k))
        C.vector_upload(rhs, n, 1, x + 2.0 * f)
        assert C.solver_session_step(sh, mtx, rhs, sol) == C.RC_OK
        assert C.solver_session_sync(sh) == C.RC_OK
        x = C.vector_download(sol)
    folder = tmp_path / "capi"
    assert C.solver_session_save(sh, str(folder)) == C.RC_OK
    files = sorted(p.suffix for p in folder.iterdir())
    assert files == [".json", ".npz"]
    sid = C._objects[sh].session.session_id
    mgr = SessionManager(tsvc(STEP_CFG), store=str(folder))
    back = mgr.restore(sid)
    assert back.step_idx == 2
    np.testing.assert_array_equal(back.last_x, x)
    for h, fn in ((sh, C.solver_session_destroy), (slv, C.solver_destroy),
                  (mtx, C.matrix_destroy), (rhs, C.vector_destroy),
                  (sol, C.vector_destroy)):
        fn(h)


def test_capi_session_save_failure_is_an_io_rc(tmp_path, monkeypatch):
    from amgx_tpu_torch.api import capi as C
    from amgx_tpu_torch.sessions import session as session_mod

    A0, values, u0, f, n = _heat_workload()
    C.initialize()
    c = C.config_create(STEP_CFG)
    r = C.resources_create_simple(c)
    mtx = C.matrix_create(r, "hDDI")
    C.matrix_upload_all(mtx, n, A0.nnz, 1, 1, A0.indptr, A0.indices,
                        values(0), None)
    slv = C.solver_create(r, "hDDI", c)
    sh = C.solver_session_create(slv, mtx)
    monkeypatch.setattr(session_mod.SessionManager, "save_session",
                        lambda self, sess, store=None: False)
    with pytest.raises(C.AMGXError) as e:
        C.solver_session_save(sh, str(tmp_path))
    assert e.value.rc == C.RC_IO_ERROR
    C.solver_session_destroy(sh)
    C.solver_destroy(slv)
    C.matrix_destroy(mtx)


# ---------------------------------------------------------------------
# a restored solver's replace_values (tests/test_sessions.py)


def test_restored_replace_values_bitwise_and_memoized(tmp_path):
    A0, values, u0, f, n = _heat_workload()
    A = SparseMatrix.from_csr(A0.indptr, A0.indices, values(0),
                              device="cpu")
    cold = make_nested(create_solver(AMGConfig.from_string(AMG_CFG),
                                     "default", device="cpu"))
    cold.setup(A)
    path = tmp_path / "s.npz"
    cold.save_setup(path)
    restored = Solver.load_setup(path, device="cpu")
    assert getattr(restored.A, "_fingerprint_cache", None) is not None
    assert restored.A.fingerprint() == A.fingerprint()
    v1 = values(2)
    A_cold = cold.A.replace_values(v1)
    A_rest = restored.A.replace_values(v1)
    assert getattr(A_rest, "_fingerprint_cache", None) == getattr(
        A_cold, "_fingerprint_cache", None)
    cold.resetup(A_cold)
    restored.resetup(A_rest)
    rc, rr = cold.solve(u0), restored.solve(u0)
    assert int(rr.iters) == int(rc.iters)
    assert int(rr.status) == int(rc.status)
    assert torch.equal(rr.x, rc.x)


# ---------------------------------------------------------------------
# telemetry of the store and the sessions


def test_persistence_counters_render(tmp_path):
    from amgx_tpu_torch.telemetry import get_registry

    A0, values, u0, f, n = _heat_workload()
    svc = tsvc(STEP_CFG, max_batch=4, store=str(tmp_path))
    mgr = SessionManager(svc, checkpoint_every=1)
    sess = mgr.open(A0, session_id="t")
    _stream(mgr, sess, values, u0, f, range(1))
    sess.finish()
    mgr.restore("t")
    with pytest.raises(StoreError):
        mgr.restore("none")
    text = get_registry().render_prometheus()
    for fam in ("amgx_session_checkpoints_total",
                "amgx_session_restores_total",
                "amgx_session_restore_failures_total",
                "amgx_resilience_checkpoints_total",
                "amgx_resilience_restores_total"):
        assert fam in text, fam
