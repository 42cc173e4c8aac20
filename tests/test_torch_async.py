"""The port's asynchronous solve on the CPU: ``Solver.solve(block=False)``
against the blocking solve (bit for bit, the same iterations) and
against the JAX package's ``solve(block=False)`` (status and iterations
equal, x to rtol 1e-10 in f64); the options that still synchronise; the
serve layer's dispatch stage (``tests/test_serve.py``'s hook-counting
contract: ``done()`` before any wait, one ``_block_ready`` and one
``_fetch_host`` a group, results in any order), the poller's pipelined
groups through one staging slot, a failure in the loop reaching the
tickets as a quarantine, fault budgets and trace contexts across the
thread hop, and the sessions' resetup/solve overlap over a polled
service (``tests/test_sessions.py``'s contract).

Every wait on a thread or a future has its own timeout, and every
started poller is stopped, so that a fault fails a test instead of
hanging the run.
"""

import concurrent.futures
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.solvers.registry import create_solver as jcreate
from amgx_tpu.solvers.registry import make_nested as jnested
from amgx_tpu_torch.config.amg_config import AMGConfig
from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.dispatch import dispatch_pool
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.io.poisson import jittered_poisson_family, poisson_scipy
from amgx_tpu_torch.serve import DEFAULT_CONFIG, BatchedSolveService
from amgx_tpu_torch.serve import service as service_mod
from amgx_tpu_torch.sessions import SessionManager
from amgx_tpu_torch.solvers.base import PendingSolveResult, SolveResult
from amgx_tpu_torch.solvers.registry import create_solver, make_nested
from amgx_tpu_torch.telemetry import tracing

amgx_tpu.initialize()

WAIT = 60.0  # seconds any one wait may take before the test fails

PCG_JACOBI = DEFAULT_CONFIG
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
GMRES_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "GMRES", "max_iters": 150, "gmres_n_restart": 30,'
    ' "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI",'
    ' "preconditioner": "NOSOLVER"}}'
)
# tests/test_sessions.py's time-stepping config
STEP_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 300, "tolerance": 1e-6,'
    ' "monitor_residual": 1, "convergence": "ABSOLUTE",'
    ' "preconditioner": {"scope": "jac", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.9, "max_iters": 2,'
    ' "monitor_residual": 0}}}'
)


class _Gate:
    """Holds the dispatch worker on a job until ``open()``, so that a
    test sees work queued behind it."""

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()
        self.fut = dispatch_pool().submit(self._hold)
        assert self.started.wait(WAIT)

    def _hold(self):
        self.started.set()
        self.release.wait(WAIT)

    def open(self):
        self.release.set()
        self.fut.result(timeout=WAIT)


def port_solver(cfg, sp):
    s = make_nested(create_solver(AMGConfig.from_string(cfg), "default",
                                  device="cpu"))
    return s.setup(SparseMatrix.from_scipy(sp, device="cpu"))


def tsvc(cfg=PCG_JACOBI, **kw):
    return BatchedSolveService(config=cfg, device="cpu", **kw)


def sequential(cfg, systems):
    return [port_solver(cfg, sp).solve(b) for sp, b in systems]


def submit_due(svc, systems):
    """Submit ``systems`` as one group of a service whose max wait is
    long, then make the group due at once: the poller takes it whole,
    however slowly the submits ran."""
    ts = [svc.submit(sp, b) for sp, b in systems]
    with svc._lock:
        grp = svc._groups.get(ts[0]._group_key)
        if grp is not None:
            grp.deadline = 0.0
    return ts


# ---------------------------------------------------------------------
# Solver.solve(block=False)


@pytest.mark.parametrize("cfg,shape", [(PCG_JACOBI, (10, 10)),
                                       (PCG_AMG, (12, 12, 12)),
                                       (GMRES_CFG, (10, 10))],
                         ids=["pcg_jacobi", "pcg_amg", "gmres"])
def test_async_solve_bitwise_as_blocking(cfg, shape):
    (sp, b), = jittered_poisson_family(shape, 1, seed=25)
    s = port_solver(cfg, sp)
    r_async = s.solve(b, block=False)
    assert isinstance(r_async, PendingSolveResult)
    r_block = s.solve(b)
    assert type(r_block) is SolveResult
    assert int(r_async.status) == int(r_block.status) == 0
    assert int(r_async.iters) == int(r_block.iters)
    assert torch.equal(r_async.x, r_block.x)
    np.testing.assert_array_equal(r_async.history, r_block.history)
    np.testing.assert_array_equal(r_async.final_norm, r_block.final_norm)
    np.testing.assert_array_equal(r_async.initial_norm,
                                  r_block.initial_norm)


def test_async_solve_as_jax():
    """tests/test_serve.py's async-mode solve, through both packages:
    the same status and iterations, x to rtol 1e-10."""
    (sp, b), = jittered_poisson_family((10, 10), 1, seed=25)
    tr = port_solver(PCG_JACOBI, sp).solve(b, block=False)
    js = jnested(jcreate(JConfig.from_string(PCG_JACOBI), "default"))
    js.setup(JMatrix.from_scipy(sp))
    jr = js.solve(b, block=False)
    assert int(tr.status) == int(jr.status) == 0
    assert int(tr.iters) == int(jr.iters)
    xj = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())


def test_async_solve_returns_before_the_solve_ends():
    """With the dispatch worker held, solve(block=False) still returns:
    the loop waits behind the held job, and the result is not ready
    until the worker is released."""
    (sp, b), = jittered_poisson_family((10, 10), 1, seed=26)
    s = port_solver(PCG_JACOBI, sp)
    ref = s.solve(b)
    gate = _Gate()
    try:
        t0 = time.perf_counter()
        res = s.solve(b, block=False)
        assert time.perf_counter() - t0 < WAIT
        assert not res._future.done()
    finally:
        gate.open()
    res._future.result(timeout=WAIT)
    assert int(res.iters) == int(ref.iters)
    assert torch.equal(res.x, ref.x)


@pytest.mark.parametrize("option", ["print_solve_stats", "obtain_timings",
                                    "convergence_analysis",
                                    "solve_retries"])
def test_sync_options_still_synchronise(option, capsys):
    """The options that read the result synchronise before the return
    even with block=False: with the dispatch worker held, the call
    returns a settled result (run on the caller's thread)."""
    (sp, b), = jittered_poisson_family((10, 10), 1, seed=27)
    value = {"convergence_analysis": 1, "solve_retries": 2}.get(option, 1)
    cfg = PCG_JACOBI.replace('"max_iters": 200,',
                             f'"max_iters": 200, "{option}": {value},')
    s = port_solver(cfg, sp)
    ref = port_solver(PCG_JACOBI, sp).solve(b)
    gate = _Gate()
    try:
        res = s.solve(b, block=False)
        assert type(res) is SolveResult
    finally:
        gate.open()
    assert int(res.iters) == int(ref.iters)
    assert torch.equal(res.x, ref.x)


def test_async_solve_error_raises_at_read():
    (sp, b), = jittered_poisson_family((10, 10), 1, seed=28)
    s = port_solver(PCG_JACOBI, sp)
    s.solve(b)

    def boom(params, b, x0):
        raise RuntimeError("loop failed")

    s._cache["solve"] = boom
    res = s.solve(b, block=False)
    with pytest.raises(RuntimeError, match="loop failed"):
        res.iters
    # the worker survives: the next solve runs
    s._cache.pop("solve")
    assert int(s.solve(b, block=False).status) == 0


# tests/test_torch_faults.py's stationary and Krylov solvers
JACOBI_MONITORED = (
    '{"config_version": 2, "solver": {"scope": "m",'
    ' "solver": "BLOCK_JACOBI", "monitor_residual": 1,'
    ' "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "max_iters": 800, "relaxation_factor": 0.9}}'
)
PCG_STAGNATION = (
    '{"config_version": 2, "solver": {"scope": "m", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI", "stagnation_window": 5,'
    ' "preconditioner": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "max_iters": 2, "monitor_residual": 0}}}'
)


@pytest.mark.parametrize("budget", [1, 2, -1])
@pytest.mark.parametrize("site,cfg", [("smoother_nan", JACOBI_MONITORED),
                                      ("dot_breakdown", PCG_STAGNATION)],
                         ids=["smoother_nan", "dot_breakdown"])
def test_fault_budgets_as_blocking(site, cfg, budget):
    """A solve built on the caller and run on the worker takes each
    place once: the same fired count, status and iterations as the
    blocking solve."""
    sp = poisson_scipy((12, 12)).tocsr()
    sp.sort_indices()
    b = np.random.default_rng(0).standard_normal(sp.shape[0])
    out = []
    for block in (True, False):
        faults.disarm()
        faults.reset_counters()
        s = create_solver(AMGConfig.from_string(cfg), "default",
                          device="cpu")
        s.setup(SparseMatrix.from_scipy(sp, device="cpu"))
        try:
            faults.arm(site, budget)
            r = s.solve(b, block=block)
            status, iters = int(r.status), int(r.iters)
        finally:
            faults.disarm()
        out.append((faults.fired(site), status, iters))
    faults.reset_counters()
    assert out[0] == out[1]
    assert out[0][0] >= 1


# ---------------------------------------------------------------------
# the serve layer's dispatch stage


def _count_hooks(monkeypatch):
    waits, gets = [], []
    real_block, real_get = service_mod._block_ready, service_mod._fetch_host
    monkeypatch.setattr(service_mod, "_block_ready",
                        lambda x: (waits.append(1), real_block(x))[1])
    monkeypatch.setattr(service_mod, "_fetch_host",
                        lambda t: (gets.append(1), real_get(t))[1])
    return waits, gets


def test_ticket_done_before_any_wait(monkeypatch):
    """tests/test_serve.py's contract: done() flips at the hand-over,
    before any wait; results read in reverse order; the group makes one
    _block_ready and one _fetch_host."""
    waits, gets = _count_hooks(monkeypatch)
    systems = jittered_poisson_family((10, 10), 4, seed=22)
    svc = tsvc(max_batch=4)
    tickets = [svc.submit(sp, b) for sp, b in systems]
    assert all(t.done() for t in tickets)
    assert not waits and not gets
    refs = sequential(PCG_JACOBI, systems)
    for t, ref in zip(reversed(tickets), reversed(refs)):
        r = t.result()
        assert int(r.status) == 0
        assert int(r.iters) == int(ref.iters)
        np.testing.assert_allclose(r.x.numpy(), ref.x.numpy(), rtol=0,
                                   atol=1e-12)
    assert len(waits) == 1 and len(gets) == 1


def test_steady_state_one_wait_per_group(monkeypatch):
    """Each submit and flush cycle makes one _block_ready and one
    _fetch_host a group; host_syncs counts the loop's norm reads and
    that wait (iterations + 2 a group)."""
    systems = jittered_poisson_family((10, 10), 8, seed=23)
    svc = tsvc(max_batch=8)
    svc.solve_many(systems)
    waits, gets = _count_hooks(monkeypatch)
    for _ in range(3):
        h0 = svc.metrics.get("host_syncs")
        res = svc.solve_many(systems)
        assert all(int(r.status) == 0 for r in res)
        it = max(int(r.iters) for r in res)
        assert svc.metrics.get("host_syncs") - h0 == it + 2
    assert len(waits) == 3 and len(gets) == 3


def test_poller_pipelines_two_groups_through_one_slot():
    """The poller hands group 1 to the dispatch worker; its rows are
    shipped and its slot released before its loop runs, so group 2 pads
    into the same slot while group 1 is in flight.  Each group's x is
    the synchronous flush's."""
    systems = jittered_poisson_family((10, 10), 6, seed=30)
    g1, g2 = systems[:3], [(sp, b * 3.0) for sp, b in systems[3:]]
    svc = tsvc(max_batch=8, max_wait_s=600.0)
    svc.solve_many(g1)  # the entry and its batched solve exist
    entered, release = threading.Event(), threading.Event()
    real_get = svc.compile_cache.get

    def held_get(entry, Bb):
        fn = real_get(entry, Bb)

        def held(*args):
            entered.set()
            release.wait(WAIT)
            return fn(*args)

        return held

    svc.compile_cache.get = held_get
    svc.start(interval_s=0.002)
    try:
        t1 = submit_due(svc, g1)
        assert entered.wait(WAIT)  # group 1's loop runs on the worker
        assert all(t.done() for t in t1)
        slot1 = [s for s in svc._staging[t1[0]._group_key]
                 if not s.in_use]
        reuses = svc.metrics.get("staging_reuses")
        t2 = [svc.submit(sp, b) for sp, b in g2]
        assert svc.metrics.get("staging_reuses") == reuses + 1
        assert svc._groups[t2[0]._group_key].slot in slot1
        with svc._lock:
            svc._groups[t2[0]._group_key].deadline = 0.0
        release.set()
        got1 = [t.result() for t in t1]
        got2 = [t.result() for t in t2]
    finally:
        release.set()
        svc.stop()
    ref1 = tsvc(max_batch=8).solve_many(g1)
    ref2 = tsvc(max_batch=8).solve_many(g2)
    for got, ref in ((got1, ref1), (got2, ref2)):
        for a, r in zip(got, ref):
            assert int(a.iters) == int(r.iters)
            assert torch.equal(a.x, r.x)


@pytest.mark.parametrize("polled", [False, True], ids=["inline", "worker"])
def test_loop_failure_quarantines(polled):
    """A loop that raises after the hand-over reaches the tickets through
    the quarantine: each member re-solves alone from its rows' device
    copies, and the results are the sequential solves'."""
    systems = jittered_poisson_family((10, 10), 3, seed=31)
    svc = tsvc(max_batch=8, max_wait_s=600.0)

    def broken_get(entry, Bb):
        def fn(*args):
            raise RuntimeError("batched loop failed")

        return fn

    svc.compile_cache.get = broken_get
    if polled:
        svc.start(interval_s=0.002)
    try:
        if polled:
            tickets = submit_due(svc, systems)
        else:
            tickets = [svc.submit(sp, b) for sp, b in systems]
            svc.flush()
        got = [t.result() for t in tickets]
    finally:
        svc.stop()
    m = svc.metrics.snapshot()
    assert m["quarantines"] == 1 and m["failed_groups"] == 1
    assert m["quarantined_solves"] == 3
    assert m.get("poisoned_requests", 0) == 0
    for g, r in zip(got, sequential(PCG_JACOBI, systems)):
        assert int(g.iters) == int(r.iters) and int(g.status) == 0
        np.testing.assert_allclose(g.x.numpy(), r.x.numpy(), rtol=0,
                                   atol=1e-12)


def test_sequential_fallback_runs_async():
    """GMRES has no batch rebuild: each request solves with
    solve(block=False) on the cached solver; the results are the
    sequential solves' and the flight records hold -1 (not read)."""
    systems = jittered_poisson_family((10, 10), 3, seed=32)
    svc = tsvc(GMRES_CFG, max_batch=4)
    tickets = [svc.submit(sp, b) for sp, b in systems]
    svc.flush()
    assert all(isinstance(t._result, PendingSolveResult) for t in tickets)
    got = [t.result() for t in tickets]
    assert svc.metrics.get("fallback_solves") == 3
    for g, r in zip(got, sequential(GMRES_CFG, systems)):
        assert int(g.iters) == int(r.iters)
        assert g.x.shape == r.x.shape
        np.testing.assert_allclose(g.x.numpy(), r.x.numpy(), rtol=0,
                                   atol=1e-10 * r.x.abs().max().item())
    recs = [r for r in svc.recorder.records() if r.path == "fallback"]
    assert recs and all(r.iterations == -1 for r in recs)


@pytest.mark.parametrize("polled", [False, True], ids=["inline", "worker"])
def test_fallback_solve_failure_quarantines(polled):
    """A GMRES fallback solve that raises on the dispatch worker fails
    its group as a unit, as a batched loop's failure does: one failed
    group, a quarantine incident, a breaker failure, and its request
    re-solved alone from its kept rows; every ticket holds the
    sequential solve's result, none the raw error."""
    systems = jittered_poisson_family((10, 10), 3, seed=34)
    svc = tsvc(GMRES_CFG, max_batch=8, max_wait_s=600.0)
    svc.solve_many(systems[:1])  # builds the entry
    [(_key, entry)] = svc.cache.items()
    real = entry.solver._solve_on_worker
    calls = []

    def flaky(*args):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            raise RuntimeError("fallback loop failed")
        return real(*args)

    entry.solver._solve_on_worker = flaky
    if polled:
        svc.start(interval_s=0.002)
    try:
        if polled:
            tickets = submit_due(svc, systems)
        else:
            tickets = [svc.submit(sp, b) for sp, b in systems]
            svc.flush()
        got = [t.result() for t in tickets]
    finally:
        svc.stop()
    assert len(calls) == 3 and all(c.startswith("serve-dispatch")
                                   for c in calls)
    m = svc.metrics.snapshot()
    assert m["failed_groups"] == 1 and m["quarantines"] == 1
    assert m["quarantined_solves"] == 1 and m["fallback_solves"] == 4
    assert m.get("poisoned_requests", 0) == 0 and m["solved"] == 4
    assert svc._fail_counts == {entry.pattern.fingerprint: 1}
    assert [i["kind"] for i in svc.recorder.incidents()] == ["quarantine"]
    for g, r in zip(got, sequential(GMRES_CFG, systems)):
        assert int(g.iters) == int(r.iters) and int(g.status) == 0
        np.testing.assert_allclose(g.x.numpy(), r.x.numpy(), rtol=0,
                                   atol=1e-10 * r.x.abs().max().item())


@pytest.mark.parametrize("how", ["flush", "max_batch"])
def test_started_service_flush_returns_at_hand_over(how):
    """On a started service a flush (flush(), or the submit that fills
    max_batch) hands the group's loop to the dispatch worker and
    returns once its tickets are done; the results are the sequential
    solves'."""
    systems = jittered_poisson_family((10, 10), 3, seed=35)
    svc = tsvc(max_batch=8 if how == "flush" else 3, max_wait_s=600.0)
    real_get = svc.compile_cache.get
    ran_on = []

    def get(entry, Bb):
        fn = real_get(entry, Bb)

        def run(*args):
            ran_on.append(threading.current_thread().name)
            return fn(*args)

        return run

    svc.compile_cache.get = get
    svc.start(interval_s=0.002)
    try:
        tickets = [svc.submit(sp, b) for sp, b in systems]
        if how == "flush":
            svc.flush()
        assert all(t.done() for t in tickets)
        got = [t.result() for t in tickets]
    finally:
        svc.stop()
    assert len(ran_on) == 1 and ran_on[0].startswith("serve-dispatch")
    for g, r in zip(got, sequential(PCG_JACOBI, systems)):
        assert int(g.iters) == int(r.iters)
        np.testing.assert_allclose(g.x.numpy(), r.x.numpy(), rtol=0,
                                   atol=1e-12)


def test_worker_spans_keep_the_ticket_trace():
    """Spans recorded on the dispatch worker (dispatch, then device and
    fetch at the result) carry the ticket's trace id."""
    systems = jittered_poisson_family((10, 10), 2, seed=33)
    tracing.set_sample_rate(1.0)
    tracing.clear()
    svc = tsvc(max_batch=8, max_wait_s=600.0)
    svc.start(interval_s=0.002)
    try:
        tickets = submit_due(svc, systems)
        for t in tickets:
            t.result()
    finally:
        svc.stop()
        spans = tracing.span_buffer().spans()
        tracing.set_sample_rate(0.0)
        tracing.clear()
    for t in tickets:
        names = {s["name"] for s in spans
                 if s["trace_id"] == t._trace.trace_id}
        assert {"submit", "pad", "queue", "dispatch", "device",
                "fetch"} <= names


# ---------------------------------------------------------------------
# sessions over an asynchronous service


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
    return A0, values, u0, f


def _stream(polled, steps=4, max_batch=4):
    A0, values, u0, f = _heat_workload()
    svc = tsvc(STEP_CFG, max_batch=max_batch, max_wait_s=10.0)
    if polled:
        svc.start(interval_s=0.002)
    try:
        mgr = SessionManager(svc)
        sessions = [mgr.open(A0, session_id=f"o{i}") for i in range(2)]
        xs = []
        for k in range(steps):
            mgr.step_all([(s, values(k),
                           lambda s: (u0 if s.last_x is None else s.last_x)
                           + 2.0 * f) for s in sessions])
            xs.append([None if s.last_x is None else s.last_x.copy()
                       for s in sessions])
        for s in sessions:
            s.finish()
        xs.append([s.last_x.copy() for s in sessions])
    finally:
        svc.stop()
    return mgr, xs


@pytest.mark.parametrize("polled,max_batch", [(False, 4), (True, 4),
                                              (True, 2)],
                         ids=["plain", "polled", "polled_full"])
def test_resetup_overlap_recorded(polled, max_batch):
    """tests/test_sessions.py's contract, over a started service: the
    flush of a step group (step_all's, or the submit that fills
    max_batch) hands it to the dispatch worker, so step k + 1's prestage
    runs while step k's loop runs and the overlap accumulator sees it;
    every step's x is the plain service's bit for bit.  Over a service
    that is not started the group runs inline in the flush and the
    overlap stays 0 (ROADMAP.md, queue C)."""
    mgr, xs = _stream(polled, max_batch=max_batch)
    overlap = mgr.telemetry_snapshot()["resetup_overlap_seconds_total"]
    assert mgr.resetup_s >= mgr.resetup_overlap_s
    if not polled:
        assert mgr.resetup_overlap_s == 0.0 and overlap == 0.0
        assert mgr.resetup_s > 0.0
        return
    assert mgr.resetup_overlap_s > 0.0 and overlap > 0.0
    _, ref = _stream(False)
    for a, b in zip(xs, ref):
        for xa, xb in zip(a, b):
            assert (xa is None and xb is None) or np.array_equal(xa, xb)


def test_overlap_counts_only_a_running_loop():
    """A step whose loop has ended but whose results are not yet
    fetched is no longer in flight: a prestage then overlaps nothing."""
    A0, values, u0, f = _heat_workload()
    svc = tsvc(STEP_CFG, max_batch=4, max_wait_s=600.0)
    svc.start(interval_s=0.002)
    try:
        mgr = SessionManager(svc)
        sessions = [mgr.open(A0, session_id=f"e{i}") for i in range(2)]
        for k in range(3):
            tickets = mgr.step_all([(s, values(k), u0 + 2.0 * f)
                                    for s in sessions])
            batch = tickets[0].ticket._batch
            assert batch is not None and all(t.ticket.done()
                                             for t in tickets)
            batch.inflight.result(timeout=WAIT)
            assert not batch.running() and not batch.fetched()
        for s in sessions:
            s.finish()
    finally:
        svc.stop()
    assert mgr.resetup_overlap_s == 0.0 and mgr.resetup_s > 0.0


def test_dispatch_worker_is_one_named_thread():
    names = set()
    futs = [dispatch_pool().submit(lambda: threading.current_thread().name)
            for _ in range(4)]
    for f in concurrent.futures.as_completed(futs, timeout=WAIT):
        names.add(f.result())
    assert len(names) == 1 and names.pop().startswith("serve-dispatch")
    assert dispatch_pool()._max_workers == 1
