"""Failure domains of the PyTorch port (device-loss failover, the fetch
watchdog, the breaker cadence, session checkpoints over a gateway, the
retry policy) against the JAX package's, on the CPU: the scenarios of
``tests/test_resilience.py`` without its mesh and affinity cases (the
multi-device placements wait for queue A.9).

Held equal between the packages: the counters (``resilience_*``,
``quarantines``, ``breaker_trips``, ``failed_groups``, ``batches``), the
typed errors and their RCs, the health board's states, the retry
schedules; and each failed-over group's x bit for bit the port's own
fault-free run of it (statuses, iterations and x to rtol 1e-10 against
the JAX package's).  Then the port's own: the classifier on constructed
torch exceptions (a CUDA runtime error, ``torch.cuda.OutOfMemoryError``,
a plain ``RuntimeError``), a CUDA error raised in the loop failing over,
and a loop wedged on the dispatch worker: the watchdog settles its
tickets through the requeue and later groups run on a fresh worker.
Every wait is bounded.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import amgx_tpu
from amgx_tpu.io.poisson import poisson_scipy

amgx_tpu.initialize()

RTOL = 1e-10


def _pkg(name):
    if name == "jax":
        import amgx_tpu.core.errors as errors
        import amgx_tpu.core.faults as faults
        import amgx_tpu.serve as serve
        import amgx_tpu.sessions as sessions
        import amgx_tpu.telemetry as telemetry

        kw = {}
    else:
        import amgx_tpu_torch.core.errors as errors
        import amgx_tpu_torch.core.faults as faults
        import amgx_tpu_torch.serve as serve
        import amgx_tpu_torch.sessions as sessions
        import amgx_tpu_torch.telemetry as telemetry

        kw = {"device": "cpu"}
    return types.SimpleNamespace(name=name, errors=errors, faults=faults,
                                 serve=serve, sessions=sessions,
                                 telemetry=telemetry, kw=kw)


PKGS = (_pkg("jax"), _pkg("torch"))
JAX, TORCH = PKGS


def both(fn, *args, **kwargs):
    return tuple(fn(p, *args, **kwargs) for p in PKGS)


@pytest.fixture(autouse=True)
def _clean_faults():
    for p in PKGS:
        p.faults.disarm()
        p.faults.reset_counters()
    yield
    for p in PKGS:
        p.faults.disarm()


@pytest.fixture(scope="module")
def sp8():
    sp = poisson_scipy((8, 8)).tocsr()
    sp.sort_indices()
    return sp


def _bs(sp, k=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sp.shape[0]) for _ in range(k)]


def _svc(p, **kw):
    return p.serve.BatchedSolveService(**kw, **p.kw)


def _x(r):
    x = r.x
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _group(front, sp, bs, **kw):
    ts = [front.submit(sp, b, **kw) for b in bs]
    front.flush()
    return ts


RES_COUNTERS = ("resilience_failovers", "resilience_requeue_failures",
                "resilience_watchdog_fires", "quarantines", "breaker_trips",
                "failed_groups", "batches", "resilience_device_trips")


def _counters(svc):
    return {k: svc.metrics.get(k) for k in RES_COUNTERS}


def same_x(jres, tres):
    for (js, ji, jx), (ts, ti, tx) in zip(jres, tres):
        assert (ts, ti) == (js, ji)
        np.testing.assert_allclose(tx, jx, rtol=0,
                                   atol=RTOL * np.abs(jx).max())


# ---------------------------------------------------------------------------
# the typed error and the health board


def test_device_lost_error_is_typed_cuda_failure():
    def run(p):
        e = p.errors.DeviceLostError("chip 3 gone", device_label="3")
        return (isinstance(e, p.errors.AMGXTPUError),
                isinstance(e, p.errors.ResourceError),
                p.errors.rc_for_exception(e), e.device_label)

    j, t = both(run)
    assert t == j == (True, True, TORCH.errors.RC_CUDA_FAILURE, "3")


def test_health_board_trip_probe_close():
    def run(p):
        b = p.serve.DeviceHealthBoard(3, trip_threshold=1, probe_every=4)
        out = [b.healthy_indices(), b.failure(1), b.failure(1),
               b.healthy_indices(), b.tripped_indices(),
               [b.probe_due(1) for _ in range(8)],
               any(b.probe_due(0) for _ in range(8))]
        b.ok(1)
        return out + [b.healthy_indices(), b.snapshot()]

    j, t = both(run)
    assert t == j
    assert t[5] == [False, False, False, True] * 2
    assert (t[-1]["trips"], t[-1]["probes"], t[-1]["closes"]) == (1, 2, 1)


def test_health_board_threshold_and_prefix():
    def run(p):
        b = p.serve.DeviceHealthBoard(4, trip_threshold=2)
        out = [b.failure(2), b.failure(2), b.healthy_prefix()]
        b.failure(0)
        b.failure(0)
        return out + [b.healthy_prefix(), b.snapshot()]

    j, t = both(run)
    assert t == j and t[:4] == [False, True, 2, 0]


def test_breaker_probe_cadence_config(monkeypatch):
    from amgx_tpu_torch.serve.placement.health import breaker_probe_every

    def run(p):
        f = p.serve.breaker_probe_every
        attr = ("_BREAKER_PROBE_EVERY" if p.name == "jax"
                else "breaker_probe_every")
        monkeypatch.delenv("AMGX_TPU_BREAKER_PROBE_EVERY", raising=False)
        out = [f(), f(3)]
        for raw in ("5", "junk", "0"):
            monkeypatch.setenv("AMGX_TPU_BREAKER_PROBE_EVERY", raw)
            out += [f(), f(2)]
        monkeypatch.setenv("AMGX_TPU_BREAKER_PROBE_EVERY", "5")
        out.append(getattr(_svc(p), attr))
        out.append(getattr(_svc(p, breaker_probe_every=11), attr))
        return out

    j, t = both(run)
    assert t == j == [8, 3, 5, 2, 8, 2, 8, 2, 5, 11]
    assert breaker_probe_every is TORCH.serve.breaker_probe_every


# ---------------------------------------------------------------------------
# failover at dispatch and at fetch, the watchdog


def _fault_run(p, sp, site, times=1, **svc_kw):
    """A clean group, then the same systems under ``site``: (clean
    results, faulted results or the typed errors, counters of the
    faulted run's service)."""
    bs = _bs(sp, seed=1)
    clean = [(int(r.status), int(r.iters), _x(r))
             for r in _svc(p, max_batch=2).solve_many([(sp, b)
                                                       for b in bs])]
    svc = _svc(p, max_batch=2, **svc_kw)
    with p.faults.inject(site, times):
        ts = _group(svc, sp, bs)
        out = []
        for t in ts:
            try:
                r = t.result()
                out.append((int(r.status), int(r.iters), _x(r)))
            except p.errors.AMGXTPUError as e:
                out.append(type(e).__name__)
        fired = p.faults.fired(site)
    return clean, out, _counters(svc), fired, svc


@pytest.mark.parametrize("site", ["device_lost_dispatch",
                                  "device_lost_fetch"])
def test_device_loss_requeues_bit_for_bit(sp8, site):
    """A device lost at dispatch replans and ships again (no
    quarantine, no breaker count, one batch); one lost at the fetch
    re-dispatches from the retained host copy (two batches).  x is bit
    for bit the fault-free run's, the counters the JAX package's."""
    (jc, jo, jm, jf, _), (tc, to, tm, tf, tsvc) = both(
        _fault_run, sp8, site)
    assert tf == jf == 1
    assert tm == jm
    assert tm["resilience_failovers"] == 1
    assert tm["quarantines"] == tm["breaker_trips"] == 0
    assert tm["batches"] == (1 if site == "device_lost_dispatch" else 2)
    for (cs, ci, cx), (s, i, x) in zip(tc, to):
        assert (s, i) == (cs, ci) == (0, i)
        np.testing.assert_array_equal(x, cx)
    same_x(jo, to)
    kinds = tsvc.recorder.summary()["incidents_by_kind"]
    assert kinds.get("device_failover", 0) == 1


def test_failover_disabled_settles_typed_not_wedged(sp8):
    (_, jo, jm, _, _), (_, to, tm, _, _) = both(
        _fault_run, sp8, "device_lost_fetch", failover=False)
    assert to == jo == ["DeviceLostError"] * 2
    assert tm == jm
    assert (tm["resilience_failovers"], tm["failed_groups"]) == (0, 1)


def test_watchdog_fires_and_requeue_succeeds(sp8, monkeypatch):
    # the requeue's loop runs under the watchdog too: 0.5 s leaves a
    # loaded test host room for it
    monkeypatch.setenv("AMGX_TPU_FAULT_HANG_S", "2.0")
    (jc, jo, jm, _, _), (tc, to, tm, _, _) = both(
        _fault_run, sp8, "fetch_hang", fetch_watchdog_s=0.5)
    assert tm == jm
    assert (tm["resilience_watchdog_fires"],
            tm["resilience_failovers"]) == (1, 1)
    for (cs, ci, cx), (s, i, x) in zip(tc, to):
        assert (s, i) == (cs, ci)
        np.testing.assert_array_equal(x, cx)
    same_x(jo, to)


def test_watchdog_double_hang_settles_typed_and_bounded(sp8, monkeypatch):
    monkeypatch.setenv("AMGX_TPU_FAULT_HANG_S", "3.0")

    def run(p):
        svc = _svc(p, max_batch=2, fetch_watchdog_s=0.5)
        with p.faults.inject("fetch_hang", 2):
            ts = _group(svc, sp8, _bs(sp8))
            t0 = time.perf_counter()
            errs = []
            for t in ts:
                with pytest.raises(p.errors.DeviceLostError):
                    t.result()
                errs.append("DeviceLostError")
            elapsed = time.perf_counter() - t0
        return errs, elapsed, _counters(svc)

    (je, jt, jm), (te, tt, tm) = both(run)
    assert te == je
    assert tt < 2.5  # two watchdogs of 0.5 s, not the 3 s sleeps
    assert tm == jm
    assert (tm["resilience_watchdog_fires"],
            tm["resilience_requeue_failures"]) == (2, 1)


# ---------------------------------------------------------------------------
# the classifier (torch exceptions)


def test_classifier_on_constructed_torch_exceptions():
    """A CUDA runtime error becomes an inferred DeviceLostError; an
    out-of-memory error and a plain RuntimeError stay on the typed
    generic path (None), as the JAX package's RESOURCE_EXHAUSTED."""
    from amgx_tpu_torch.core.errors import DeviceLostError
    from amgx_tpu_torch.serve.service import BatchedSolveService as S

    cuda = RuntimeError("CUDA error: an illegal memory access was "
                        "encountered")
    dl = S._classify_device_loss(cuda, "0")
    assert isinstance(dl, DeviceLostError) and dl.inferred
    assert dl.__cause__ is cuda and dl.device_label == "0"
    assert S._classify_device_loss(
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                    "allocate 2.00 GiB")) is None
    assert S._classify_device_loss(
        RuntimeError("CUDA error: out of memory")) is None
    assert S._classify_device_loss(RuntimeError("boom")) is None
    assert S._classify_device_loss(ValueError("CUDA error: x")) is None
    typed = DeviceLostError("x")
    assert S._classify_device_loss(typed) is typed
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        try:
            err = accel("CUDA error: unspecified launch failure")
        except TypeError:
            err = None
        if err is not None:
            assert S._classify_device_loss(err).inferred


@pytest.mark.parametrize("where", ["loop", "fetch"])
def test_cuda_runtime_error_classified_as_device_loss(sp8, monkeypatch,
                                                      where):
    """A CUDA runtime error in the group's loop (where the port meets a
    lost device: a norm read) or at its fetch fails over like the JAX
    package's classified XlaRuntimeError: one failover, no breaker
    count, x bit for bit the clean run's."""
    bs = _bs(sp8, seed=4)
    clean = _svc(TORCH, max_batch=2).solve_many([(sp8, b) for b in bs])
    svc = _svc(TORCH, max_batch=2)
    fired = []
    msg = "CUDA error: an illegal memory access was encountered"
    if where == "fetch":
        real = svc._watched_block

        def failing(inflight, label=None, **kw):
            if not fired:
                fired.append(1)
                raise RuntimeError(msg)
            return real(inflight, label, **kw)

        monkeypatch.setattr(svc, "_watched_block", failing)
    else:
        import amgx_tpu_torch.serve.placement.policy as policy

        real_plan = policy.SingleDevicePolicy.plan

        def plan(self, service, entry, Bb):
            p = real_plan(self, service, entry, Bb)
            fn = p.fn

            def once(*a):
                if not fired:
                    fired.append(1)
                    raise RuntimeError(msg)
                return fn(*a)

            p.fn = once
            return p

        monkeypatch.setattr(policy.SingleDevicePolicy, "plan", plan)
    res = [t.result() for t in _group(svc, sp8, bs)]
    for r, c in zip(res, clean):
        assert int(r.status) == int(c.status) == 0
        np.testing.assert_array_equal(_x(r), _x(c))
    assert svc.metrics.get("resilience_failovers") == 1
    assert svc.metrics.get("breaker_trips") == 0
    assert svc.metrics.get("quarantines") == 0


def test_device_oom_is_not_classified_as_device_loss(sp8, monkeypatch):
    """An out-of-memory error at the fetch takes the typed generic path
    (ResourceError for every groupmate, no failover), as the JAX
    package's RESOURCE_EXHAUSTED; one in the loop quarantines."""
    import amgx_tpu.serve.service as jmod
    import amgx_tpu_torch.serve.service as tmod

    class XlaRuntimeError(RuntimeError):
        pass

    def run(p, mod, exc):
        svc = _svc(p, max_batch=2)

        def oom(x):
            raise exc

        monkeypatch.setattr(mod, "_block_ready", oom)
        ts = _group(svc, sp8, _bs(sp8))
        errs = []
        for t in ts:
            with pytest.raises(p.errors.ResourceError) as ei:
                t.result()
            errs.append(type(ei.value).__name__)
        monkeypatch.undo()
        return errs, _counters(svc)

    je, jm = run(JAX, jmod, XlaRuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating buffer"))
    te, tm = run(TORCH, tmod, torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB"))
    assert te == je == ["ResourceError"] * 2
    assert tm == jm
    assert tm["resilience_failovers"] == 0


def test_keyboard_interrupt_propagates_from_failover(sp8, monkeypatch):
    def run(p):
        svc = _svc(p, max_batch=2)

        def interrupted(batch, exc):
            raise KeyboardInterrupt()

        monkeypatch.setattr(svc, "_failover_refetch", interrupted)
        with p.faults.inject("device_lost_fetch", 1):
            ts = _group(svc, sp8, _bs(sp8))
            with pytest.raises(KeyboardInterrupt):
                ts[0].result()
        return True

    assert both(run) == (True, True)


def test_wedged_dispatch_worker_gets_replaced(sp8):
    """A loop that never ends on the dispatch worker (a started
    service): the watchdog settles its tickets through the requeue
    (run off the worker, x bit for bit the clean run's), and a later
    group runs on a fresh worker while the wedged one still blocks."""
    import amgx_tpu_torch.core.dispatch as dispatch
    import amgx_tpu_torch.serve.placement.policy as policy

    bs = _bs(sp8, seed=7)
    clean = _svc(TORCH, max_batch=2).solve_many([(sp8, b) for b in bs])
    release = threading.Event()
    calls = []
    real_plan = policy.SingleDevicePolicy.plan

    def plan(self, service, entry, Bb):
        p = real_plan(self, service, entry, Bb)
        fn = p.fn

        def maybe_wedged(*a):
            calls.append(threading.current_thread().name)
            if len(calls) == 1:
                release.wait(30.0)
            return fn(*a)

        p.fn = maybe_wedged
        return p

    svc = _svc(TORCH, max_batch=2, fetch_watchdog_s=1.0)
    svc.placement.plan = types.MethodType(plan, svc.placement)
    old_pool = dispatch.dispatch_pool()
    svc.start(0.001)
    try:
        ts = _group(svc, sp8, bs)
        t0 = time.perf_counter()
        res = [t.result() for t in ts]
        assert time.perf_counter() - t0 < 10.0
        for r, c in zip(res, clean):
            np.testing.assert_array_equal(_x(r), _x(c))
        assert svc.metrics.get("resilience_watchdog_fires") == 1
        assert svc.metrics.get("resilience_failovers") == 1
        assert dispatch.dispatch_pool() is not old_pool
        # a later group: the fresh worker, not the wedged one
        ts2 = _group(svc, sp8, _bs(sp8, seed=8))
        res2 = [t.result() for t in ts2]
        assert all(int(r.status) == 0 for r in res2)
        assert calls[0].startswith("serve-dispatch")
        assert calls[1].startswith("serve-fetch")
        assert not release.is_set()
    finally:
        release.set()
        svc.stop()
    old_pool.shutdown(wait=True)
    # the wedged loop's late end settles nothing (its group requeued)
    assert svc.metrics.get("quarantines") == 0


# ---------------------------------------------------------------------------
# drains during a failover


def test_drain_during_failover_is_lossless(sp8):
    def run(p):
        svc = _svc(p, max_batch=2)
        gw = p.serve.SolveGateway(service=svc, max_inflight=32)
        with p.faults.inject("device_lost_fetch", 1):
            ts = [gw.submit(sp8, b) for b in _bs(sp8)]
            gw.flush()
            report = gw.drain(timeout_s=30.0)
        res = [(int(t.result().status), int(t.result().iters),
                _x(t.result())) for t in ts]
        return report, res, _counters(svc)

    (jr, jres, jm), (tr, tres, tm) = both(run)
    assert tr == jr
    assert (tr["timed_out"], tr["settled"]) == (0, 2)
    same_x(jres, tres)
    assert tm == jm and tm["resilience_failovers"] == 1


def test_drain_races_client_settle_during_failover(sp8, monkeypatch):
    monkeypatch.setenv("AMGX_TPU_FAULT_HANG_S", "0.8")

    def run(p):
        svc = _svc(p, max_batch=2, fetch_watchdog_s=0.2)
        gw = p.serve.SolveGateway(service=svc, max_inflight=32)
        outcomes = []
        with p.faults.inject("fetch_hang", 1):
            ts = [gw.submit(sp8, b) for b in _bs(sp8)]
            gw.flush()

            def client():
                for t in ts:
                    try:
                        outcomes.append(int(t.result().status))
                    except p.errors.AMGXTPUError:
                        outcomes.append("typed")

            th = threading.Thread(target=client)
            th.start()
            report = gw.drain(timeout_s=30.0)
            th.join(timeout=30.0)
        assert not th.is_alive()
        return (len(outcomes), report["timed_out"],
                report["settled"] + report["failed"]
                + svc.metrics.get("gateway_completed") >= 2,
                all(o == 0 or o == "typed" for o in outcomes))

    j, t = both(run)
    assert t == j == (2, 0, True, True)


# ---------------------------------------------------------------------------
# session checkpoints over a gateway


def test_session_checkpoint_cadence_and_recovery(sp8, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("AMGX_TPU_FAULT_HANG_S", "1.0")

    def run(p):
        svc = _svc(p, max_batch=4, store=str(tmp_path / p.name),
                   fetch_watchdog_s=0.2)
        gw = p.serve.SolveGateway(service=svc, max_inflight=32)
        mgr = p.sessions.SessionManager(gw, checkpoint_every=2,
                                        resetup_every=0)
        gw._session_mgr = mgr
        rng = np.random.default_rng(0)
        n = sp8.shape[0]
        base = np.asarray(sp8.data)
        sess = mgr.open(sp8, session_id="ckpt-test")
        res = []
        for k in range(5):
            t = sess.step(base * (1.0 + 0.01 * k), rng.standard_normal(n))
            gw.flush()
            r = t.result()
            res.append((int(r.status), int(r.iters), _x(r)))
        out = [sess.step_idx, mgr.telemetry_snapshot()["checkpoints_total"],
               svc.metrics.get("resilience_checkpoints")]
        with p.faults.inject("fetch_hang", 2):
            t = sess.step(base, rng.standard_normal(n))
            gw.flush()
            with pytest.raises(p.errors.DeviceLostError):
                t.result()
        out.append(sess.step_idx)
        sess2 = mgr.recover("ckpt-test")
        out += [sess2.step_idx, mgr.get("ckpt-test") is sess2]
        t = sess2.step(base, rng.standard_normal(n))
        gw.flush()
        r = t.result()
        res.append((int(r.status), int(r.iters), _x(r)))
        out += [sess2.step_idx, svc.metrics.get("resilience_restores"),
                (sess2.tenant, sess2.lane)]
        return out, res

    (jo, jr), (to, tr) = both(run)
    assert to == jo == [5, 2, 2, 6, 4, True, 5, 1, ("default",
                                                     "interactive")]
    same_x(jr, tr)


# the scenario above in a process of its own: the port cold, as a process
# that ran nothing before it (the watchdog's floor must not take the cold
# first group's seconds)
COLD_SESSION_SCRIPT = r"""
import json, os, sys
import numpy as np
from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.errors import DeviceLostError
from amgx_tpu_torch.io.poisson import poisson_scipy
from amgx_tpu_torch.serve import BatchedSolveService, SolveGateway
from amgx_tpu_torch.sessions import SessionManager

sp8 = poisson_scipy((8, 8)).tocsr()
sp8.sort_indices()
svc = BatchedSolveService(max_batch=4, store=sys.argv[1],
                          fetch_watchdog_s=0.2, device="cpu")
gw = SolveGateway(service=svc, max_inflight=32)
mgr = SessionManager(gw, checkpoint_every=2, resetup_every=0)
gw._session_mgr = mgr
rng = np.random.default_rng(0)
n = sp8.shape[0]
base = np.asarray(sp8.data)
sess = mgr.open(sp8, session_id="ckpt-test")
statuses = []
for k in range(5):
    t = sess.step(base * (1.0 + 0.01 * k), rng.standard_normal(n))
    gw.flush()
    statuses.append(int(t.result().status))
with faults.inject("fetch_hang", 2):
    t = sess.step(base, rng.standard_normal(n))
    gw.flush()
    try:
        t.result()
        outcome = "returned"
    except DeviceLostError:
        outcome = "DeviceLostError"
sess2 = mgr.recover("ckpt-test")
t = sess2.step(base, rng.standard_normal(n))
gw.flush()
statuses.append(int(t.result().status))
print(json.dumps({
    "statuses": statuses, "hang_step": outcome,
    "watchdog_fires": svc.metrics.get("resilience_watchdog_fires"),
    "watchdog_s": svc.watchdog_s(), "step_idx": sess2.step_idx,
    "restores": svc.metrics.get("resilience_restores")}))
"""


def test_session_watchdog_fires_in_a_cold_process(tmp_path):
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "AMGX_TPU_FAULT_HANG_S": "1.0",
           "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join(
               p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    env.pop("AMGX_TPU_FAULTS", None)
    proc = subprocess.run(
        [sys.executable, "-c", COLD_SESSION_SCRIPT, str(tmp_path / "store")],
        capture_output=True, text=True, timeout=120, env=env, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["hang_step"] == "DeviceLostError", out
    assert out["watchdog_fires"] >= 1, out
    assert out["statuses"] == [0] * 6
    assert (out["step_idx"], out["restores"]) == (5, 1)


def test_watchdog_reservoir_holds_warm_loop_seconds(sp8):
    """The watchdog's floor reads each warm group's loop alone: the
    first group of the batched solve stays out, and a fetch that comes
    late (here 0.3 s after the flush) lengthens the ``device`` window,
    not the watchdog's samples."""
    from amgx_tpu_torch.serve import BatchedSolveService

    svc = BatchedSolveService(max_batch=2, fetch_watchdog_s=0.2,
                              device="cpu")
    rng = np.random.default_rng(7)
    n = sp8.shape[0]
    for _ in range(3):
        ts = [svc.submit(sp8, rng.standard_normal(n)) for _ in range(2)]
        svc.flush()
        time.sleep(0.3)
        assert [int(t.result().status) for t in ts] == [0, 0]
    m = svc.metrics
    assert m.watchdog_latency.count == 2
    assert m.latency["device"].count == 6  # a sample a ticket
    assert m.watchdog_p99() < 0.3 <= m.latency_percentile("device", 50.0)
    assert svc.watchdog_s() == max(0.2, 25.0 * m.watchdog_p99())


@pytest.mark.parametrize("work", ["sleep", "spin"])
def test_cpu_loop_clock_counts_the_loop_own_work(work):
    """Off the card a loop's watchdog seconds are the smaller of its wall
    and its process's CPU seconds: time the host spends elsewhere (a
    sleep stands for it) does not count, the loop's own work does."""
    import torch

    from amgx_tpu_torch.serve.service import _run_loop

    def spin(s):
        c0 = time.process_time()
        while time.process_time() - c0 < s:
            pass

    res, event, clock = _run_loop(torch.device("cpu"),
                                  time.sleep if work == "sleep" else spin,
                                  0.3)
    assert res is None and event is None and clock[:2] == (None, None)
    if work == "sleep":
        assert clock[2] < 0.1
    else:
        assert clock[2] >= 0.3


def test_abandoned_hang_makes_no_late_wait(sp8, monkeypatch):
    """A fetch the watchdog gave up on during an injected hang does not
    wait for its group when the hang ends: nothing of it reaches the
    module's wait afterwards (a later caller's hooks stay untouched)."""
    import amgx_tpu_torch.serve.service as service_mod
    from amgx_tpu_torch.core import faults
    from amgx_tpu_torch.serve import BatchedSolveService

    monkeypatch.setenv("AMGX_TPU_FAULT_HANG_S", "1.0")
    svc = BatchedSolveService(max_batch=2, fetch_watchdog_s=0.2,
                              device="cpu")
    rng = np.random.default_rng(3)
    n = sp8.shape[0]
    for _ in range(3):
        t = svc.submit(sp8, rng.standard_normal(n))
        svc.flush()
        assert int(t.result().status) == 0
    with faults.inject("fetch_hang", 1):
        t = svc.submit(sp8, rng.standard_normal(n))
        svc.flush()
        # the group requeues once from the failover copy
        assert int(t.result().status) == 0
    assert svc.metrics.get("resilience_watchdog_fires") == 1
    waits = []
    real = service_mod._block_ready
    monkeypatch.setattr(service_mod, "_block_ready",
                        lambda x: (waits.append(1), real(x))[1])
    time.sleep(1.2)
    assert waits == []


def test_recover_without_checkpoint_keeps_live_session(sp8, tmp_path):
    def run(p):
        svc = _svc(p, max_batch=2, store=str(tmp_path / p.name))
        mgr = p.sessions.SessionManager(svc, checkpoint_every=0,
                                        resetup_every=0)
        sess = mgr.open(sp8, session_id="no-ckpt")
        t = sess.step(np.asarray(sp8.data), np.ones(sp8.shape[0]))
        svc.flush()
        t.result()
        with pytest.raises(p.errors.StoreError):
            mgr.recover("no-ckpt")
        t = sess.step(np.asarray(sp8.data), np.ones(sp8.shape[0]))
        svc.flush()
        return mgr.get("no-ckpt") is sess, sess.closed, int(
            t.result().status)

    j, t = both(run)
    assert t == j == (True, False, 0)


def test_failover_payload_released_after_settle(sp8):
    def run(p):
        svc = _svc(p, max_batch=2)
        ts = _group(svc, sp8, _bs(sp8))
        [t.result() for t in ts]
        batch = ts[0]._batch
        return batch.retry is None, batch.entry is None

    j, t = both(run)
    assert t == j == (True, True)


def test_failover_payload_is_the_staged_rows(sp8):
    """What the flush retains (failover on) is the group's batched
    values, b and x0 (None: zeros) as shipped; failover off retains
    nothing."""
    bs = _bs(sp8, k=3)
    for failover in (True, False):
        svc = _svc(TORCH, max_batch=4, failover=failover)
        ts = _group(svc, sp8, bs)
        retry = ts[0]._batch.retry
        if not failover:
            assert retry is None
            continue
        assert retry["x0"] is None
        assert retry["vals"].shape[0] == retry["bs"].shape[0] == 4
        for i, b in enumerate(bs):
            np.testing.assert_array_equal(retry["bs"][i, :len(b)], b)
        np.testing.assert_array_equal(retry["bs"][3], 0.0)
        [t.result() for t in ts]


def test_fetch_pool_workers_are_daemon(sp8):
    def run(p):
        svc = _svc(p, max_batch=2, fetch_watchdog_s=30.0)
        [t.result() for t in _group(svc, sp8, _bs(sp8))]
        workers = [th for th in threading.enumerate()
                   if th.name.startswith("serve-fetch")]
        return bool(workers) and all(th.daemon for th in workers)

    assert both(run) == (True, True)


def test_session_checkpoint_disabled(sp8, tmp_path):
    def run(p):
        svc = _svc(p, max_batch=4, store=str(tmp_path / p.name))
        mgr = p.sessions.SessionManager(svc, checkpoint_every=0,
                                        resetup_every=0)
        rng = np.random.default_rng(0)
        sess = mgr.open(sp8)
        for _ in range(3):
            t = sess.step(np.asarray(sp8.data),
                          rng.standard_normal(sp8.shape[0]))
            svc.flush()
            t.result()
        return mgr.telemetry_snapshot().get("checkpoints_total", 0)

    assert both(run) == (0, 0)


def test_session_checkpoint_env_default(monkeypatch, tmp_path):
    monkeypatch.setenv("AMGX_TPU_SESSION_CHECKPOINT_EVERY", "7")

    def run(p):
        svc = _svc(p, max_batch=2, store=str(tmp_path / p.name))
        return p.sessions.SessionManager(svc).checkpoint_every

    assert both(run) == (7, 7)


# ---------------------------------------------------------------------------
# the retry policy


def test_retry_policy_backoff_and_hints():
    def run(p):
        sleeps = []
        pol = p.serve.RetryPolicy(max_attempts=4, base_s=0.1, factor=2.0,
                                  jitter_frac=0.0, max_s=0.5, seed=0,
                                  sleep=sleeps.append)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise p.errors.Overloaded("busy", retry_after_s=None)
            return "done"

        out = [pol.call(flaky), list(sleeps), pol.retries]
        sleeps.clear()
        calls.clear()

        def hinted():
            calls.append(1)
            if len(calls) < 2:
                raise p.errors.AdmissionRejected("quota", retry_after_s=0.37)
            return "ok"

        return out + [pol.call(hinted), list(sleeps)]

    j, t = both(run)
    assert t[0] == j[0] == "done" and t[2] == j[2] == 2
    assert t[1] == pytest.approx(j[1], abs=1e-12)
    assert t[1] == pytest.approx([0.1, 0.2])
    assert t[3] == j[3] == "ok"
    assert t[4] == pytest.approx(j[4], abs=1e-12) == [0.37]


def test_retry_policy_gives_up_and_skips_nonretryable():
    def run(p):
        pol = p.serve.RetryPolicy(max_attempts=3, base_s=0.0,
                                  jitter_frac=0.0, sleep=lambda s: None)
        calls = []

        def always_shed():
            calls.append(1)
            raise p.errors.Overloaded("no capacity")

        with pytest.raises(p.errors.Overloaded):
            pol.call(always_shed)
        out = [len(calls), pol.giveups]
        calls.clear()

        def bad_input():
            calls.append(1)
            raise p.errors.SetupError("singular")

        with pytest.raises(p.errors.SetupError):
            pol.call(bad_input)
        return out + [len(calls)]

    j, t = both(run)
    assert t == j == [3, 1, 1]


def test_retry_policy_jitter_deterministic_under_seed():
    def run(p):
        a = p.serve.RetryPolicy(seed=42, sleep=lambda s: None)
        b = p.serve.RetryPolicy(seed=42, sleep=lambda s: None)
        c = p.serve.RetryPolicy(seed=7, sleep=lambda s: None)
        hinted = c.backoff_s(2, retry_after_s=0.3)
        return ([a.backoff_s(k) for k in range(4)],
                [b.backoff_s(k) for k in range(4)], hinted, a.max_s)

    (ja, jb, jh, jmax), (ta, tb, th, tmax) = both(run)
    assert ta == tb and ja == jb
    assert ta == pytest.approx(ja, abs=1e-12)
    assert th == pytest.approx(jh, abs=1e-12)
    assert all(s <= tmax for s in ta)


# ---------------------------------------------------------------------------
# telemetry


def test_resilience_prometheus_families(sp8):
    """The failover's families, from this service's own snapshot (the
    process registry also holds other tests' live services)."""
    def run(p):
        svc = _svc(p, max_batch=2)
        with p.faults.inject("device_lost_dispatch", 1):
            [t.result() for t in _group(svc, sp8, _bs(sp8))]
        prom = p.telemetry.promtext.render(
            {"svc": {"kind": "serve", "data": svc.telemetry_snapshot()}})
        fams = sorted({line.split("{")[0].split(" ")[0]
                       for line in prom.splitlines()
                       if line.startswith("amgx_resilience_")})
        kinds = svc.recorder.summary()["incidents_by_kind"]
        return fams, kinds.get("device_failover", 0) >= 1

    (jf, jk), (tf, tk) = both(run)
    assert "amgx_resilience_failovers_total" in tf
    assert tf == jf
    assert tk and jk
