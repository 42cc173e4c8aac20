"""Guardrails of the port's batched solve service against the JAX
package's on the CPU (the serve tests of ``tests/test_robustness.py``
that need no fault injection): quarantine of a poisoned group,
validation rejects, the per-fingerprint breaker and its half-open probe,
deadlines, quarantine through the cached hierarchy, and the breaker
under concurrent submits.  Each flow runs through both packages; their
ticket outcomes, statuses and iterations, x (rtol 1e-10) and counters
are held equal.
"""

import threading
import time
import warnings

import numpy as np
import pytest

import amgx_tpu
from amgx_tpu.serve import BatchedSolveService as JService
from amgx_tpu.serve.cache import CompileCache as JCompileCache
from amgx_tpu_torch.core.errors import (
    AMGXTPUError,
    DeadlineExceededError,
    NonFiniteValuesError,
    ResourceError,
)
from amgx_tpu_torch.io.poisson import poisson_scipy
from amgx_tpu_torch.serve import BatchedSolveService
from amgx_tpu_torch.serve.cache import CompileCache

amgx_tpu.initialize()

COUNTERS = ("batches", "setups", "fallback_solves", "quarantines",
            "poisoned_requests", "quarantined_solves", "breaker_trips",
            "breaker_bypasses", "breaker_closes", "breakers_open",
            "failed_groups", "deadline_expired", "validation_rejects",
            "quarantine_entry_reuses", "solved")


def counters(svc):
    snap = svc.metrics.snapshot()
    return {k: snap.get(k, 0) for k in COUNTERS}


def services(**kw):
    return (("torch", BatchedSolveService(device="cpu", **kw)),
            ("jax", JService(**kw)))


def _poisson_csr(n_side=8):
    return poisson_scipy((n_side, n_side)).tocsr()


def outcome(t):
    """("ok", status, iters, x) or ("error", typed?) of a ticket."""
    try:
        r = t.result()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("error", isinstance(e, (AMGXTPUError,
                                        amgx_tpu.core.errors.AMGXTPUError)))
    x = r.x.cpu().numpy() if hasattr(r.x, "cpu") else np.asarray(r.x)
    return ("ok", int(r.status), int(r.iters), x)


def same_outcomes(a, b):
    assert len(a) == len(b)
    for oa, ob in zip(a, b):
        assert oa[:3] == ob[:3]
        if oa[0] == "ok":
            np.testing.assert_allclose(oa[3], ob[3], rtol=0,
                                       atol=1e-10 * np.abs(ob[3]).max())


def test_quarantine_isolates_poisoned_request_as_jax():
    sp = _poisson_csr()
    n = sp.shape[0]
    got = {}
    for name, svc in services(max_batch=4, validate=False):
        rng = np.random.default_rng(0)
        bad = sp.copy()
        bad.data = bad.data.copy()
        bad.data[5] = np.nan
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tickets = [svc.submit(bad, np.ones(n))]
            for i in range(3):
                good = sp.copy()
                good.data = good.data * (1.0 + 0.1 * i)
                tickets.append(svc.submit(good, rng.standard_normal(n)))
            svc.flush()
        got[name] = ([outcome(t) for t in tickets], counters(svc))
    (to, tc), (jo, jc) = got["torch"], got["jax"]
    assert to[0] == ("error", True)
    assert all(o[0] == "ok" and o[1] == 0 for o in to[1:])
    same_outcomes(to, jo)
    assert tc == jc
    assert tc["quarantines"] == 1 and tc["poisoned_requests"] == 1
    assert tc["quarantined_solves"] == 3


def test_validation_rejects_nonfinite_as_jax():
    sp = _poisson_csr()
    bad = sp.copy()
    bad.data = bad.data.copy()
    bad.data[0] = np.inf
    got = {}
    for name, svc in services():
        with pytest.raises(Exception) as e1:
            svc.submit(bad, np.ones(sp.shape[0]))
        with pytest.raises(Exception) as e2:
            svc.submit(sp, np.full(sp.shape[0], np.nan))
        with pytest.raises(Exception) as e3:
            svc.submit(sp, np.ones(sp.shape[0]),
                       x0=np.full(sp.shape[0], np.inf))
        got[name] = ([type(e.value).__name__ for e in (e1, e2, e3)],
                     counters(svc))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ["NonFiniteValuesError"] * 3
    assert got["torch"][1]["validation_rejects"] == 3
    assert issubclass(NonFiniteValuesError, AMGXTPUError)


def test_breaker_trips_after_repeated_failures_as_jax():
    sp = _poisson_csr()
    n = sp.shape[0]
    got = {}
    for name, svc in services(max_batch=2, validate=False,
                              breaker_threshold=2):
        rng = np.random.default_rng(1)
        outs = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for _ in range(3):
                bad = sp.copy()
                bad.data = bad.data.copy()
                bad.data[0] = np.inf
                t_bad = svc.submit(bad, np.ones(n))
                t_ok = svc.submit(sp, rng.standard_normal(n))
                svc.flush()
                outs += [outcome(t_bad), outcome(t_ok)]
        got[name] = (outs, counters(svc))
    (to, tc), (jo, jc) = got["torch"], got["jax"]
    same_outcomes(to, jo)
    assert tc == jc
    assert tc["breaker_trips"] == 1 and tc["breaker_bypasses"] >= 1
    assert tc["failed_groups"] == 2


def test_deadline_expires_only_late_ticket_as_jax():
    sp = _poisson_csr()
    n = sp.shape[0]
    got = {}
    for name, svc in services(max_batch=8):
        with pytest.raises(Exception) as e:
            svc.submit(sp, np.ones(n), deadline_s=-1.0)
        assert type(e.value).__name__ == "DeadlineExceededError"
        assert svc.metrics.get("deadline_expired") == 1
        t_late = svc.submit(sp, np.ones(n), deadline_s=0.01)
        t_ok = svc.submit(sp, np.ones(n))
        time.sleep(0.05)
        svc.flush()
        got[name] = ([outcome(t_late), outcome(t_ok)], counters(svc))
    (to, tc), (jo, jc) = got["torch"], got["jax"]
    assert to[0] == ("error", True) and to[1][:2] == ("ok", 0)
    same_outcomes(to, jo)
    assert tc == jc and tc["deadline_expired"] == 2
    assert issubclass(DeadlineExceededError, ResourceError)


def test_deadline_passing_before_fetch_fails_only_that_ticket():
    sp = _poisson_csr()
    n = sp.shape[0]
    svc = BatchedSolveService(device="cpu", max_batch=2)
    t_late = svc.submit(sp, np.ones(n), deadline_s=0.05)
    t_ok = svc.submit(sp, np.ones(n))  # fills the group: it runs now
    assert t_late.done() and t_ok.done()
    time.sleep(0.1)
    with pytest.raises(DeadlineExceededError):
        t_late.result()
    with pytest.raises(DeadlineExceededError):  # sticky
        t_late.result()
    assert int(t_ok.result().status) == 0
    assert svc.metrics.get("deadline_expired_fetch") == 1


def test_quarantine_reuses_cached_hierarchy_as_jax(monkeypatch):
    """A group failure after a healthy build re-solves its members
    through the cached entry (a values-only resetup), not a new setup
    each."""
    sp = _poisson_csr()
    n = sp.shape[0]

    def boom(self, entry, Bb):
        raise RuntimeError("injected compile-path failure")

    got = {}
    for name, svc in services(max_batch=4):
        cls = CompileCache if name == "torch" else JCompileCache
        rng = np.random.default_rng(3)
        res = svc.solve_many([(sp, rng.standard_normal(n))
                              for _ in range(3)])
        assert all(int(r.status) == 0 for r in res)
        setups = svc.metrics.get("setups")
        monkeypatch.setattr(cls, "get", boom)
        tickets = [svc.submit(sp, rng.standard_normal(n))
                   for _ in range(3)]
        svc.flush()
        got[name] = ([outcome(t) for t in tickets], counters(svc))
        monkeypatch.setattr(cls, "get", _REAL[name])
        assert svc.metrics.get("setups") == setups
    (to, tc), (jo, jc) = got["torch"], got["jax"]
    same_outcomes(to, jo)
    assert tc == jc
    assert tc["quarantines"] == 1 and tc["quarantine_entry_reuses"] == 3


_REAL = {"torch": CompileCache.get, "jax": JCompileCache.get}


def test_concurrent_submit_while_breaker_trips(monkeypatch):
    """Threads submit while every batched attempt of the pattern fails:
    the breaker trips once, every ticket settles with a correct
    solution or a typed error, the counters stay consistent, and once
    the fault clears a half-open probe closes the breaker."""
    import sys

    sp = _poisson_csr()
    n = sp.shape[0]
    svc = BatchedSolveService(device="cpu", max_batch=4,
                              breaker_threshold=2)
    assert all(int(r.status) == 0 for r in svc.solve_many(
        [(sp, np.ones(n) * (i + 1)) for i in range(2)]))

    def boom(self, entry, Bb):
        raise RuntimeError("forced batched-solve failure")

    monkeypatch.setattr(CompileCache, "get", boom)
    n_threads, per_thread = 6, 4
    results, errors = {}, []
    lock = threading.Lock()

    def hammer(tid):
        rng = np.random.default_rng(100 + tid)
        for k in range(per_thread):
            b = rng.standard_normal(n)
            try:
                t = svc.submit(sp, b)
                svc.flush()
                res = t.result()
            except AMGXTPUError as e:
                with lock:
                    errors.append(e)
            except BaseException as e:  # noqa: BLE001 — must not happen
                with lock:
                    errors.append(AssertionError(f"untyped: {e!r}"))
            else:
                with lock:
                    results[(tid, k)] = (b, res)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not [e for e in errors if isinstance(e, AssertionError)]
    assert len(results) + len(errors) == n_threads * per_thread
    for b, res in results.values():
        assert int(res.status) == 0
        x = res.x.numpy()
        assert np.linalg.norm(sp @ x - b) < 1e-6 * np.linalg.norm(b)
    snap = svc.metrics.snapshot()
    assert snap["breaker_trips"] == 1 and snap["breakers_open"] == 1
    assert snap["failed_groups"] >= svc.breaker_threshold
    assert (snap["failed_groups"] + snap["breaker_bypasses"]
            <= n_threads * per_thread)
    monkeypatch.setattr(CompileCache, "get", _REAL["torch"])
    closed = False
    for _ in range(2 * svc.breaker_probe_every):
        t = svc.submit(sp, np.ones(n))
        svc.flush()
        assert int(t.result().status) == 0
        if svc.metrics.get("breaker_closes") == 1:
            closed = True
            break
    assert closed and svc.metrics.get("breakers_open") == 0


def test_malformed_request_fails_alone():
    sp = _poisson_csr()
    n = sp.shape[0]
    svc = BatchedSolveService(device="cpu", max_batch=4)
    t_ok = svc.submit(sp, np.ones(n))
    with pytest.raises(ValueError):
        svc.submit(sp, np.ones(n + 1))
    svc.flush()
    assert int(t_ok.result().status) == 0
