"""The gateway of the PyTorch port (``amgx_tpu_torch.serve.gateway``,
``serve/admission.py``, the service's priority lanes) against the JAX
package's, on the CPU: the scenarios of ``tests/test_fleet.py`` through
both packages on the same seeded inputs (Poisson 8 x 8, f64).

Held equal: admission decisions and ``retry_after_s`` (to 1e-12) on a
scripted clock (``TokenBucket(clock=...)``, the controller's clock set
before its first bucket) and seeded p99 reservoirs; the sheds, their
reasons and the ``gateway_*`` / ``shed_*`` / ``batch_deferrals`` /
``batch_promotions`` counters; the flush order of the lanes and the
aging (groups aged by moving their creation time back, never by
sleeping); statuses and iterations, and x to rtol 1e-10 of its largest
entry; the drain's report and the replacement's warm boot; the C API's
RCs and per-system statuses under ``AMGX_TPU_CAPI_ADMISSION``; the
placement specs; the Prometheus family names of the same traffic.  No
decision that depends on measured time is compared.  Every wait is
bounded.
"""

import asyncio
import types

import numpy as np
import pytest

import amgx_tpu
from amgx_tpu.io.poisson import poisson_scipy

amgx_tpu.initialize()

RTOL = 1e-10


def _pkg(name):
    """The modules of one package: ``serve``, ``errors``, ``admission``,
    ``profiling``, ``capi`` and the service's device keyword."""
    if name == "jax":
        import amgx_tpu.api.capi as capi
        import amgx_tpu.core.errors as errors
        import amgx_tpu.core.profiling as profiling
        import amgx_tpu.serve as serve
        import amgx_tpu.serve.admission as admission
        import amgx_tpu.serve.placement as placement
        import amgx_tpu.telemetry.promtext as promtext

        kw = {}
    else:
        import amgx_tpu_torch.api.capi as capi
        import amgx_tpu_torch.core.errors as errors
        import amgx_tpu_torch.core.profiling as profiling
        import amgx_tpu_torch.serve as serve
        import amgx_tpu_torch.serve.admission as admission
        import amgx_tpu_torch.serve.placement as placement
        import amgx_tpu_torch.telemetry.promtext as promtext

        kw = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, serve=serve, errors=errors, admission=admission,
        profiling=profiling, placement=placement, capi=capi,
        promtext=promtext, kw=kw)


PKGS = (_pkg("jax"), _pkg("torch"))


def both(fn, *args, **kwargs):
    """``fn(pkg, ...)`` for the JAX package, then the port: (jax, torch)."""
    return tuple(fn(p, *args, **kwargs) for p in PKGS)


@pytest.fixture(scope="module")
def sysmat():
    sp = poisson_scipy((8, 8)).tocsr()
    sp.sort_indices()
    return sp


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _gw(p, **kw):
    return p.serve.SolveGateway(**kw, **p.kw)


def _svc(p, **kw):
    return p.serve.BatchedSolveService(**kw, **p.kw)


def _res(r):
    """(status, iterations, x) of a SolveResult, x a host array."""
    x = r.x
    x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    return int(r.status), int(r.iters), x


def same_results(jres, tres):
    assert len(jres) == len(tres)
    for (js, ji, jx), (ts, ti, tx) in zip(jres, tres):
        assert (ts, ti) == (js, ji)
        np.testing.assert_allclose(tx, jx, rtol=0,
                                   atol=RTOL * np.abs(jx).max())


def _shed(e):
    return (type(e).__name__, e.reason, e.retry_after_s)


def _counters(m, *names):
    return {k: m.get(k) for k in names}


GW_COUNTERS = ("gateway_admitted", "gateway_completed", "gateway_sheds",
               "gateway_typed_failures", "gateway_untyped_failures",
               "shed_quota", "shed_overloaded", "shed_deadline_unmeetable",
               "shed_breaker_open", "shed_device_budget", "shed_draining",
               "batch_deferrals", "batch_promotions")


# ---------------------------------------------------------------------------
# the percentiles the shed predictor reads


def test_percentile_empty_returns_none():
    def run(p):
        res = p.profiling.LatencyReservoir()
        s = res.summary()
        return (p.profiling.percentile([], 50.0),
                p.profiling.percentile([], 99.0), res.percentile(50.0),
                res.percentile(99.0), s["p50_s"], s["p99_s"], s["count"])

    j, t = both(run)
    assert t == j == (None, None, None, None, 0.0, 0.0, 0)


def test_percentile_single_sample_is_every_percentile():
    def run(p):
        res = p.profiling.LatencyReservoir()
        res.add(0.125)
        out = (p.profiling.percentile([0.25], 1.0),
               p.profiling.percentile([0.25], 99.0), res.percentile(50.0),
               res.percentile(99.0))
        res.clear()
        return out + (res.percentile(99.0),)

    j, t = both(run)
    assert t == j == (0.25, 0.25, 0.125, 0.125, None)


def test_shed_predictor_admits_on_missing_percentile(sysmat):
    cases = [(0.001, None), (None, 5.0), (0.1, 0.5), (1.0, 0.5)]

    def run(p):
        out = [p.admission.can_meet_deadline(d, q) for d, q in cases]
        gw = _gw(p, max_batch=4)
        out.append(gw.predicted_p99_s())
        t = gw.submit(sysmat, _rhs(sysmat.shape[0]), deadline_s=10.0)
        gw.flush()
        return out, [_res(t.result())]

    (jo, jr), (to, tr) = both(run)
    assert to == jo == [True, True, False, True, None]
    same_results(jr, tr)


# ---------------------------------------------------------------------------
# token buckets and quotas, on a scripted clock


def test_token_bucket_refill_and_retry_hint():
    def run(p):
        clock = [0.0]
        b = p.admission.TokenBucket(rate=10.0, burst=2.0,
                                    clock=lambda: clock[0])
        out = [b.try_take(), b.try_take(), b.try_take()]
        clock[0] += 0.1
        out.append(b.try_take())
        clock[0] += 1000.0
        out += [b.try_take(), b.try_take(), b.try_take(), b.tokens]
        return out

    j, t = both(run)
    assert len(t) == len(j)
    for a, b in zip(j, t):
        assert b == pytest.approx(a, rel=0, abs=1e-12)
    assert t[2] == pytest.approx(0.1) and t[6] > 0.0


def test_zero_rate_bucket_hint_is_capped(sysmat):
    def run(p):
        gw = _gw(p, max_batch=4, retry_after_cap_s=5.0,
                 quotas={"frozen": p.admission.TenantQuota(rate=0.0,
                                                           burst=1.0)})
        n = sysmat.shape[0]
        t = gw.submit(sysmat, _rhs(n), tenant="frozen")
        with pytest.raises(p.errors.AdmissionRejected) as ei:
            gw.submit(sysmat, _rhs(n), tenant="frozen")
        gw.flush()
        return _shed(ei.value), [_res(t.result())]

    (js, jr), (ts, tr) = both(run)
    assert ts == js == ("AdmissionRejected", "quota", 5.0)
    same_results(jr, tr)


def test_tenant_quota_isolates_tenants(sysmat):
    """One tenant exhausting its bucket sheds it alone; the hint is the
    refill time on the scripted clock, equal in both packages."""
    def run(p):
        clock = [10.0]
        gw = _gw(p, max_batch=8,
                 quotas={"greedy": p.admission.TenantQuota(rate=5.0,
                                                           burst=1.0)})
        gw.admission._clock = lambda: clock[0]
        n = sysmat.shape[0]
        t1 = gw.submit(sysmat, _rhs(n, 1), tenant="greedy")
        clock[0] += 0.05
        with pytest.raises(p.errors.AdmissionRejected) as ei:
            gw.submit(sysmat, _rhs(n, 2), tenant="greedy")
        t2 = gw.submit(sysmat, _rhs(n, 3), tenant="other")
        gw.flush()
        res = [_res(t1.result()), _res(t2.result())]
        snap = gw.telemetry_snapshot()
        return (_shed(ei.value), res, _counters(gw.metrics, *GW_COUNTERS),
                snap["tenants"])

    (js, jr, jc, jt), (ts, tr, tc, tt) = both(run)
    assert ts[:2] == js[:2] == ("AdmissionRejected", "quota")
    assert ts[2] == pytest.approx(js[2], rel=0, abs=1e-12)
    assert ts[2] == pytest.approx(0.15, abs=1e-12)
    same_results(jr, tr)
    assert tc == jc and tc["shed_quota"] == 1 and tc["gateway_sheds"] == 1
    assert tt == jt


def test_device_budget_post_paid_controller():
    def run(p):
        clock = [0.0]
        ctl = p.admission.AdmissionController(
            quotas={"big": p.admission.TenantQuota(
                rate=1e9, burst=1e9, device_seconds_rate=0.5,
                device_seconds_burst=1.0)},
            clock=lambda: clock[0])
        ctl.admit(tenant="big")
        ctl.release()
        ctl.charge_device_seconds("big", 2.0)
        with pytest.raises(p.errors.AdmissionRejected) as ei:
            ctl.admit(tenant="big")
        out = [_shed(ei.value), ctl.inflight]
        clock[0] += 2.0
        ctl.admit(tenant="big")
        ctl.release()
        ctl.charge_device_seconds("other", 100.0)
        ctl.admit(tenant="other")
        ctl.release()
        return out, ctl.snapshot()

    (jo, js), (to, ts) = both(run)
    assert to[0][:2] == jo[0][:2] == ("AdmissionRejected", "device_budget")
    assert to[0][2] == pytest.approx(jo[0][2], rel=0, abs=1e-12)
    assert to[0][2] == pytest.approx(2.0)
    assert to[1] == jo[1] == 0
    assert ts == js


def test_device_budget_enforced_end_to_end(sysmat):
    """A vanishing device-seconds budget: the first group solves
    (post-paid), its measured device time is charged at the fetch, and
    the tenant is then shed typed; another tenant still serves."""
    def run(p):
        n = sysmat.shape[0]
        gw = _gw(p, max_batch=4, retry_after_cap_s=30.0,
                 quotas={"big": p.admission.TenantQuota(
                     rate=1e9, burst=1e9, device_seconds_rate=1e-9,
                     device_seconds_burst=1e-9)})
        ts = [gw.submit(sysmat, _rhs(n, i), tenant="big") for i in range(4)]
        gw.flush()
        res = [_res(t.result()) for t in ts]
        with pytest.raises(p.errors.AdmissionRejected) as ei:
            gw.submit(sysmat, _rhs(n, 9), tenant="big")
        debt = gw.telemetry_snapshot()["tenant_device_tokens"]["big"]
        t = gw.submit(sysmat, _rhs(n, 10), tenant="small")
        gw.flush()
        res.append(_res(t.result()))
        return (ei.value.reason, 0.0 < ei.value.retry_after_s <= 30.0,
                debt < 0.0, res, _counters(gw.metrics, *GW_COUNTERS))

    j, t = both(run)
    assert t[:3] == j[:3] == ("device_budget", True, True)
    same_results(j[3], t[3])
    assert t[4] == j[4]


# ---------------------------------------------------------------------------
# the concurrency budget and the lanes


def test_overload_typed_with_retry_hint_and_release(sysmat):
    def run(p):
        n = sysmat.shape[0]
        gw = _gw(p, max_batch=4, max_inflight=2,
                 interactive_reserve_frac=0.0)
        t1 = gw.submit(sysmat, _rhs(n, 1))
        t2 = gw.submit(sysmat, _rhs(n, 2))
        with pytest.raises(p.errors.Overloaded) as ei:
            gw.submit(sysmat, _rhs(n, 3))
        rc = p.errors.rc_for_exception(ei.value)
        gw.flush()
        res = [_res(t1.result()), _res(t2.result())]
        inflight = gw.admission.inflight
        t3 = gw.submit(sysmat, _rhs(n, 4))
        gw.flush()
        res.append(_res(t3.result()))
        return (_shed(ei.value), rc, inflight, res,
                _counters(gw.metrics, *GW_COUNTERS))

    j, t = both(run)
    assert t[0] == j[0] == ("Overloaded", "overloaded", 0.05)
    assert t[1] == j[1] == PKGS[1].errors.RC_NO_MEMORY
    assert t[2] == j[2] == 0
    same_results(j[3], t[3])
    assert t[4] == j[4]


def test_batch_lane_sheds_before_interactive(sysmat):
    def run(p):
        n = sysmat.shape[0]
        gw = _gw(p, max_batch=8, max_inflight=4,
                 interactive_reserve_frac=0.5)
        sheds, tickets = [], []
        for i, lane in enumerate(["batch", "batch", "batch", "interactive",
                                  "interactive", "interactive"]):
            try:
                tickets.append(gw.submit(sysmat, _rhs(n, i), lane=lane))
            except p.errors.Overloaded as e:
                sheds.append((i, lane, e.reason))
        gw.flush()
        return (gw.admission.batch_budget, sheds,
                [_res(t.result()) for t in tickets],
                _counters(gw.metrics, *GW_COUNTERS))

    j, t = both(run)
    assert t[0] == j[0] == 2
    assert t[1] == j[1] == [(2, "batch", "overloaded"),
                            (5, "interactive", "overloaded")]
    same_results(j[2], t[2])
    assert t[3] == j[3] and t[3]["shed_overloaded"] == 2


def _spy_order(p, monkeypatch):
    order = []
    cls = p.serve.BatchedSolveService
    orig = cls._execute_group

    def spy(self, grp, wait_dispatch=True):
        order.append(grp.lane)
        return orig(self, grp, wait_dispatch)

    monkeypatch.setattr(cls, "_execute_group", spy)
    return order


def _age(svc, ticket, seconds):
    """Move a queued ticket's group ``seconds`` into the past: its
    creation (the aging credit) and its max-wait deadline."""
    grp = svc._groups[ticket._group_key]
    grp.created -= seconds
    grp.deadline -= seconds


def test_interactive_preempts_batch_at_flush(sysmat, monkeypatch):
    """Interactive groups flush before batch groups; a batch group
    passed over for the aging window is promoted and flushes first
    (oldest deadline), counted once."""
    def run(p):
        n = sysmat.shape[0]
        order = _spy_order(p, monkeypatch)
        svc = _svc(p, max_batch=8, max_wait_s=0.001)
        tb = svc.submit(sysmat, _rhs(n, 1), lane="batch")
        ti = svc.submit(sysmat, _rhs(n, 2), lane="interactive")
        svc.flush()
        first = list(order)
        res = [_res(tb.result()), _res(ti.result())]
        order.clear()
        tb2 = svc.submit(sysmat, _rhs(n, 3), lane="batch")
        _age(svc, tb2, svc.max_wait_s * svc._BATCH_AGING_FACTOR + 1.0)
        ti2 = svc.submit(sysmat, _rhs(n, 4), lane="interactive")
        svc.flush()
        res += [_res(tb2.result()), _res(ti2.result())]
        snap = svc.metrics.snapshot()
        return (first, list(order), svc.metrics.get("batch_promotions"),
                res, {k: v["count"] for k, v in snap["lanes"].items()})

    j, t = both(run)
    assert t[0] == j[0] == ["interactive", "batch"]
    assert t[1] == j[1] == ["batch", "interactive"]
    assert t[2] == j[2] == 1
    same_results(j[3], t[3])
    assert t[4] == j[4] == {"interactive": 2, "batch": 2}


def test_poll_defers_batch_until_aging_promotes(sysmat, monkeypatch):
    """While an interactive group is due, a due batch group waits for a
    later poll (``batch_deferrals``); once aged past the credit it
    promotes and flushes under continued interactive pressure."""
    def run(p):
        n = sysmat.shape[0]
        order = _spy_order(p, monkeypatch)
        svc = _svc(p, max_batch=8, max_wait_s=0.01)
        tb = svc.submit(sysmat, _rhs(n, 1), lane="batch")
        ti1 = svc.submit(sysmat, _rhs(n, 2), lane="interactive")
        _age(svc, tb, 0.02)
        _age(svc, ti1, 0.02)
        svc.poll()
        deferred = (svc.metrics.get("batch_deferrals"), tb.done(),
                    list(order))
        res = [_res(ti1.result())]
        _age(svc, tb, svc.max_wait_s * svc._BATCH_AGING_FACTOR)
        ti2 = svc.submit(sysmat, _rhs(n, 3), lane="interactive")
        _age(svc, ti2, 0.02)
        svc.poll()
        res += [_res(tb.result()), _res(ti2.result())]
        return (deferred, svc.metrics.get("batch_promotions"), list(order),
                res)

    j, t = both(run)
    assert t[0] == j[0] == (1, False, ["interactive"])
    assert t[1] == j[1] == 1
    assert t[2] == j[2] == ["interactive", "batch", "interactive"]
    same_results(j[3], t[3])


# ---------------------------------------------------------------------------
# deadlines


def test_deadline_shed_when_p99_says_unmeetable(sysmat):
    def run(p):
        n = sysmat.shape[0]
        gw = _gw(p, max_batch=4)
        for _ in range(8):
            gw.metrics.latency["total"].add(0.5)
        p99 = gw.predicted_p99_s()
        with pytest.raises(p.errors.AdmissionRejected) as ei:
            gw.submit(sysmat, _rhs(n), deadline_s=0.05)
        t = gw.submit(sysmat, _rhs(n), deadline_s=5.0)
        gw.flush()
        return (p99, _shed(ei.value), [_res(t.result())],
                gw.metrics.get("shed_deadline_unmeetable"))

    j, t = both(run)
    assert t[0] == pytest.approx(j[0], rel=0, abs=1e-12)
    assert t[1][:2] == j[1][:2] == ("AdmissionRejected",
                                    "deadline_unmeetable")
    assert t[1][2] == pytest.approx(j[1][2], rel=0, abs=1e-12)
    assert t[1][2] == pytest.approx(0.5)
    same_results(j[2], t[2])
    assert t[3] == j[3] == 1


def test_expired_deadline_rejected_at_submit(sysmat):
    def run(p):
        svc = _svc(p, max_batch=4)
        with pytest.raises(p.errors.DeadlineExceededError):
            svc.submit(sysmat, _rhs(sysmat.shape[0]), deadline_s=0.0)
        return svc.metrics.get("deadline_expired"), svc.metrics.get(
            "submitted")

    j, t = both(run)
    assert t == j == (1, 0)


def test_late_fetch_short_circuits_typed(sysmat):
    """A ticket whose deadline passes before its group was fetched
    fails typed (sticky); a groupmate without a deadline fetches."""
    def run(p):
        n = sysmat.shape[0]
        svc = _svc(p, max_batch=8)
        t_late = svc.submit(sysmat, _rhs(n, 1), deadline_s=30.0)
        t_ok = svc.submit(sysmat, _rhs(n, 2))
        svc.flush()
        t_late._deadline -= 60.0  # passed, without a sleep
        errs = []
        for _ in range(2):
            with pytest.raises(p.errors.DeadlineExceededError) as ei:
                t_late.result()
            errs.append(type(ei.value).__name__)
        return (errs, svc.metrics.get("deadline_expired_fetch"),
                [_res(t_ok.result())])

    j, t = both(run)
    assert t[0] == j[0] and t[1] == j[1] == 1
    same_results(j[2], t[2])


# ---------------------------------------------------------------------------
# the breaker at the door


def _break(p, svc, sp):
    """Open the breaker of ``sp``'s padded pattern in ``svc``."""
    ro, ci, vals, nn, raw_fp = p.serve.service._host_csr(sp)
    pat = svc._pattern_for(ro, ci, nn, raw_fp)
    svc._broken.add(pat.fingerprint)
    return pat.fingerprint


def test_breaker_open_sheds_at_admission(sysmat):
    def run(p):
        n = sysmat.shape[0]
        gw = _gw(p, max_batch=4)
        svc = gw.service
        fp = _break(p, svc, sysmat)
        with pytest.raises(p.errors.AdmissionRejected) as ei:
            gw.submit(sysmat, _rhs(n))
        gw2 = p.serve.SolveGateway(svc, shed_broken=False)
        t = gw2.submit(sysmat, _rhs(n))
        gw2.flush()
        res = [_res(t.result())]
        svc._broken.discard(fp)
        return (_shed(ei.value), res,
                _counters(svc.metrics, "shed_breaker_open",
                          "breaker_bypasses", "quarantined_solves"))

    j, t = both(run)
    assert t[0][:2] == j[0][:2] == ("AdmissionRejected", "breaker_open")
    assert t[0][2] == pytest.approx(j[0][2], rel=0, abs=1e-12)
    same_results(j[1], t[1])
    assert t[2] == j[2] and t[2]["shed_breaker_open"] == 1


def test_breaker_door_admits_half_open_probe(sysmat):
    def run(p):
        n = sysmat.shape[0]
        gw = _gw(p, max_batch=4)
        svc = gw.service
        fp = _break(p, svc, sysmat)
        every = (svc._BREAKER_PROBE_EVERY if p.name == "jax"
                 else svc.breaker_probe_every)
        probe, sheds, held = None, 0, 0
        for i in range(every):
            try:
                probe = gw.submit(sysmat, _rhs(n, i))
            except p.errors.AdmissionRejected:
                sheds += 1
        for i in range(3):
            try:
                gw.submit(sysmat, _rhs(n, 50 + i))
            except p.errors.AdmissionRejected:
                held += 1
        gw.flush()
        res = [_res(probe.result())]
        closed = fp not in svc._broken
        t2 = gw.submit(sysmat, _rhs(n, 99))
        gw.flush()
        res.append(_res(t2.result()))
        return (every, sheds, held, closed, res,
                _counters(svc.metrics, "breaker_closes", *GW_COUNTERS))

    j, t = both(run)
    assert t[:4] == j[:4] == (8, 7, 3, True)
    same_results(j[4], t[4])
    assert t[5] == j[5] and t[5]["breaker_closes"] == 1


# ---------------------------------------------------------------------------
# the drain, health and the asyncio face


def test_drain_completes_tickets_exports_and_stops_admission(sysmat,
                                                            tmp_path):
    def run(p):
        n = sysmat.shape[0]
        store = str(tmp_path / p.name)
        gw = _gw(p, max_batch=8, store=store)
        ts = [gw.submit(sysmat, _rhs(n, i)) for i in range(4)]
        report = gw.drain(timeout_s=30.0)
        res = [_res(t.result()) for t in ts]
        with pytest.raises(p.errors.Overloaded) as ei:
            gw.submit(sysmat, _rhs(n, 9))
        again = gw.drain()
        svc2 = _svc(p, max_batch=8, store=store)
        restored = svc2.warm_boot(wait=True)
        t = svc2.submit(sysmat, _rhs(n, 11))
        svc2.flush()
        res.append(_res(t.result()))
        return (gw.state, report, again == report, _shed(ei.value),
                restored >= 1, res, svc2.metrics.get("setups"),
                svc2.metrics.get("cache_hits") >= 1)

    j, t = both(run)
    assert t[0] == j[0] == "drained"
    assert t[1] == j[1]
    assert t[1]["settled"] == 4 and t[1]["exported"] >= 1
    assert t[2:5] == j[2:5]
    assert t[3] == ("Overloaded", "draining", 1.0)
    same_results(j[5], t[5])
    assert t[6:] == j[6:] == (0, True)


def test_health_snapshot(sysmat):
    def run(p):
        gw = _gw(p, max_batch=4, max_inflight=16)
        h0 = gw.health()
        t = gw.submit(sysmat, _rhs(sysmat.shape[0]), lane="interactive")
        gw.flush()
        t.result()
        h1 = gw.health()
        return h0, h1

    (j0, j1), (t0, t1) = both(run)
    assert set(t0) == set(j0) and set(t1) == set(j1)
    assert "device_health" not in t1
    for key in ("state", "inflight", "max_inflight", "admitted",
                "completed", "sheds", "typed_failures", "untyped_failures",
                "interactive_p99_s", "batch_p99_s"):
        if key.endswith("_p99_s"):
            assert (t0[key] is None) == (j0[key] is None), key
            assert (t1[key] is None) == (j1[key] is None), key
        else:
            assert (t0[key], t1[key]) == (j0[key], j1[key]), key
    assert t1["interactive_p99_s"] > 0.0


def test_async_solve_roundtrip(sysmat):
    b = _rhs(sysmat.shape[0], 3)

    def run(p):
        async def go():
            gw = _gw(p, max_batch=4, max_wait_s=0.002)
            gw.start()
            try:
                res = await asyncio.wait_for(gw.solve(
                    sysmat, b, tenant="web", lane="interactive",
                    deadline_s=30.0), timeout=60.0)
                for _ in range(4):
                    gw.metrics.latency["total"].add(1.0)
                with pytest.raises(p.errors.AdmissionRejected) as ei:
                    await gw.solve(sysmat, b, deadline_s=0.001)
                return [_res(res)], ei.value.reason
            finally:
                gw.stop()

        return asyncio.run(go())

    (jr, jreason), (tr, treason) = both(run)
    same_results(jr, tr)
    assert treason == jreason == "deadline_unmeetable"


# ---------------------------------------------------------------------------
# a gateway's traffic: sheds, counters, results and telemetry


def test_gateway_traffic_as_jax(sysmat):
    """Two tenants, two lanes, a quota and the budget on one gateway:
    the same sheds (reason, tenant, order), counters, flight records'
    lanes and tenants, results, and Prometheus family names."""
    from tests.test_torch_telemetry import _families

    def run(p):
        n = sysmat.shape[0]
        clock = [0.0]
        gw = _gw(p, max_batch=8, max_inflight=6,
                 interactive_reserve_frac=0.5,
                 quotas={"a": p.admission.TenantQuota(rate=1.0, burst=3.0)})
        gw.admission._clock = lambda: clock[0]
        tickets, sheds = [], []
        plan = [("a", "batch")] * 5 + [("b", "interactive")] * 5
        for i, (tenant, lane) in enumerate(plan):
            try:
                tickets.append(gw.submit(sysmat, _rhs(n, i), tenant=tenant,
                                         lane=lane))
            except p.errors.AdmissionRejected as e:
                sheds.append((i, tenant, lane) + _shed(e))
        gw.flush()
        res = [_res(t.result()) for t in tickets]
        recs = sorted((r.lane, r.tenant) for r in
                      gw.service.recorder.records())
        snap = gw.telemetry_snapshot()
        fams = _families(p.promtext, "gateway", snap)
        sfams = _families(p.promtext, "serve", gw.service.telemetry_snapshot())
        return (sheds, res, _counters(gw.metrics, *GW_COUNTERS), recs,
                snap["tenants"], sorted(snap["tenant_device_s"]),
                fams, {k: v for k, v in sfams.items()
                       if k.startswith(("amgx_gateway", "amgx_serve_lane"))})

    j, t = both(run)
    assert t[0] == j[0]
    assert [s[4] for s in t[0]] == ["quota", "quota", "overloaded",
                                    "overloaded"]
    same_results(j[1], t[1])
    assert t[2] == j[2]
    assert t[3] == j[3]
    assert t[4] == j[4]
    assert t[5] == j[5]
    assert t[6] == j[6]
    assert t[7] == j[7]


# ---------------------------------------------------------------------------
# placement specs


@pytest.mark.parametrize("spec", ["", "single", " single ", "mesh",
                                  "mesh:2", "mesh:4:shared", "affinity",
                                  "distributed", "distributed:2:sstep",
                                  "mesh:0", "mesh:x", "distributed:-1",
                                  "distributed:y", "ring"])
def test_parse_placement_as_jax(spec, monkeypatch):
    """Single-device specs give the default policy; the multi-device
    specs parse as the JAX package's and raise NotImplementedError
    (queue A.9); malformed ones raise the same ValueError, also through
    ``AMGX_TPU_PLACEMENT``."""
    from amgx_tpu.serve.placement import parse_placement as jparse
    from amgx_tpu_torch.serve.placement import (
        parse_placement,
        placement_from_env,
    )

    try:
        jpol = jparse(spec)
        jerr = None
    except ValueError as e:
        jerr = str(e)
    except Exception as e:  # noqa: BLE001 — a multi-device policy that
        # cannot build on this host still parsed
        jpol, jerr = None, None
        assert not isinstance(e, ValueError) or "device" in str(e)
    if jerr is not None:
        with pytest.raises(ValueError) as ei:
            parse_placement(spec)
        assert str(ei.value) == jerr
        monkeypatch.setenv("AMGX_TPU_PLACEMENT", spec)
        with pytest.raises(ValueError):
            placement_from_env()
        return
    if spec.strip() in ("", "single"):
        assert parse_placement(spec).name == jpol.name == "single"
        return
    with pytest.raises(NotImplementedError, match=r"A\.9"):
        parse_placement(spec)


# ---------------------------------------------------------------------------
# the C API's admission front


_CAPI_CFG = (
    '{"config_version": 2, "solver": {"scope": "m",'
    ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-8,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI"}}'
)


def _capi_systems(capi, sysmat, count):
    capi.initialize()
    cfg = capi.config_create(_CAPI_CFG)
    res_h = capi.resources_create_simple(cfg)
    n = sysmat.shape[0]
    mh, rh, sh = [], [], []
    for i in range(count):
        m = capi.matrix_create(res_h, "hDDI")
        capi.matrix_upload_all(m, n, sysmat.nnz, 1, 1,
                               sysmat.indptr.astype(np.int32),
                               sysmat.indices.astype(np.int32), sysmat.data)
        r = capi.vector_create(res_h, "hDDI")
        capi.vector_upload(r, n, 1, _rhs(n, i))
        x = capi.vector_create(res_h, "hDDI")
        capi.vector_set_zero(x, n, 1)
        mh.append(m)
        rh.append(r)
        sh.append(x)
    slv = capi.solver_create(res_h, "hDDI", cfg)
    return slv, mh, rh, sh


@pytest.mark.parametrize("budget", [1, 3])
def test_shed_rc_mapping_and_capi_batch(sysmat, monkeypatch, budget):
    """Sheds carry RC_NO_MEMORY; an admission-fronted batch returns
    RC_OK with the shed systems FAILED, as in the JAX package."""
    def run(p):
        e = p.errors
        rcs = (e.rc_for_exception(e.Overloaded("x")),
               e.rc_for_exception(e.AdmissionRejected(
                   "x", retry_after_s=1.0)),
               e.rc_for_exception(e.DeviceLostError("x")),
               "overloaded" in p.capi.get_error_string(e.RC_NO_MEMORY))
        monkeypatch.setenv("AMGX_TPU_CAPI_ADMISSION", str(budget))
        slv, mh, rh, sh = _capi_systems(p.capi, sysmat, 5)
        rc = p.capi.solver_solve_batch(slv, mh, rh, sh)
        statuses = [p.capi.solver_get_batch_status(slv, i)
                    for i in range(5)]
        iters = [p.capi.solver_get_batch_iterations_number(slv, i)
                 for i in range(5)]
        xs = [np.asarray(p.capi.vector_download(h)) for h in sh]
        return rcs, rc, statuses, iters, xs

    j, t = both(run)
    assert t[0] == j[0] == (7, 7, 5, True)
    assert t[1] == j[1] == 0
    assert t[2] == j[2]
    assert t[2].count(0) == budget and t[2].count(1) == 5 - budget
    assert t[3] == j[3]
    for tx, jx in zip(t[4], j[4]):
        np.testing.assert_allclose(tx, jx, rtol=0,
                                   atol=RTOL * max(np.abs(jx).max(), 1.0))


def test_capi_admission_rejects_nonpositive_budget(sysmat, monkeypatch):
    def run(p):
        slv, mh, rh, sh = _capi_systems(p.capi, sysmat, 1)
        rcs = []
        for bad in ("0", "-4", "x", "0"):
            monkeypatch.setenv("AMGX_TPU_CAPI_ADMISSION", bad)
            with pytest.raises(p.capi.AMGXError) as ei:
                p.capi.solver_solve_batch(slv, mh, rh, sh)
            rcs.append(ei.value.rc)
        monkeypatch.setenv("AMGX_TPU_CAPI_ADMISSION", "4")
        monkeypatch.setenv("AMGX_TPU_PLACEMENT", "mesh:zero")
        with pytest.raises(p.capi.AMGXError) as ei:
            p.capi.solver_solve_batch(slv, mh, rh, sh)
        rcs.append(ei.value.rc)
        monkeypatch.delenv("AMGX_TPU_PLACEMENT")
        rcs.append(p.capi.solver_solve_batch(slv, mh, rh, sh))
        rcs.append(p.capi.solver_get_batch_status(slv, 0))
        s = p.capi._get(slv, p.capi._SolverHandle)
        rcs.append(type(s.batch_gateway).__name__)
        return rcs

    j, t = both(run)
    bad = PKGS[1].errors.RC_BAD_CONFIGURATION
    assert t == j == [bad] * 5 + [0, 0, "SolveGateway"]


def test_capi_session_steps_through_the_gateway(sysmat, monkeypatch):
    """``solver_session_create`` under AMGX_TPU_CAPI_ADMISSION: each step
    is admitted as one ticket, with the JAX package's statuses,
    iterations and x."""
    def run(p):
        monkeypatch.setenv("AMGX_TPU_CAPI_ADMISSION", "2")
        slv, mh, rh, sh = _capi_systems(p.capi, sysmat, 1)
        sess = p.capi.solver_session_create(slv, mh[0])
        out = []
        for k in range(3):
            assert p.capi.solver_session_step(sess, mh[0], rh[0],
                                              sh[0]) == 0
            p.capi.solver_session_sync(sess)
            out.append((p.capi.solver_session_get_status(sess),
                        p.capi.solver_session_get_iterations_number(sess),
                        np.asarray(p.capi.vector_download(sh[0]))))
        s = p.capi._get(slv, p.capi._SolverHandle)
        return out, s.batch_gateway.metrics.get("gateway_admitted")

    (jo, ja), (to, ta) = both(run)
    assert ta == ja == 3
    for (ts, ti, tx), (js, ji, jx) in zip(to, jo):
        assert (ts, ti) == (js, ji)
        np.testing.assert_allclose(tx, jx, rtol=0,
                                   atol=RTOL * np.abs(jx).max())
