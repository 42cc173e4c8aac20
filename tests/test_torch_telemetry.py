"""Telemetry of the PyTorch port (``amgx_tpu_torch.telemetry``, the rest
of ``core/profiling.py``, the serve metrics' latency stages) against the
JAX package's, on the CPU: the scenarios of ``tests/test_telemetry.py``
that need no gateway.

Held equal between the packages: the Prometheus family names and label
sets of a direct solve, a served group, a session manager and a store
(the port adds one counter, ``pattern_hashes``); the solver aggregate's
solves, iterations, reductions and cycle passes; the span names of a
sampled ticket's chain and of a session step's; the flight recorder's
records and incidents; ``solver_telemetry_json``'s keys; the keys of
``profile_cycle``.  Then the port's own contracts: deterministic
sampling, bounded rings, ``telemetry_export`` degrading to a count with
results bit for bit those of a run with telemetry off, telemetry off
recording nothing, dead components dropping out, the exposition
grammar.
"""

import gc
import json
import re
import warnings

import numpy as np
import pytest
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu import telemetry as jtel
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core import faults as jfaults
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu.serve import BatchedSolveService as JService
from amgx_tpu.sessions import SessionManager as JManager
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu.telemetry import promtext as jprom
from amgx_tpu_torch import telemetry as ttel
from amgx_tpu_torch.core import faults as tfaults
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.serve import BatchedSolveService as TService
from amgx_tpu_torch.sessions import SessionManager as TManager
from amgx_tpu_torch.telemetry import promtext as tprom
from amgx_tpu_torch.telemetry import tracing

amgx_tpu.initialize()

AMG_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-8,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_2",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}, "min_coarse_rows": 8,'
    ' "max_iters": 1, "monitor_residual": 0}}}'
)
STEP_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 300, "tolerance": 1e-6,'
    ' "monitor_residual": 1, "convergence": "ABSOLUTE",'
    ' "preconditioner": {"scope": "jac", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.9, "max_iters": 2,'
    ' "monitor_residual": 0}}}'
)
# the port's counter without a JAX counterpart (sessions' values-only
# submits hash no pattern: ROADMAP.md, queue C)
PORT_ONLY = {"amgx_serve_pattern_hashes_total"}


@pytest.fixture(autouse=True)
def _clean():
    import copy

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    for f in (jfaults, tfaults):
        f.disarm()
    # the JAX package's solver aggregate is process-wide: the timed JAX
    # solves here must not leave it filled for a later test of the
    # process (tests/test_telemetry.py reads its histogram families)
    jreg = jtel.get_registry()
    with jreg._solver_lock:
        saved = copy.deepcopy(jreg._solver_stats)
    yield
    with jreg._solver_lock:
        jreg._solver_stats.clear()
        jreg._solver_stats.update(saved)
    for f in (jfaults, tfaults):
        f.disarm()
    for tr in (tracing, jtel.tracing):
        tr.set_sample_rate(None)
        tr.clear()
    ttel.set_telemetry_enabled(None)
    jtel.set_telemetry_enabled(None)
    torch.set_num_threads(prev)


@pytest.fixture()
def traced():
    for tr in (tracing, jtel.tracing):
        tr.set_sample_rate(1.0)
        tr.clear()


@pytest.fixture(scope="module")
def sysmat():
    sp = poisson_scipy((8, 8)).tocsr()
    sp.sort_indices()
    return sp


def _rhs(n, count, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(count)]


def _group(svc, sp, bs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = [svc.submit(sp, b) for b in bs]
        svc.flush()
        return [t.result() for t in ts]


def _services(sysmat, cfg=None, n_req=4):
    """(JAX service, port service), each after one group of n_req."""
    bs = _rhs(sysmat.shape[0], n_req)
    j = JService(config=cfg, max_batch=n_req)
    t = TService(config=cfg, max_batch=n_req, device="cpu")
    return j, t, _group(j, sysmat, bs), _group(t, sysmat, bs)


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{[a-zA-Z0-9_]+=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z0-9_]+=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" (-?[0-9.e+-]+|NaN)$"
)


def _families(prom, kind, snap):
    """{family: {frozenset of label names}} of one rendered component."""
    text = prom.render({"c": {"kind": kind, "data": snap}})
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        assert m, line
        labels = frozenset(re.findall(r'([a-zA-Z0-9_]+)="', m.group(2)
                                      or ""))
        out.setdefault(m.group(1), set()).add(labels)
    return out


def _same_families(kind, jsnap, tsnap, port_only=frozenset()):
    fj = _families(jprom, kind, jsnap)
    ft = _families(tprom, kind, tsnap)
    assert set(ft) - set(fj) <= port_only, sorted(set(ft) - set(fj))
    assert set(fj) <= set(ft), sorted(set(fj) - set(ft))
    for name in fj:
        assert fj[name] == ft[name], name
    return ft


# ----------------------------------------------------------------------
# the Prometheus catalog, through both packages


@pytest.mark.parametrize("cfg", [None, AMG_CFG], ids=["default", "amg"])
def test_serve_families_and_labels_as_jax(sysmat, cfg):
    j, t, jr, tr = _services(sysmat, cfg)
    for a, b in zip(jr, tr):
        assert (int(a.status), int(a.iters)) == (b.status, b.iters)
    ft = _same_families("serve", j.telemetry_snapshot(),
                        t.telemetry_snapshot(), PORT_ONLY)
    assert "amgx_cache_hierarchy_bytes" in ft
    assert "amgx_serve_ticket_latency_seconds" in ft
    if cfg is not None:
        assert "amgx_setup_phase_seconds_total" in ft


def _timed(pkg, cfg, sp, b):
    cfg = cfg.replace('"monitor_residual": 1,',
                      '"monitor_residual": 1, "obtain_timings": 1,', 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if pkg == "jax":
            s = j_create(JConfig.from_string(cfg), "default")
            s.setup(JMatrix.from_scipy(sp))
        else:
            s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                                device="cpu")
            s.setup(TMatrix.from_scipy(sp, device="cpu"))
        return s, s.solve(b)


SOLVERS = {
    "BLOCK_JACOBI": (
        '{"config_version": 2, "solver": {"scope": "m",'
        ' "solver": "BLOCK_JACOBI", "monitor_residual": 1,'
        ' "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
        ' "max_iters": 500, "relaxation_factor": 0.9}}'),
    "PCG": STEP_CFG,
    "PCG-amg": AMG_CFG,
    "SSTEP_PCG": STEP_CFG.replace('"PCG"', '"SSTEP_PCG", "s_step": 2'),
    "AMG": (
        '{"config_version": 2, "solver": {"scope": "amg", "solver":'
        ' "AMG", "algorithm": "AGGREGATION", "selector": "SIZE_2",'
        ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
        ' "monitor_residual": 0}, "min_coarse_rows": 8,'
        ' "max_iters": 50, "tolerance": 1e-8, "monitor_residual": 1,'
        ' "convergence": "RELATIVE_INI"}}'),
}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_direct_solve_aggregate_as_jax(sysmat, name):
    """obtain_timings feeds the solver aggregate: solves, iterations
    (inner-step equivalents), reductions and cycle passes as the JAX
    package's, the same families and labels, and a direct flight
    record."""
    b = _rhs(sysmat.shape[0], 1)[0]
    out = {}
    for pkg, tel in (("jax", jtel), ("torch", ttel)):
        reg = tel.get_registry()
        before = dict(reg._solver_snapshot())
        rec = tel.registry.default_recorder()
        n_rec = rec.records_total
        s, res = _timed(pkg, SOLVERS[name], sysmat, b)
        after = reg._solver_snapshot()[s.registry_name]
        prev = before.get(s.registry_name, {})
        delta = {k: after[k] - prev.get(k, 0) for k in (
            "solves", "iterations", "reductions", "cycle_passes")}
        assert rec.records_total == n_rec + 1
        last = rec.records()[-1]
        assert (last.path, last.lane, last.iterations) == (
            "direct", "direct", int(res.iters))
        out[pkg] = (delta, {s.registry_name: after})
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0]["solves"] == 1
    if name == "AMG":
        assert out["torch"][0]["cycle_passes"] > 0
    _same_families("solvers", out["jax"][1], out["torch"][1])


def test_reductions_per_iteration_as_jax(sysmat):
    """The per-iteration count itself, cached per setup."""
    for name in ("BLOCK_JACOBI", "PCG", "SSTEP_PCG"):
        js, _ = _timed("jax", SOLVERS[name], sysmat,
                       np.ones(sysmat.shape[0]))
        ts, _ = _timed("torch", SOLVERS[name], sysmat,
                       np.ones(sysmat.shape[0]))
        assert ts.reductions_per_iteration() == \
            js.reductions_per_iteration(), name
        assert "reductions_per_iteration" in ts._cache


def _heat(nx=8, dt=2.0):
    base = poisson_scipy((nx, nx)).tocsr()
    base.sort_indices()
    n = base.shape[0]
    rid = np.repeat(np.arange(n), np.diff(base.indptr))
    dpos = np.flatnonzero(rid == base.indices)

    def values(k):
        v = dt * (1.0 + 0.02 * np.sin(0.4 * k)) * base.data.copy()
        v[dpos] += 1.0 + dt * 0.5
        return v

    import scipy.sparse as sps

    A0 = sps.csr_matrix((values(0), base.indices, base.indptr),
                        shape=base.shape)
    A0.sort_indices()
    return A0, values, np.ones(n)


def _stream(mgr, steps=3, sessions=2):
    A0, values, f = _heat()
    ss = [mgr.open(A0, session_id=f"s{i}") for i in range(sessions)]
    out = []
    for k in range(steps):
        ts = mgr.step_all([(s, values(k), (k + 1 + i) * f)
                           for i, s in enumerate(ss)])
        out += [t.result() for t in ts]
    return ss, out


def test_session_source_and_flight_records_as_jax():
    """The sessions source's families, labels and counts, and one
    ``session_step`` flight record a resolved step, as the JAX
    package's; the port's ``counters()`` stays beside it."""
    tm = TManager(TService(config=STEP_CFG, max_batch=4, device="cpu"))
    jm = JManager(JService(config=STEP_CFG, max_batch=4))
    _, tres = _stream(tm)
    _, jres = _stream(jm)
    for a, b in zip(jres, tres):
        assert (int(a.status), int(a.iters)) == (b.status, b.iters)
    tsnap, jsnap = tm.telemetry_snapshot(), jm.telemetry_snapshot()
    _same_families("sessions", jsnap, tsnap)
    for k, v in jsnap.items():
        if not isinstance(v, float):
            assert tsnap[k] == v, k
    assert {k: v for k, v in tm.counters().items()} == {
        k: v for k, v in tsnap.items()
        if k != "resetup_overlap_seconds_total"}
    assert tsnap["resetup_overlap_seconds_total"] == 0.0
    trecs = [r for r in tm.service.recorder.records()
             if r.path == "session_step"]
    jrecs = [r for r in jm.service.recorder.records()
             if r.path == "session_step"]
    assert [r.iterations for r in trecs] == [r.iterations for r in jrecs]
    assert len(trecs) == 6
    assert tm.telemetry_name in ttel.get_registry().components()


def test_store_source_as_jax(tmp_path):
    from amgx_tpu.store import ArtifactStore as JStore
    from amgx_tpu_torch.store import ArtifactStore as TStore

    snaps = []
    for Store, sub in ((JStore, "j"), (TStore, "t")):
        st = Store(tmp_path / sub)
        arrays = {"a": np.arange(4.0)}
        assert st.put("k1", arrays, {"kind": "test"})
        st.get("k1")
        st.get("missing")
        snaps.append(st.telemetry_snapshot())
        assert st.telemetry_name in (
            jtel if Store is JStore else ttel).get_registry().components()
    assert snaps[1] == snaps[0]
    _same_families("store", snaps[0], snaps[1])


def test_prometheus_grammar_of_the_registry(sysmat, tmp_path):
    """The whole page of the port's registry: every sample parses,
    every family has HELP and TYPE, and the serve, cache, store,
    solver and session sources are on it."""
    from amgx_tpu_torch.store import ArtifactStore

    keep = [_services(sysmat)[1], ArtifactStore(tmp_path),
            TManager(TService(device="cpu"))]
    _timed("torch", SOLVERS["PCG"], sysmat, np.ones(sysmat.shape[0]))
    text = ttel.get_registry().render_prometheus()
    names, helped, typed = set(), set(), set()
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            helped.add(line.split()[2])
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            assert parts[3] in ("counter", "gauge", "summary")
            typed.add(parts[2])
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        names.add(m.group(1))
    for n in names:
        # a summary's _count / _max samples belong to its family
        fam = next((f for f in (n, n[:-6], n[:-4]) if f in typed), None)
        assert fam is not None and fam in helped, n
    assert len(names) >= 25
    for prefix in ("amgx_serve_", "amgx_store_", "amgx_cache_",
                   "amgx_solver_", "amgx_session_", "amgx_trace_",
                   "amgx_telemetry_errors_total"):
        assert any(n.startswith(prefix) for n in names), prefix
    del keep


def test_label_escaping_and_names():
    assert tprom.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
    assert tprom.sanitize_name("setup:host csr") == "setup:host_csr"


# ----------------------------------------------------------------------
# tracing


def _chains(spans):
    """{trace_id: set of span names} and the flush_group spans."""
    chains: dict = {}
    for s in spans:
        if s["trace_id"] is not None:
            chains.setdefault(s["trace_id"], set()).add(s["name"])
    return chains, [s for s in spans if s["name"] == "flush_group"]


def test_span_chains_as_jax(sysmat, traced, tmp_path):
    """A sampled ticket's chain is submit -> pad -> queue -> dispatch ->
    device -> fetch in both packages, connected by parent ids; one
    flush_group span names the group's members; the Chrome export
    loads back."""
    _services(sysmat, n_req=3)
    tch, tgroups = _chains(tracing.span_buffer().spans())
    jch, jgroups = _chains(jtel.tracing.span_buffer().spans())
    assert len(tch) == len(jch) == 3
    assert sorted(map(sorted, tch.values())) == sorted(
        map(sorted, jch.values()))
    # serve_submit: the trace_range around the row write
    assert set(next(iter(tch.values()))) == {
        "submit", "pad", "queue", "dispatch", "device", "fetch",
        "serve_submit"}
    assert len(tgroups) == len(jgroups) == 1
    assert set(tgroups[0]["args"]["members"]) == set(tch)
    out = tmp_path / "trace.json"
    trace = tracing.export_chrome(str(out))
    assert json.loads(out.read_text())["traceEvents"] == trace[
        "traceEvents"]
    ids = {}
    for ev in trace["traceEvents"]:
        assert ev["ph"] == "X" and ev["ts"] >= 0 and ev["dur"] >= 0
        ids.setdefault(ev["args"]["trace_id"], set()).add(
            ev["args"]["span_id"])
    for ev in trace["traceEvents"]:
        if "parent_id" in ev["args"]:
            assert ev["args"]["parent_id"] in ids[ev["args"]["trace_id"]]


def test_session_step_spans_as_jax(traced):
    tm = TManager(TService(config=STEP_CFG, max_batch=4, device="cpu"))
    jm = JManager(JService(config=STEP_CFG, max_batch=4))
    _stream(tm, steps=2)
    _stream(jm, steps=2)
    tch, _ = _chains(tracing.span_buffer().spans())
    jch, _ = _chains(jtel.tracing.span_buffer().spans())
    assert len(tch) == len(jch) == 4
    assert sorted(map(sorted, tch.values())) == sorted(
        map(sorted, jch.values()))
    assert "session_step" in next(iter(tch.values()))
    roots = [s for s in tracing.span_buffer().spans()
             if s["name"] == "session_step"]
    assert all(s["args"]["session"] in ("s0", "s1") for s in roots)


def test_setup_phases_and_ranges_share_the_timeline(sysmat, traced):
    _services(sysmat, AMG_CFG, n_req=2)
    names = {s["name"] for s in tracing.span_buffer().spans()}
    assert any(n.startswith("setup:") for n in names), names
    assert {"pad", "serve_submit", "serve_batch_dispatch"} <= names


def test_sampling_zero_records_nothing(sysmat):
    tracing.set_sample_rate(0.0)
    tracing.clear()
    _services(sysmat, n_req=2)
    assert len(tracing.span_buffer()) == 0
    assert tracing.export_chrome()["traceEvents"] == []


def test_fractional_sampling_is_deterministic():
    for tr in (tracing, jtel.tracing):
        tr.set_sample_rate(0.25)
    got = [[c is not None for c in (tr.new_trace() for _ in range(40))]
           for tr in (tracing, jtel.tracing)]
    assert sum(got[0]) == 10
    # every 4th mint, phase set by the process's mint count
    first = got[0].index(True)
    assert got[0] == [(i - first) % 4 == 0 for i in range(40)]


def test_span_and_flight_rings_are_bounded():
    buf = tracing.SpanBuffer(cap=8)
    for i in range(20):
        buf.add({"name": f"s{i}", "sid": i, "t0": 0.0, "t1": 1.0,
                 "tid": 0, "trace_id": None})
    assert len(buf) == 8 and buf.total == 20
    assert [s["name"] for s in buf.spans()] == [f"s{i}"
                                                 for i in range(12, 20)]
    rec = ttel.FlightRecorder(cap=4, incident_cap=2)
    for i in range(10):
        rec.record(fingerprint=f"f{i}", config="c", lane="l", tenant="t",
                   iterations=i, final_residual=0.0, status=0, stages={})
    assert rec.records_total == 10
    assert [r.iterations for r in rec.records()] == [6, 7, 8, 9]
    for i in range(5):
        rec.incident(f"k{i % 2}", detail=str(i))
    assert rec.incidents_total == 5
    assert [i["detail"] for i in rec.incidents()] == ["3", "4"]


# ----------------------------------------------------------------------
# the flight recorder of a service


def test_flight_records_of_a_group_as_jax(sysmat):
    j, t, jr, tr = _services(sysmat, n_req=3)
    trecs, jrecs = t.recorder.records(), j.recorder.records()
    assert len(trecs) == len(jrecs) == 3
    for a, b in zip(jrecs, trecs):
        assert (b.iterations, b.status, b.path, b.config) == (
            a.iterations, a.status, a.path, t.cfg_key)
        assert b.fingerprint == a.fingerprint
        assert set(b.stages) == set(a.stages)
        assert (b.lane, b.tenant) == (a.lane, a.tenant)
        json.dumps(b.to_dict())
    lat = t.metrics.snapshot()["latency"]
    assert all(lat[s]["count"] == 3 for s in lat)
    assert t.metrics.snapshot()["tenant_device_s"]["default"][
        "interactive"] > 0
    assert set(t.metrics.snapshot()["tenant_device_s"]) == set(
        j.metrics.snapshot()["tenant_device_s"])


def test_incident_on_forced_quarantine_as_jax(sysmat):
    """serve_compile forces a quarantine: an incident with the metrics
    snapshot, quarantine flight records, in both packages."""
    bs = _rhs(sysmat.shape[0], 2, seed=5)
    got = {}
    for name, svc, f in (("jax", JService(max_batch=2), jfaults),
                         ("torch", TService(max_batch=2, device="cpu"),
                          tfaults)):
        with f.inject("serve_compile", times=1):
            _group(svc, sysmat, bs)
        incs = svc.recorder.incidents()
        kinds = [i["kind"] for i in incs]
        q = incs[kinds.index("quarantine")]
        assert q["snapshot"] is not None
        got[name] = (kinds, [r.path for r in svc.recorder.records()],
                     svc.recorder.summary()["incidents_by_kind"])
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == ["quarantine", "quarantine"]


def test_breaker_and_deadline_incidents(sysmat):
    import scipy.sparse as sps

    from amgx_tpu_torch.core.errors import DeadlineExceededError

    svc = TService(max_batch=2, breaker_threshold=1, device="cpu")
    with tfaults.inject("serve_compile", times=1):
        _group(svc, sysmat, _rhs(sysmat.shape[0], 2))
    with pytest.raises(DeadlineExceededError):
        svc.submit(sysmat, np.ones(sysmat.shape[0]), deadline_s=0.0)
    kinds = svc.recorder.summary()["incidents_by_kind"]
    assert kinds == {"quarantine": 1, "breaker_trip": 1,
                     "deadline_expired": 1}
    del sps


@pytest.mark.parametrize("path", ["served", "direct", "session"])
def test_telemetry_export_degrades_and_changes_no_bit(sysmat, path):
    """telemetry_export armed unlimited: every record and incident
    fails into a count, and the results are bit for bit a run's with
    telemetry off."""
    def run():
        if path == "served":
            svc = TService(max_batch=2, device="cpu")
            res = _group(svc, sysmat, _rhs(sysmat.shape[0], 2))
            return [r.x for r in res], svc
        if path == "direct":
            s, res = _timed("torch", SOLVERS["PCG-amg"], sysmat,
                            _rhs(sysmat.shape[0], 1)[0])
            return [res.x], s
        mgr = TManager(TService(config=STEP_CFG, max_batch=4,
                                device="cpu"))
        _, res = _stream(mgr, steps=2)
        return [r.x for r in res], mgr.service

    ttel.set_telemetry_enabled(False)
    xs_off, _ = run()
    ttel.set_telemetry_enabled(None)
    tfaults.reset_counters()
    with tfaults.inject("telemetry_export", times=-1):
        xs_on, owner = run()
    for a, b in zip(xs_off, xs_on):
        assert torch.equal(a, b)
    assert tfaults.fired("telemetry_export") > 0
    if path != "direct":
        # a session step's batched record and its session_step record
        lost = len(xs_on) * (2 if path == "session" else 1)
        assert owner.metrics.get("telemetry_errors") == lost
        assert owner.recorder.records_total == 0


def test_telemetry_off_records_nothing(sysmat):
    ttel.set_telemetry_enabled(False)
    reg = ttel.get_registry()
    before = reg._solver_snapshot().get("PCG", {}).get("solves", 0)
    j, t, jr, tr = _services(sysmat, n_req=2)
    _timed("torch", SOLVERS["PCG"], sysmat, np.ones(sysmat.shape[0]))
    assert t.recorder.records_total == 0
    assert reg._solver_snapshot().get("PCG", {}).get("solves", 0) == before


# ----------------------------------------------------------------------
# the registry


def test_registry_drops_dead_components():
    reg = ttel.get_registry()
    svc = TService(max_batch=2, device="cpu")
    name = svc.telemetry_name
    assert name in reg.snapshot()
    del svc
    gc.collect()
    assert name not in reg.snapshot()


def test_registry_failure_degrades_and_dumps(tmp_path, sysmat):
    reg = ttel.TelemetryRegistry()

    def bad():
        raise RuntimeError("broken source")

    reg.register("serve", bad, name="bad")
    snap = reg.snapshot()
    assert "bad" not in snap and reg.telemetry_errors == 1
    # the page collects again: a second failure, counted on the page
    assert "amgx_telemetry_errors_total 2" in reg.render_prometheus()
    keep = _services(sysmat, n_req=2)[1]
    path = tmp_path / "telemetry.json"
    assert ttel.get_registry().dump(str(path)) is True
    payload = json.loads(path.read_text())
    kinds = {v["kind"] for v in payload["snapshot"].values()}
    assert {"serve", "tracing", "solvers"} <= kinds
    with tfaults.inject("telemetry_export", times=1):
        assert ttel.get_registry().dump(str(path)) is False
    del keep


# ----------------------------------------------------------------------
# the C API


@pytest.mark.parametrize("call", ["solver_get_telemetry",
                                  "solver_telemetry_json"])
def test_capi_telemetry_as_jax(sysmat, call):
    """AMGX_solver_get_telemetry / telemetry_json: the same keys as the
    JAX package's after a direct and a batched solve; the JSON parses."""
    from amgx_tpu.api import capi as J
    from amgx_tpu_torch.api import capi as C

    n = sysmat.shape[0]
    got = {}
    for name, api in (("jax", J), ("torch", C)):
        api.initialize()
        try:
            cfg = api.config_create(STEP_CFG)
            res = api.resources_create_simple(cfg)
            A = api.matrix_create(res, "hDDI")
            api.matrix_upload_all(A, n, sysmat.nnz, 1, 1,
                                  sysmat.indptr.astype(np.int32),
                                  sysmat.indices.astype(np.int32),
                                  sysmat.data)
            vb, vx = (api.vector_create(res, "hDDI"),
                      api.vector_create(res, "hDDI"))
            api.vector_upload(vb, n, 1, np.ones(n))
            api.vector_set_zero(vx, n, 1)
            slv = api.solver_create(res, "hDDI", cfg)
            api.solver_setup(slv, A)
            assert api.solver_solve(slv, vb, vx) == api.RC_OK
            assert api.solver_solve_batch(slv, [A, A], [vb, vb],
                                          [vx, vx]) == api.RC_OK
            out = getattr(api, call)(slv)
            if call == "solver_telemetry_json":
                out = json.loads(out)
            got[name] = out
        finally:
            api.finalize()
    t, j = got["torch"], got["jax"]
    assert set(t) == set(j)
    assert set(t["solver"]) == set(j["solver"])
    assert t["solver"]["setup_s"] > 0 and t["solver"]["solve_s"] >= 0
    assert set(t["flight"]) == set(j["flight"])
    assert len(t["flight"]["records"]) == len(j["flight"]["records"])
    assert "serve" in {v["kind"] for v in t["registry"].values()}


# ----------------------------------------------------------------------
# profiling


def test_profile_cycle_keys_as_jax(sysmat):
    """profile_cycle's per-level phases carry the JAX package's keys,
    each called once, with positive times."""
    from amgx_tpu.core.profiling import profile_cycle as jprofile
    from amgx_tpu_torch.core.profiling import profile_cycle

    big = poisson_scipy((16, 16)).tocsr()
    b = _rhs(big.shape[0], 1)[0]
    js = j_create(JConfig.from_string(AMG_CFG), "default")
    js.setup(JMatrix.from_scipy(big))
    ts = T.create_solver(T.AMGConfig.from_string(AMG_CFG), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(big, device="cpu"))
    jp = jprofile(js.precond, b, reps=1)
    tp = profile_cycle(ts.precond, torch.from_numpy(b), reps=2)
    assert set(tp.times) == set(jp.times)
    assert len(ts.precond.levels) >= 2
    assert all(v > 0 for v in tp.times.values())
    assert set(tp.counts.values()) == {1}
    assert "level0/smooth_pre" in tp.table()


def test_latency_reservoir_and_percentile_as_jax():
    from amgx_tpu.core import profiling as jp
    from amgx_tpu_torch.core import profiling as tp

    xs = list(np.random.default_rng(0).random(50))
    for q in (0, 25, 50, 99, 100):
        assert tp.percentile(xs, q) == jp.percentile(xs, q)
    assert tp.percentile([], 50) is None
    jr, tr = jp.LatencyReservoir(cap=16), tp.LatencyReservoir(cap=16)
    for x in xs:
        jr.add(x)
        tr.add(x)
    assert tr.summary() == jr.summary()
    lp = tp.LevelProfile()
    with lp.phase("a"):
        pass
    lp.add("a", 1.0)
    assert lp.snapshot()["counts"] == {"a": 2}


def test_trace_range_is_a_record_function_and_a_span(traced):
    from amgx_tpu_torch.core.profiling import named_scope, trace_range

    with trace_range("AMGX_probe"):
        pass
    assert [s["name"] for s in tracing.span_buffer().spans()] == [
        "AMGX_probe"]
    tracing.set_sample_rate(0.0)
    assert isinstance(trace_range("x"), torch.profiler.record_function)
    with torch.profiler.profile() as prof:
        with named_scope("amg_l0_smooth"):
            torch.ones(4).sum()
    assert any(e.key == "amg_l0_smooth" for e in prof.key_averages())
