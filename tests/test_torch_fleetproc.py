"""The multi-process fleet of the PyTorch port on the CPU: real
``python -m amgx_tpu_torch.fleet.worker --device cpu`` subprocesses driven
through the port's :class:`~amgx_tpu_torch.fleet.frontend.FleetFrontend`
(the scenarios of ``tests/test_fleetproc.py``).

A module-scoped two-worker fleet (the services' default configuration,
as the JAX package's fleet tests) serves the read-only tests: a solve
held to the JAX package's in-process ``SolveGateway`` on the same system
(status and iterations equal, x to rtol 1e-10 in f64), the JAX
package's frontend on the port's workers, cross-process affinity, a
typed error and a garbage connection that leave the worker
serving, health and metrics over the wire, the ``amgx_fleet_*``
families and the C API's ``AMGX_TPU_FLEET`` front.  The rolling restart
and kill -9 spawn their own workers, with an AMG configuration (the
launcher below passes it to the worker's ``main``), and hold the port to
its own contract: every admitted ticket settles, the drained worker
exits with 0, the replacement warm-boots, and its first repeat
fingerprint is a hierarchy-cache hit with no setup and no coarsening;
after a kill -9 every ticket is requeued to the survivor or settles
with a typed ``DeviceLostError``, and the survivor still serves.  A
worker without ``--device`` refuses to start on a machine without a
card.  Every wait is bounded.
"""

import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import amgx_tpu
from amgx_tpu.io.poisson import poisson_scipy

from amgx_tpu_torch.core.errors import (
    AMGXTPUError,
    DeviceLostError,
    NonFiniteValuesError,
)
from amgx_tpu_torch.fleet import wire
from amgx_tpu_torch.fleet.frontend import FleetFrontend
from amgx_tpu_torch.fleet.lifecycle import FleetSupervisor

amgx_tpu.initialize()

pytestmark = pytest.mark.serve

RTOL = 1e-10
SPAWN_TIMEOUT_S = 120.0
WAIT_S = 120.0
# two threads a worker: the tests run beside other xdist workers
WORKER_ENV = {"OMP_NUM_THREADS": "2"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# PCG over an aggregation AMG V-cycle (the restart's evidence counts its
# coarsening); structure reuse on every level, as the batch needs
AMG_CFG = (
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


class AmgSupervisor(FleetSupervisor):
    """Workers of the port's ``fleet.worker.main`` with AMG_CFG."""

    worker_cmd = (sys.executable, "-c",
                  "import sys; from amgx_tpu_torch.fleet.worker import main; "
                  f"sys.exit(main(sys.argv[1:], config={AMG_CFG!r}))")


def _mat(shape=(8, 8)):
    sp = poisson_scipy(shape).tocsr()
    sp.sort_indices()
    return sp


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _check(A, b, res, tol=1e-6):
    x = res.x.numpy()
    rel = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    assert int(res.status) == 0 and rel < tol, f"relative residual {rel}"


def _spawn_fleet(n, root, cls=FleetSupervisor):
    env = dict(WORKER_ENV)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    sup = cls(os.path.join(root, "registry"), os.path.join(root, "store"),
              env=env, spawn_timeout_s=SPAWN_TIMEOUT_S,
              worker_args=["--device", "cpu", "--max-batch", "8"])
    records = sup.launch(n)
    front = FleetFrontend(register_telemetry=False)
    for rec in records:
        front.attach(rec)
    return sup, front, records


@pytest.fixture(scope="module")
def fleet2():
    tmp = tempfile.mkdtemp(prefix="torch_fleetproc_")
    try:
        sup, front, records = _spawn_fleet(2, tmp)
        try:
            yield sup, front, records
        finally:
            front.close()
            sup.terminate_all()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# end to end


def test_solve_matches_jax_gateway_and_affinity(fleet2):
    from amgx_tpu.serve import SolveGateway

    _sup, front, _records = fleet2
    A1, A2 = _mat((8, 8)), _mat((9, 9))
    b1, b2 = _rhs(A1.shape[0], 1), _rhs(A2.shape[0], 2)
    r1 = front.solve(A1, b1, deadline_s=WAIT_S, timeout=WAIT_S)
    r2 = front.solve(A2, b2, deadline_s=WAIT_S, timeout=WAIT_S)
    gw = SolveGateway(max_inflight=8)
    try:
        for A, b, r in ((A1, b1, r1), (A2, b2, r2)):
            t = gw.submit(A, b)
            gw.flush()
            j = t.result()
            assert (int(r.status), int(r.iters)) == (int(j.status),
                                                     int(j.iters))
            x, jx = r.x.numpy(), np.asarray(j.x)
            assert x.dtype == np.float64
            assert np.abs(x - jx).max() <= RTOL * np.abs(jx).max()
            _check(A, b, r)
    finally:
        gw.stop()
    # distinct fingerprints spread over both workers, repeats stick
    slots = {front.router.peek(a._amgx_tpu_fp) for a in (A1, A2)}
    assert slots == {0, 1}
    snap0 = front.telemetry_snapshot()
    for _ in range(3):
        _check(A1, b1, front.solve(A1, b1, timeout=WAIT_S))
        _check(A2, b2, front.solve(A2, b2, timeout=WAIT_S))
    snap = front.telemetry_snapshot()
    assert snap["routing"]["hits"] - snap0["routing"]["hits"] == 6
    assert snap["counters"]["completed"] >= 8
    assert snap["counters"]["conn_losses"] == 0


def test_jax_frontend_talks_to_port_workers(fleet2):
    """The JAX package's FleetFrontend on the port's registry: its
    frames reach the port's workers and the replies come back."""
    from amgx_tpu.fleet.frontend import FleetFrontend as JaxFrontend

    sup, front, records = fleet2
    A = _mat((10, 10))
    b = _rhs(A.shape[0], 12)
    port = front.solve(A, b, timeout=WAIT_S)
    jfront = JaxFrontend(sup.registry.root, register_telemetry=False)
    try:
        assert sorted(jfront.attached_slots()) == [0, 1]
        res = jfront.solve(A, b, timeout=WAIT_S)
        assert (int(res.status), int(res.iters)) == (int(port.status),
                                                     int(port.iters))
        assert np.array_equal(np.asarray(res.x), port.x.numpy())
        assert jfront.health(0)["worker"]["pid"] == records[0].pid
    finally:
        jfront.close()


def test_typed_error_roundtrips_the_wire(fleet2):
    _sup, front, _records = fleet2
    A = _mat((8, 8))
    with pytest.raises(NonFiniteValuesError):
        front.solve(A, np.full(A.shape[0], np.nan), timeout=WAIT_S)
    assert front.router.board.tripped_indices() == []
    b = _rhs(A.shape[0], 7)
    _check(A, b, front.solve(A, b, timeout=WAIT_S))


def test_garbage_connection_leaves_worker_serving(fleet2):
    _sup, front, records = fleet2
    with socket.create_connection(records[0].address, timeout=30) as s:
        s.sendall(b"GET / HTTP/1.1\r\nHost: nope\r\n\r\n")
        header, _ = wire.read_frame(s.makefile("rb"))
        assert isinstance(wire.unmarshal_error(header["error"]),
                          wire.WireError)
        assert s.recv(1) == b""  # this connection is dropped
    A = _mat((8, 8))
    b = _rhs(A.shape[0], 9)
    _check(A, b, front.solve(A, b, timeout=WAIT_S))
    assert front.health(records[0].slot)["worker"]["wire_errors"] >= 1


def test_health_metrics_and_fleet_families(fleet2):
    from amgx_tpu_torch.telemetry.promtext import FamilyTable, fleet_families

    _sup, front, records = fleet2
    assert front.ping(0) and front.ping(1)
    h = front.health(0)
    assert h["worker"]["worker_id"] == records[0].worker_id
    assert h["worker"]["pid"] == records[0].pid
    assert h["state"] == "serving"
    assert "setups" in h["serve"]
    assert "coarsen_calls" in h["setup_evidence"]
    assert "amgx_serve_" in front.metrics_text(0)
    fams = FamilyTable()
    fleet_families(fams, "fleet0", front.telemetry_snapshot())
    text = fams.render()
    for name in ("amgx_fleet_submitted_total", "amgx_fleet_workers",
                 "amgx_fleet_affinity_hits_total",
                 "amgx_fleet_wire_latency_p99_s"):
        assert name in text


# ---------------------------------------------------------------------------
# the C API's fleet front


def _capi_systems(capi, res_h, A, seeds):
    n = A.shape[0]
    mh, rh, sh = [], [], []
    for seed in seeds:
        m = capi.matrix_create(res_h, "hDDI")
        capi.matrix_upload_all(m, n, A.nnz, 1, 1, A.indptr.astype(np.int32),
                               A.indices.astype(np.int32), A.data)
        r = capi.vector_create(res_h, "hDDI")
        capi.vector_upload(r, n, 1, _rhs(n, seed))
        x = capi.vector_create(res_h, "hDDI")
        capi.vector_set_zero(x, n, 1)
        mh.append(m)
        rh.append(r)
        sh.append(x)
    return mh, rh, sh


PCG_JSON = ('{"config_version": 2, "solver": {"scope": "m",'
            ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-8,'
            ' "monitor_residual": 1, "convergence": "RELATIVE_INI"}}')


def test_capi_batch_over_fleet(fleet2, monkeypatch):
    from amgx_tpu_torch.api import capi

    sup, _front, _records = fleet2
    monkeypatch.setenv("AMGX_TPU_FLEET", sup.registry.root)
    capi.initialize()
    cfg = capi.config_create(PCG_JSON)
    res_h = capi.resources_create_simple(cfg)
    A = _mat((8, 8))
    seeds = (20, 21, 22)
    mh, rh, sh = _capi_systems(capi, res_h, A, seeds)
    slv = capi.solver_create(res_h, "hDDI", cfg)
    try:
        assert capi.solver_solve_batch(slv, mh, rh, sh) == capi.RC_OK
        s = capi._get(slv, capi._SolverHandle)
        assert s.batch_fleet is not None
        assert s.batch_service is None and s.batch_gateway is None
        for i, seed in enumerate(seeds):
            assert capi.solver_get_batch_status(slv, i) == 0
            out = capi.vector_download(sh[i])
            b = _rhs(A.shape[0], seed)
            assert np.linalg.norm(A @ out - b) / np.linalg.norm(b) < 1e-6
        with pytest.raises(capi.AMGXError) as ei:
            capi.solver_session_create(slv, mh[0])
        assert ei.value.rc == capi.RC_NOT_SUPPORTED_TARGET
    finally:
        capi.solver_destroy(slv)


def _front_rc(capi, monkeypatch, spec):
    monkeypatch.setenv("AMGX_TPU_FLEET", spec)
    capi.initialize()
    cfg = capi.config_create(PCG_JSON)
    res_h = capi.resources_create_simple(cfg)
    mode = "hDDI" if "torch" in capi.__name__ else "dDDI"
    slv = capi.solver_create(res_h, mode, cfg)
    s = capi._get(slv, capi._SolverHandle)
    try:
        with pytest.raises(capi.AMGXError) as ei:
            capi._ensure_batch_front(s)
        # set but broken fails every call, never solves locally
        with pytest.raises(capi.AMGXError):
            capi._ensure_batch_front(s)
        assert s.batch_service is None
        return ei.value.rc
    finally:
        capi.solver_destroy(slv)


def test_capi_fleet_env_fails_loudly_as_jax(monkeypatch, tmp_path):
    import amgx_tpu.api.capi as jcapi

    from amgx_tpu_torch.api import capi

    with socket.socket() as free:
        free.bind(("127.0.0.1", 0))
        closed = free.getsockname()[1]
    (tmp_path / "empty").mkdir()
    cases = {"not-a-dir-not-an-addr": capi.RC_BAD_CONFIGURATION,
             "host:notaport": capi.RC_BAD_CONFIGURATION,
             str(tmp_path / "empty"): capi.RC_BAD_CONFIGURATION,
             f"127.0.0.1:{closed}": capi.RC_IO_ERROR}
    for spec, rc in cases.items():
        got = [_front_rc(m, monkeypatch, spec) for m in (jcapi, capi)]
        assert got == [rc, rc], spec


# ---------------------------------------------------------------------------
# the rolling restart, to the port's own contract


def test_rolling_restart_drains_and_warm_boots(tmp_path):
    sup, front, records = _spawn_fleet(1, str(tmp_path), AmgSupervisor)
    try:
        A = _mat((12, 12))
        b = _rhs(A.shape[0], 3)
        _check(A, b, front.solve(A, b, timeout=WAIT_S))
        h0 = front.health(0)
        assert h0["serve"]["setups"] == 1
        assert h0["setup_evidence"]["coarsen_calls"] > 0
        # admitted tickets in flight when the drain begins
        tickets = [front.submit(A, _rhs(A.shape[0], 30 + i))
                   for i in range(3)]
        out = sup.rolling_restart(records[0].worker_id, front,
                                  timeout_s=WAIT_S)
        for i, t in enumerate(tickets):
            _check(A, _rhs(A.shape[0], 30 + i), t.result(timeout=WAIT_S))
        rep = out["drain"]
        assert rep["failed"] == 0 and rep["timed_out"] == 0
        assert rep["exported"] >= 1
        assert out["exit_code"] == 0
        h1 = front.health(0)
        assert h1["worker"]["worker_id"] != records[0].worker_id
        assert h1["worker"]["warm_booted"] >= 1
        assert h1["serve"]["setups"] == 0
        _check(A, b, front.solve(A, b, timeout=WAIT_S))
        h2 = front.health(0)
        assert h2["serve"]["setups"] == 0
        assert h2["serve"]["cache_hits"] >= 1
        assert h2["setup_evidence"]["coarsen_calls"] == 0
        assert h2["setup_evidence"]["restored"] >= 1
    finally:
        front.close()
        sup.terminate_all()


# ---------------------------------------------------------------------------
# kill -9: the breaker trips, the work in flight requeues once


def test_kill9_requeues_or_settles_typed(tmp_path):
    sup, front, records = _spawn_fleet(2, str(tmp_path), AmgSupervisor)
    try:
        A_warm = _mat((8, 8))
        bw = _rhs(A_warm.shape[0], 4)
        _check(A_warm, bw, front.solve(A_warm, bw, timeout=WAIT_S))
        # a cold fingerprint: its first group pays the AMG setup, a wide
        # window for the kill
        A_cold = _mat((20, 20, 20))
        bc = _rhs(A_cold.shape[0], 5)
        tickets = [front.submit(A_cold, bc, deadline_s=300.0)
                   for _ in range(3)]
        victim = next(r for r in records
                      if r.slot == tickets[0]._pending.slot)
        assert sup.kill(victim.worker_id) is True
        outcomes = []
        for t in tickets:
            try:
                _check(A_cold, bc, t.result(timeout=WAIT_S), tol=1e-6)
                outcomes.append("ok")
            except AMGXTPUError as e:
                assert isinstance(e, DeviceLostError)
                outcomes.append("typed")
        assert len(outcomes) == 3
        snap = front.telemetry_snapshot()
        assert snap["counters"]["conn_losses"] == 1
        assert snap["routing"]["health"]["trips"] == 1
        assert (snap["counters"]["requeued"]
                + snap["counters"]["requeue_failures"]) == 3
        _check(A_warm, bw, front.solve(A_warm, bw, timeout=WAIT_S))
        _check(A_cold, bc, front.solve(A_cold, bc, timeout=WAIT_S))
    finally:
        front.close()
        sup.terminate_all()


# ---------------------------------------------------------------------------
# no card, no worker


def test_worker_without_device_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    reg = tmp_path / "registry"
    proc = subprocess.run(
        [sys.executable, "-m", "amgx_tpu_torch.fleet.worker",
         "--registry", str(reg), "--worker-id", "w0"],
        capture_output=True, text=True, timeout=WAIT_S, cwd=REPO,
        env={**os.environ, **WORKER_ENV})
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not list(reg.glob("*.json"))  # it never announced
    sup = FleetSupervisor(str(reg), env=WORKER_ENV,
                          spawn_timeout_s=SPAWN_TIMEOUT_S)
    with pytest.raises(RuntimeError, match="exited with code"):
        sup.spawn(0)
