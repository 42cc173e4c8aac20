"""The fleet's wire, registry, routers and Prometheus families of the
PyTorch port (``amgx_tpu_torch.fleet``, ``serve/placement/router.py``,
``telemetry/promtext.fleet_families``) against the JAX package's, on the
CPU, in one process: the scenarios of ``tests/test_fleet_wire.py``
through both packages.

Held equal: ``pack_frame``'s bytes for the same header and arrays (a
frontend of either package talks to a worker of the other), and each
package's frames decoded by the other; the typed error class and
message of every garbage case; ``marshal_error`` in one package and
``unmarshal_error`` in the other (class name, message, RC,
``retry_after_s``, ``reason``, ``device_label``); registry records
written by one package and read by the other; every routing decision
(slot, was_warm) and snapshot of the router call sequences; the
rendered ``amgx_fleet_*`` families of one snapshot.
"""

import asyncio
import io
import json
import os
import struct
import types

import numpy as np
import pytest


def _pkg(name):
    if name == "jax":
        import amgx_tpu.core.errors as errors
        import amgx_tpu.fleet.registry as registry
        import amgx_tpu.fleet.router as router
        import amgx_tpu.fleet.wire as wire
        import amgx_tpu.serve.placement.router as placement_router
        import amgx_tpu.telemetry.promtext as promtext
    else:
        import amgx_tpu_torch.core.errors as errors
        import amgx_tpu_torch.fleet.registry as registry
        import amgx_tpu_torch.fleet.router as router
        import amgx_tpu_torch.fleet.wire as wire
        import amgx_tpu_torch.serve.placement.router as placement_router
        import amgx_tpu_torch.telemetry.promtext as promtext
    return types.SimpleNamespace(
        name=name, errors=errors, registry=registry, router=router,
        wire=wire, placement_router=placement_router, promtext=promtext)


PKGS = (_pkg("jax"), _pkg("torch"))
JAX, TORCH = PKGS
PAIRS = [(a, b) for a in PKGS for b in PKGS if a is not b]
PAIR_IDS = [f"{a.name}-to-{b.name}" for a, b in PAIRS]


# ---------------------------------------------------------------------------
# frames: the same bytes, decodable across packages

def _frames():
    rng = np.random.default_rng(7)
    return {
        "header_only": ({"verb": "ping", "rid": "r-1"}, None),
        "submit": ({"verb": "submit", "rid": "ab-3", "n": 7, "fp": "f" * 64,
                    "tenant": "t", "lane": "batch", "deadline_s": 1.5,
                    "trace": {"trace_id": "x", "root_id": 2, "tid": 0}},
                   {"row_offsets": np.arange(8, dtype=np.int32),
                    "col_indices": np.arange(7, dtype=np.int64),
                    "values": rng.standard_normal(7),
                    "b": rng.standard_normal(7).astype(np.float32)}),
        "zero_dim_between": ({}, {"iters": np.asarray(7, np.int32),
                                  "x": np.arange(3.0),
                                  "status": np.asarray(0, np.int64)}),
        "non_contiguous": ({"v": 1}, {
            "a": np.arange(20.0).reshape(4, 5)[:, ::2],
            "t": np.arange(12, dtype=np.int32).reshape(3, 4).T}),
        "dtypes_and_empty": ({"nan": float("nan")}, {
            "f32": np.linspace(0, 1, 5, dtype=np.float32),
            "f64": np.linspace(0, 1, 5),
            "i32": np.arange(-2, 3, dtype=np.int32),
            "i64": np.arange(-2, 3, dtype=np.int64),
            "m": np.ones((3, 4), np.float32),
            "empty": np.empty(0, np.float64)}),
    }


FRAMES = _frames()


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_pack_frame_bytes_equal(case):
    header, arrays = FRAMES[case]
    j, t = (p.wire.pack_frame(header, arrays) for p in PKGS)
    assert t == j


def test_several_frames_on_one_stream_equal():
    parts = [({"rid": "a"}, None), FRAMES["submit"],
             FRAMES["zero_dim_between"]]
    streams = [b"".join(p.wire.pack_frame(h, a) for h, a in parts)
               for p in PKGS]
    assert streams[0] == streams[1]
    for p in PKGS:
        buf = io.BytesIO(streams[0])
        assert [p.wire.read_frame(buf)[0].get("rid") for _ in parts] == [
            "a", "ab-3", None]
        with pytest.raises(p.wire.WireClosed):
            p.wire.read_frame(buf)


def _same_frame(got, header, arrays):
    h, arrs = got
    want = dict(header)
    if "nan" in want:
        assert np.isnan(h.pop("nan"))
        want.pop("nan")
    assert h == want
    assert sorted(arrs) == sorted(arrays or {})
    for name, a in (arrays or {}).items():
        assert arrs[name].dtype == a.dtype and arrs[name].shape == a.shape
        np.testing.assert_array_equal(arrs[name], a)
        assert arrs[name].flags.writeable


@pytest.mark.parametrize("src,dst", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("case", sorted(FRAMES))
def test_frame_decodes_across_packages(src, dst, case):
    header, arrays = FRAMES[case]
    frame = src.wire.pack_frame(header, arrays)
    _same_frame(dst.wire.read_frame(io.BytesIO(frame)), header, arrays)

    async def read():
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        return await dst.wire.read_frame_async(reader)

    _same_frame(asyncio.run(read()), header, arrays)


# ---------------------------------------------------------------------------
# garbage: the same typed error, class and message, in both packages

def _garbage():
    prefix = struct.Struct("!4sB3xIQ")
    magic, version = b"AMGW", 1
    good = JAX.wire.pack_frame({"v": 1}, {"a": np.ones(8)})
    hlen = prefix.unpack_from(good)[2]
    header = json.loads(good[prefix.size:prefix.size + hlen])
    header["arrays"][0]["nbytes"] = 10_000
    hb = json.dumps(header).encode()
    blob = good[prefix.size + hlen:]
    overrun = prefix.pack(magic, version, len(hb), len(blob)) + hb + blob
    plain = bytearray(JAX.wire.pack_frame({"v": 1}))
    prefix.pack_into(plain, 0, magic, version,
                     prefix.unpack_from(plain)[2], 4)
    bad_version = bytearray(JAX.wire.pack_frame({"v": 1}))
    bad_version[4] = 99
    mid = JAX.wire.pack_frame({"verb": "submit"}, {"b": np.ones(100)})
    out = {
        "clean_eof": b"",
        "truncated_prefix": b"AMG",
        "bad_magic": b"HTTP/1.1 200 OK\r\n\r\n" + b"\x00" * 64,
        "bad_version": bytes(bad_version),
        "oversize_header": prefix.pack(magic, version,
                                       (8 << 20) + 1, 0),
        "oversize_blob": prefix.pack(magic, version, 2, 1 << 62),
        "mid_frame_disconnect": mid[:-17],
        "malformed_json": prefix.pack(magic, version, 17, 0)
        + b"{this is not json",
        "header_not_object": prefix.pack(magic, version, 9, 0)
        + b"[1, 2, 3]",
        "manifest_overrun": overrun,
        "undeclared_bytes": bytes(plain) + b"\xde\xad\xbe\xef",
    }
    rng = np.random.default_rng(1234)
    for i in range(8):
        out[f"random_{i}"] = rng.integers(
            0, 256, rng.integers(1, 200)).astype(np.uint8).tobytes()
    return out


GARBAGE = _garbage()


@pytest.mark.parametrize("case", sorted(GARBAGE))
def test_garbage_same_typed_error(case):
    got = []
    for p in PKGS:
        with pytest.raises(p.wire.WireError) as ei:
            p.wire.read_frame(io.BytesIO(GARBAGE[case]))
        assert ei.value.rc == p.errors.RC_IO_ERROR
        got.append((type(ei.value).__name__, str(ei.value)))
    assert got[0] == got[1]


def test_max_frame_knob_same(monkeypatch):
    for p in PKGS:
        monkeypatch.setenv(p.wire.ENV_MAX_FRAME, "1")
        assert p.wire.max_blob_bytes() == 1 << 20
        with pytest.raises(p.wire.WireError, match="exceeds"):
            p.wire.pack_frame({}, {"big": np.ones(1 << 18)})
        monkeypatch.setenv(p.wire.ENV_MAX_FRAME, "garbage")
        assert p.wire.max_blob_bytes() == 1024 << 20
    assert (JAX.wire.MAGIC, JAX.wire.VERSION, JAX.wire.PREFIX_LEN,
            JAX.wire.MAX_HEADER_BYTES, JAX.wire.REQUEST_VERBS) == (
        TORCH.wire.MAGIC, TORCH.wire.VERSION, TORCH.wire.PREFIX_LEN,
        TORCH.wire.MAX_HEADER_BYTES, TORCH.wire.REQUEST_VERBS)


# ---------------------------------------------------------------------------
# typed errors across packages

ERRORS = [
    ("AMGXTPUError", ("base",), {}),
    ("SetupError", ("setup blew up",), {}),
    ("SingularDiagonalError", ("zero diag at row 3",), {}),
    ("NonFiniteValuesError", ("nan in values",), {}),
    ("PatternDegeneracyError", ("bad indptr",), {}),
    ("SolveBreakdown", ("rho underflow",), {}),
    ("ResourceError", ("oom",), {}),
    ("DeadlineExceededError", ("too slow",), {}),
    ("StoreError", ("corrupt artifact",), {}),
    ("AdmissionRejected", ("quota exhausted",),
     {"retry_after_s": 3.25, "reason": "quota"}),
    ("Overloaded", ("queue full",), {"retry_after_s": 0.5}),
    ("DeviceLostError", ("card fell over",), {"device_label": "worker:w3"}),
    ("WireError", ("garbage frame",), {}),
    ("WireClosed", ("peer closed",), {}),
]


def _make(p, cls_name, args, kw):
    cls = getattr(p.errors, cls_name, None) or getattr(p.wire, cls_name)
    return cls(*args, **kw)


def _fields(e):
    return (type(e).__name__, str(e), e.rc,
            getattr(e, "retry_after_s", None), getattr(e, "reason", None),
            getattr(e, "device_label", None))


@pytest.mark.parametrize("src,dst", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("cls_name,args,kw", ERRORS,
                         ids=[e[0] for e in ERRORS])
def test_error_marshals_across_packages(src, dst, cls_name, args, kw):
    exc = _make(src, cls_name, args, kw)
    d = src.wire.marshal_error(exc)
    assert d == dst.wire.marshal_error(_make(dst, cls_name, args, kw))
    back = dst.wire.unmarshal_error(json.loads(json.dumps(d)))
    assert isinstance(back, dst.errors.AMGXTPUError)
    assert _fields(back) == _fields(exc)


@pytest.mark.parametrize("payload", [
    None, "boom", {}, {"etype": "SomeFutureError", "msg": "??", "rc": 15},
    {"etype": "ValueError", "msg": "nope", "rc": 1}])
def test_unknown_and_malformed_errors_degrade_alike(payload):
    got = [_fields(p.wire.unmarshal_error(payload)) for p in PKGS]
    assert got[0] == got[1]
    assert got[1][0] == "AMGXTPUError"


# ---------------------------------------------------------------------------
# the registry: either package reads the other's records

@pytest.mark.parametrize("src,dst", PAIRS, ids=PAIR_IDS)
def test_registry_record_read_across_packages(src, dst, tmp_path):
    w = src.registry.WorkerRegistry(tmp_path)
    rec = src.registry.WorkerRecord(
        "w0", "127.0.0.1", 4242, os.getpid(), slot=3, dist_capable=True,
        extra={"warm_booted": 2})
    w.announce(rec)
    w.announce(src.registry.WorkerRecord("dead", "h", 1, 2**22 + 12345))
    (tmp_path / "bad.json").write_text("{not json")
    r = dst.registry.WorkerRegistry(tmp_path)
    got = r.lookup("w0")
    assert got.to_dict() == rec.to_dict()
    assert got.address == ("127.0.0.1", 4242) and got.alive()
    assert [x.worker_id for x in r.workers()] == ["w0"]
    assert len(r.workers(live_only=False)) == 2
    assert r.wait_for("w0", timeout_s=1.0).slot == 3
    with open(tmp_path / "w0.json") as f:
        raw = json.load(f)
    assert sorted(raw) == sorted(rec.to_dict())
    r.withdraw("w0")
    assert w.lookup("w0") is None
    for bad in ("../evil", "a/b", ".hidden", ""):
        with pytest.raises(ValueError):
            r.lookup(bad)


# ---------------------------------------------------------------------------
# routers: the same decisions for the same call sequences

def _router(p, n=3, **kw):
    kw.setdefault("dist_rows", 1000)
    r = p.router.FleetRouter(capacity=8, **kw)
    for slot in range(n):
        r.add_worker(slot)
    return r


def seq_stick(p):
    r, out = _router(p), []
    for _ in range(2):
        slot, warm = r.route("fpA")
        out.append((slot, warm))
        r.settle(slot, 0.01)
    return out, r.snapshot()


def seq_spread(p):
    r = _router(p, 3)
    return [r.route(f"fp{i}") for i in range(3)], r.snapshot()


def seq_trip_and_forget(p):
    r, out = _router(p, 2), []
    slot, warm = r.route("fpA")
    out.append((slot, warm))
    r.settle(slot, 0.01)
    out.append(r.failure(slot))
    out.append(r.board.tripped_indices())
    out.append(r.route("fpA"))
    return out, r.snapshot()


def seq_half_open_probe(p):
    r, out = _router(p, 2, probe_every=2), []
    r.failure(0)
    for i in range(6):
        slot, warm = r.route(f"fp{i}")
        out.append((slot, warm))
        r.settle(slot, 0.0) if slot != 0 else r.release(slot)
    slot, _ = r.route("probe-win")
    while slot != 0:
        r.release(slot)
        slot, _ = r.route("probe-win")
    r.settle(slot, 0.01)
    out.append((r.board.tripped_indices(), r.board.closes))
    return out, r.snapshot()


def seq_all_tripped(p):
    r, out = _router(p, 2), []
    r.failure(0)
    r.failure(1)
    for i in range(20):
        slot, warm = r.route(f"fp{i}")
        out.append((slot, warm))
        r.release(slot)
    return out, r.snapshot()


def seq_oversized_with_dist(p):
    r, out = p.router.FleetRouter(capacity=4, dist_rows=500), []
    r.add_worker(0)
    r.add_worker(1, dist_capable=True)
    for i in range(4):
        slot, warm = r.route(f"big{i}", n_rows=1000)
        out.append((slot, warm))
        r.settle(slot, 0.0)
    for i in range(8):
        slot, warm = r.route(f"small{i}", n_rows=100)
        out.append((slot, warm))
        r.settle(slot, 0.0)
    return out, r.snapshot()


def seq_oversized_without_dist(p):
    # a 64^3 pattern: 262,144 rows, above the default threshold
    r = p.router.FleetRouter(capacity=4)
    r.add_worker(0)
    r.add_worker(1)
    out = [r.route(f"big{i}", n_rows=64 ** 3) for i in range(4)]
    return out, r.snapshot()


def seq_remove(p):
    r, out = _router(p, 2), []
    slot, warm = r.route("fpA")
    out.append((slot, warm))
    r.settle(slot, 0.0)
    r.remove_worker(slot)
    out.append(r.board.tripped_indices())
    out.append(r.route("fpA"))
    out.append(r.active_slots())
    return out, r.snapshot()


def seq_affinity_router(p):
    r, out = p.placement_router.AffinityRouter(3), []
    for fp in ("a", "b", "c", "a", "d"):
        out.append(r.route(fp))
    out.append(r.route("a", allowed=[2]))
    out.append(r.route_to("e", 1))
    r.settle(0, 0.5)
    r.release(1)
    out.append((r.peek("a"), r.peek("zz")))
    r.forget("a")
    out.append((r.peek("a"), r.forget_device(1)))
    return out, r.snapshot()


SEQUENCES = [seq_stick, seq_spread, seq_trip_and_forget, seq_half_open_probe,
             seq_all_tripped, seq_oversized_with_dist,
             seq_oversized_without_dist, seq_remove, seq_affinity_router]


@pytest.mark.parametrize("seq", SEQUENCES, ids=[s.__name__ for s in SEQUENCES])
def test_router_decisions_equal(seq, monkeypatch):
    monkeypatch.delenv("AMGX_TPU_DIST_ROWS", raising=False)
    monkeypatch.delenv("AMGX_TPU_BREAKER_PROBE_EVERY", raising=False)
    j, t = (seq(p) for p in PKGS)
    assert t == j


def test_router_row_threshold_same(monkeypatch):
    monkeypatch.delenv("AMGX_TPU_DIST_ROWS", raising=False)
    vals = [p.router.dist_row_threshold() for p in PKGS]
    monkeypatch.setenv("AMGX_TPU_DIST_ROWS", "1234")
    vals += [p.router.dist_row_threshold() for p in PKGS]
    monkeypatch.setenv("AMGX_TPU_DIST_ROWS", "junk")
    vals += [p.router.dist_row_threshold() for p in PKGS]
    assert vals == [65536, 65536, 1234, 1234, 65536, 65536]
    with pytest.raises(RuntimeError, match="no workers"):
        TORCH.router.FleetRouter(capacity=4).route("fp0")
    with pytest.raises(ValueError):
        TORCH.router.FleetRouter(capacity=2).add_worker(2)


# ---------------------------------------------------------------------------
# the amgx_fleet_* families

FLEET_SNAPSHOT = {
    "counters": {"submitted": 40, "completed": 36, "typed_errors": 2,
                 "retries": 3, "requeued": 2, "requeue_failures": 1,
                 "conn_losses": 1},
    "routing": {"hits": 30, "misses": 10, "outstanding": [0, 1],
                "busy_s": [1.5, 2.25], "groups": [20, 20],
                "warm_fingerprints": [1, 2], "active": [0, 1],
                "dist_capable": [], "dist_routed": 0, "fallbacks": 1,
                "dist_rows": 65536,
                "health": {"unhealthy": 1, "trips": 2, "probes": 3,
                           "closes": 1, "tripped": [1]}},
    "retry": {"retries": 3, "giveups": 1},
    "wire_latency": {"count": 40, "mean_s": 0.125, "p50_s": 0.1,
                     "p99_s": 0.5},
}


@pytest.mark.parametrize("snap", [FLEET_SNAPSHOT, {}],
                         ids=["traffic", "empty"])
def test_fleet_families_render_equal(snap):
    texts = []
    for p in PKGS:
        fams = p.promtext.FamilyTable()
        p.promtext.fleet_families(fams, "fleet0", snap)
        texts.append(fams.render())
    assert texts[0] == texts[1]
    if snap:
        assert "amgx_fleet_affinity_hit_ratio" in texts[1]
        assert "amgx_fleet_submitted_total" in texts[1]
    # the registry's kind table routes a "fleet" component to them
    full = [p.promtext.render({"fleet0": {"kind": "fleet", "data": snap}})
            for p in PKGS]
    assert full[0] == full[1]
