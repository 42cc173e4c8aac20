"""The fleet wire protocol: length-prefixed JSON + binary frames (the
JAX package's ``fleet/wire.py``, byte for byte the same frames, so that
a frontend of either package talks to a worker of the other).

One frame carries one request or one reply between a
:class:`~amgx_tpu_torch.fleet.frontend.FleetFrontend` and a
:class:`~amgx_tpu_torch.fleet.worker.FleetWorker`:

    +-------+---------+------------+-----------+------------------+
    | magic | version | header len | blob len  | header ... blob  |
    | AMGW  |   u8    |    u32     |    u64    | JSON      bytes  |
    +-------+---------+------------+-----------+------------------+

The JSON header holds the verb, the request id (replies carry the id of
the request they answer), per-request deadlines, tenant and lane, the
trace context, and an ``arrays`` manifest ``[{name, dtype, shape,
nbytes}, ...]`` describing the C-contiguous numpy buffers concatenated
into the blob.  Stdlib and numpy only: no tensor crosses the wire.

Garbage on the wire is a typed, counted condition, never a hang:
oversize prefixes, short reads, truncated blobs, bad magic and
malformed JSON raise :class:`WireError` (an
:class:`~amgx_tpu_torch.core.errors.AMGXTPUError`, RC_IO_ERROR); a clean
EOF at a frame boundary raises :class:`WireClosed`.

:func:`marshal_error` / :func:`unmarshal_error` carry the
``core/errors.py`` taxonomy by class name, with the RC,
``retry_after_s``, ``reason`` and ``device_label``: an error marshalled
by either package comes back as the same class in the other.  Unknown
types degrade to :class:`~amgx_tpu_torch.core.errors.AMGXTPUError` with
the marshalled RC.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
from typing import Optional

import numpy as np

from amgx_tpu_torch.core.errors import (
    AMGXTPUError,
    AdmissionRejected,
    DeadlineExceededError,
    DeviceLostError,
    NonFiniteValuesError,
    Overloaded,
    PatternDegeneracyError,
    RC_IO_ERROR,
    RC_UNKNOWN,
    ResourceError,
    SetupError,
    SingularDiagonalError,
    SolveBreakdown,
    StoreError,
    rc_for_exception,
)

MAGIC = b"AMGW"
VERSION = 1
# magic, version, pad(3), header_len u32, blob_len u64
_PREFIX = struct.Struct("!4sB3xIQ")
PREFIX_LEN = _PREFIX.size

ENV_MAX_FRAME = "AMGX_TPU_FLEET_MAX_FRAME_MB"
MAX_HEADER_BYTES = 8 << 20


def max_blob_bytes() -> int:
    """Upper bound on one frame's binary payload (default 1 GiB,
    ``AMGX_TPU_FLEET_MAX_FRAME_MB`` overrides).  A length prefix past
    it is GARBAGE, refused typed before any allocation — a corrupt
    u64 must not become a 16-exabyte read()."""
    raw = os.environ.get(ENV_MAX_FRAME, "")
    try:
        mb = int(raw) if raw else 1024
    except ValueError:
        mb = 1024
    return max(mb, 1) << 20


# ----------------------------------------------------------------------
# verbs

VERB_SUBMIT = "submit"
VERB_RESULT = "result"  # reply verb for submit / session_step
VERB_HEALTH = "health"
VERB_DRAIN = "drain"
VERB_METRICS = "metrics"
VERB_PING = "ping"
VERB_SESSION_OPEN = "session_open"
VERB_SESSION_STEP = "session_step"
VERB_SESSION_CLOSE = "session_close"

REQUEST_VERBS = frozenset({
    VERB_SUBMIT, VERB_HEALTH, VERB_DRAIN, VERB_METRICS, VERB_PING,
    VERB_SESSION_OPEN, VERB_SESSION_STEP, VERB_SESSION_CLOSE,
})


# ----------------------------------------------------------------------
# typed wire failures


class WireError(AMGXTPUError):
    """Garbage on the wire: bad magic/version, oversize length
    prefix, truncated frame, malformed header, blob/manifest
    mismatch.  Typed (RC_IO_ERROR) so it settles tickets and crosses
    the C API boundary like every other taxonomy member."""

    rc = RC_IO_ERROR


class WireClosed(WireError):
    """The peer closed the connection at a clean frame boundary —
    orderly shutdown, not corruption.  Distinct class so accept loops
    can exit quietly while mid-frame disconnects stay loud."""


# ----------------------------------------------------------------------
# framing


def pack_frame(header: dict, arrays: Optional[dict] = None) -> bytes:
    """Serialize one frame.  ``arrays`` ({name: ndarray}) are made
    C-contiguous, described in the header's ``arrays`` manifest (in
    iteration order) and concatenated into the blob."""
    header = dict(header)
    blobs = []
    manifest = []
    for name, arr in (arrays or {}).items():
        a = np.asarray(arr)
        if not a.flags.c_contiguous:
            # (ascontiguousarray also promotes 0-d to 1-d, so only
            # copy when actually needed)
            a = np.ascontiguousarray(a)
        manifest.append({
            "name": str(name),
            "dtype": a.dtype.str,
            "shape": list(a.shape),
            "nbytes": int(a.nbytes),
        })
        blobs.append(a.tobytes())  # snapshot: caller may reuse buffers
    header["arrays"] = manifest
    hb = json.dumps(header, separators=(",", ":"),
                    allow_nan=True).encode("utf-8")
    if len(hb) > MAX_HEADER_BYTES:
        raise WireError(
            f"frame header {len(hb)} bytes exceeds the "
            f"{MAX_HEADER_BYTES}-byte bound"
        )
    blob = b"".join(blobs)
    if len(blob) > max_blob_bytes():
        raise WireError(
            f"frame blob {len(blob)} bytes exceeds the "
            f"{max_blob_bytes()}-byte bound "
            f"({ENV_MAX_FRAME} raises it)"
        )
    return _PREFIX.pack(MAGIC, VERSION, len(hb), len(blob)) + hb + blob


def _decode(prefix: bytes, hb: bytes, blob: bytes) -> tuple:
    magic, version, hlen, blen = _PREFIX.unpack(prefix)
    try:
        header = json.loads(hb.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"malformed frame header: {e}") from None
    if not isinstance(header, dict):
        raise WireError("frame header must be a JSON object")
    arrays = {}
    off = 0
    manifest = header.pop("arrays", [])
    if not isinstance(manifest, list):
        raise WireError("frame manifest must be a list")
    for ent in manifest:
        try:
            name = ent["name"]
            dt = np.dtype(ent["dtype"])
            shape = tuple(int(s) for s in ent["shape"])
            nbytes = int(ent["nbytes"])
        except (KeyError, TypeError, ValueError) as e:
            raise WireError(f"malformed array manifest: {e}") from None
        if nbytes < 0 or off + nbytes > len(blob):
            raise WireError(
                "array manifest overruns the frame blob"
            )
        try:
            count = nbytes // dt.itemsize if dt.itemsize else 0
            arrays[name] = np.frombuffer(
                blob, dtype=dt, count=count, offset=off,
            ).reshape(shape).copy()
        except ValueError as e:
            raise WireError(f"array decode failed: {e}") from None
        off += nbytes
    if off != len(blob):
        raise WireError(
            f"frame blob has {len(blob) - off} undeclared bytes"
        )
    return header, arrays


def _check_prefix(prefix: bytes) -> tuple:
    """Validate a 20-byte prefix BEFORE reading body bytes: bad magic
    or an oversize length is refused without allocating for it."""
    magic, version, hlen, blen = _PREFIX.unpack(prefix)
    if magic != MAGIC:
        raise WireError(f"bad frame magic {magic!r}")
    if version != VERSION:
        raise WireError(f"unsupported wire version {version}")
    if hlen > MAX_HEADER_BYTES:
        raise WireError(
            f"oversize header length prefix ({hlen} bytes)"
        )
    if blen > max_blob_bytes():
        raise WireError(
            f"oversize blob length prefix ({blen} bytes)"
        )
    return hlen, blen


async def read_frame_async(reader: asyncio.StreamReader) -> tuple:
    """Read one frame from an asyncio stream.  Clean EOF before any
    prefix byte raises :class:`WireClosed`; everything else short or
    malformed raises :class:`WireError`."""
    try:
        prefix = await reader.readexactly(PREFIX_LEN)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            raise WireClosed("peer closed the wire") from None
        raise WireError(
            f"truncated frame prefix ({len(e.partial)} of "
            f"{PREFIX_LEN} bytes)"
        ) from None
    hlen, blen = _check_prefix(prefix)
    try:
        hb = await reader.readexactly(hlen)
        blob = await reader.readexactly(blen) if blen else b""
    except asyncio.IncompleteReadError as e:
        raise WireError(
            f"mid-frame disconnect ({len(e.partial)} bytes short)"
        ) from None
    return _decode(prefix, hb, blob)


def read_frame(fileobj) -> tuple:
    """Blocking twin of :func:`read_frame_async` over a file-like
    object (``socket.makefile('rb')``) — the synchronous client
    side's reader-thread entry point."""

    def _readexactly(n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = fileobj.read(n - got)
            if not chunk:
                raise _Short(b"".join(chunks))
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    class _Short(Exception):
        def __init__(self, partial):
            self.partial = partial

    try:
        try:
            prefix = _readexactly(PREFIX_LEN)
        except _Short as e:
            if not e.partial:
                raise WireClosed("peer closed the wire") from None
            raise WireError(
                f"truncated frame prefix ({len(e.partial)} of "
                f"{PREFIX_LEN} bytes)"
            ) from None
        hlen, blen = _check_prefix(prefix)
        try:
            hb = _readexactly(hlen)
            blob = _readexactly(blen) if blen else b""
        except _Short as e:
            raise WireError(
                f"mid-frame disconnect ({len(e.partial)} bytes short)"
            ) from None
    except OSError as e:
        raise WireError(f"wire read failed: {e}") from None
    return _decode(prefix, hb, blob)


# ----------------------------------------------------------------------
# typed error marshalling

# the whole taxonomy by class name: what a worker raises is what the
# client re-raises (Overloaded before AdmissionRejected is irrelevant
# here — the name lookup is exact)
_TAXONOMY = {
    cls.__name__: cls
    for cls in (
        AMGXTPUError, SetupError, SingularDiagonalError,
        NonFiniteValuesError, PatternDegeneracyError, SolveBreakdown,
        ResourceError, DeviceLostError, DeadlineExceededError,
        AdmissionRejected, Overloaded, StoreError, WireError,
        WireClosed,
    )
}


def marshal_error(exc: BaseException) -> dict:
    """Wire form of any exception: class name, message, RC code, and
    the machine-actionable extras the taxonomy carries
    (``retry_after_s``/``reason``/``device_label``)."""
    d = {
        "etype": type(exc).__name__,
        "msg": str(exc),
        "rc": rc_for_exception(exc),
    }
    for k in ("retry_after_s", "reason", "device_label"):
        v = getattr(exc, k, None)
        if v is not None:
            d[k] = v
    return d


def unmarshal_error(d: dict) -> AMGXTPUError:
    """Reconstruct the typed exception a peer marshalled.  Taxonomy
    classes round-trip exactly (constructor extras included); unknown
    types degrade to :class:`AMGXTPUError` with the marshalled RC —
    a remote failure is ALWAYS typed client-side."""
    if not isinstance(d, dict):
        return AMGXTPUError("malformed error payload", rc=RC_UNKNOWN)
    msg = str(d.get("msg", ""))
    cls = _TAXONOMY.get(d.get("etype"))
    if cls is None:
        rc = d.get("rc")
        return AMGXTPUError(
            f"{d.get('etype', 'RemoteError')}: {msg}",
            rc=rc if isinstance(rc, int) else RC_UNKNOWN,
        )
    try:
        if issubclass(cls, AdmissionRejected):
            return cls(
                msg,
                retry_after_s=d.get("retry_after_s"),
                reason=str(d.get("reason", "rejected")),
            )
        if issubclass(cls, DeviceLostError):
            return cls(msg, device_label=d.get("device_label"))
        return cls(msg)
    except Exception:  # noqa: BLE001 — marshalling must not raise
        return AMGXTPUError(msg, rc=d.get("rc", RC_UNKNOWN))


# ----------------------------------------------------------------------
# trace-context propagation


def trace_carrier() -> Optional[dict]:
    """The ambient trace context as a wire-safe dict (None when this
    request is unsampled) — attached to submit/step headers so a
    worker's spans join the client's trace."""
    from amgx_tpu_torch.telemetry import tracing

    ctx = tracing.ambient()
    if ctx is None:
        return None
    return {
        "trace_id": ctx.trace_id,
        "root_id": ctx.root_id,
        "tid": ctx.tid,
    }


def trace_from_carrier(carrier):
    """Rebuild a TraceContext from a wire carrier dict (None-safe,
    malformed-safe: propagation must never fail a solve)."""
    if not isinstance(carrier, dict):
        return None
    from amgx_tpu_torch.telemetry import tracing

    try:
        return tracing.TraceContext(
            str(carrier["trace_id"]),
            int(carrier["root_id"]),
            int(carrier.get("tid", 0)),
        )
    except (KeyError, TypeError, ValueError):
        return None
