"""File-based worker registry: how fleet processes find each other (the
JAX package's ``fleet/registry.py``, with the same record files, so
that either package reads the other's registry).

Each worker announces itself as one JSON file under the registry root
(``<root>/<worker_id>.json``), written tmp-then-``os.replace`` as the
:class:`~amgx_tpu_torch.store.store.ArtifactStore` writes: a reader
never sees a half-written record, and a crashed writer leaves at worst a
stale ``.tmp`` that is ignored.  No daemon and no lock server: liveness
is ``os.kill(pid, 0)`` plus a heartbeat timestamp, enough for a fleet
on one host (several worker processes sharing its cards).

Corrupt or stale records read as "worker not listed".
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

_SUFFIX = ".json"


class WorkerRecord:
    """One announced worker: identity, wire address, capabilities."""

    __slots__ = (
        "worker_id", "host", "port", "pid", "slot", "dist_capable",
        "started_at", "heartbeat_at", "extra",
    )

    def __init__(self, worker_id: str, host: str, port: int, pid: int,
                 slot: int = 0, dist_capable: bool = False,
                 started_at: float = 0.0, heartbeat_at: float = 0.0,
                 extra: Optional[dict] = None):
        self.worker_id = str(worker_id)
        self.host = str(host)
        self.port = int(port)
        self.pid = int(pid)
        self.slot = int(slot)
        self.dist_capable = bool(dist_capable)
        self.started_at = float(started_at)
        self.heartbeat_at = float(heartbeat_at)
        self.extra = dict(extra or {})

    @property
    def address(self) -> tuple:
        return (self.host, self.port)

    def to_dict(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "host": self.host,
            "port": self.port,
            "pid": self.pid,
            "slot": self.slot,
            "dist_capable": self.dist_capable,
            "started_at": self.started_at,
            "heartbeat_at": self.heartbeat_at,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkerRecord":
        return cls(
            d["worker_id"], d["host"], int(d["port"]), int(d["pid"]),
            slot=int(d.get("slot", 0)),
            dist_capable=bool(d.get("dist_capable", False)),
            started_at=float(d.get("started_at", 0.0)),
            heartbeat_at=float(d.get("heartbeat_at", 0.0)),
            extra=d.get("extra") or {},
        )

    def alive(self) -> bool:
        """Best-effort liveness: the announced pid still exists (and
        is signalable).  A same-host check — remote pids are assumed
        alive and left to wire-level breakers."""
        if self.pid <= 0:
            return False
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, owned by someone else
        except OSError:
            return True
        return True


class WorkerRegistry:
    """Directory of :class:`WorkerRecord` files.

    Writers call :meth:`announce` once and :meth:`heartbeat`
    periodically; :meth:`withdraw` removes the record on orderly
    shutdown.  Readers call :meth:`workers` (live records only) or
    :meth:`lookup`.  All reads tolerate concurrent writers and
    garbage files.
    """

    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, worker_id: str) -> str:
        # worker ids become filenames: refuse separators outright
        wid = str(worker_id)
        if not wid or "/" in wid or "\\" in wid or wid.startswith("."):
            raise ValueError(f"invalid worker id {worker_id!r}")
        return os.path.join(self.root, wid + _SUFFIX)

    # -- writer side ---------------------------------------------------

    def announce(self, record: WorkerRecord) -> None:
        record.started_at = record.started_at or time.time()
        record.heartbeat_at = time.time()
        self._write(record)

    def heartbeat(self, record: WorkerRecord) -> None:
        record.heartbeat_at = time.time()
        self._write(record)

    def _write(self, record: WorkerRecord) -> None:
        path = self._path(record.worker_id)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(record.to_dict(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def withdraw(self, worker_id: str) -> None:
        try:
            os.remove(self._path(worker_id))
        except FileNotFoundError:
            pass

    # -- reader side ---------------------------------------------------

    def lookup(self, worker_id: str) -> Optional[WorkerRecord]:
        """The record for ``worker_id``, or None when absent or
        unreadable (corrupt record == not announced)."""
        path = self._path(worker_id)  # id validation stays loud
        try:
            with open(path, encoding="utf-8") as f:
                return WorkerRecord.from_dict(json.load(f))
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def workers(self, live_only: bool = True) -> list:
        """All announced workers, sorted by slot then id; with
        ``live_only`` (the default) records whose pid is gone are
        skipped — a kill -9'd worker drops out of discovery without
        anyone withdrawing it."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in sorted(names):
            if not name.endswith(_SUFFIX):
                continue
            rec = self.lookup(name[: -len(_SUFFIX)])
            if rec is None:
                continue
            if live_only and not rec.alive():
                continue
            out.append(rec)
        out.sort(key=lambda r: (r.slot, r.worker_id))
        return out

    def wait_for(self, worker_id: str, timeout_s: float = 30.0,
                 poll_s: float = 0.05) -> WorkerRecord:
        """Block until ``worker_id`` announces (spawn rendezvous).
        Raises ``TimeoutError`` with the ids that DID announce, so a
        failed spawn is diagnosable from the exception alone."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            rec = self.lookup(worker_id)
            if rec is not None and rec.alive():
                return rec
            if time.monotonic() >= deadline:
                present = [r.worker_id for r in self.workers()]
                raise TimeoutError(
                    f"worker {worker_id!r} did not announce within "
                    f"{timeout_s}s (announced: {present})"
                )
            time.sleep(poll_s)
