"""On-disk setup-artifact store: content-addressed, atomic, LRU (the
JAX package's ``store/store.py``).

One entry is two files under the store root:

  * ``<key>.npz``: the payload (arrays and embedded manifest) in
    :mod:`amgx_tpu_torch.store.serialize`'s format, so every entry
    also loads with ``load_setup``;
  * ``<key>.json``: the manifest beside the payload's blake2b digest
    and byte size, readable without the payload.

Keys are content hashes of ``(kind, sparsity fingerprint, config hash,
dtype, schema version)``: the identity under which a setup is
reusable.  Writes go to a temporary file and ``os.replace``, so a
crashed writer leaves the old entry or none.  Reads verify the digest;
any defect (a missing file, a torn write, flipped bits, unparseable
JSON, a stale schema) is a counted miss, never an exception: the store
cannot make a solve fail or answer wrongly.  A size budget
(``AMGX_TPU_STORE_MB``, default 512) is enforced after each put by
evicting the least recently used entries (a hit refreshes the
mtimes).  Each store registers a ``store`` source in the telemetry
registry (:meth:`ArtifactStore.telemetry_snapshot`, the
``amgx_store_*`` families), as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Iterator, Optional, Tuple

from amgx_tpu_torch.store import serialize

_DEFAULT_BUDGET_MB = 512


class ArtifactStore:
    """Directory-backed artifact store (process-safe best-effort:
    atomic replaces; concurrent writers race benignly, torn reads are
    caught by the digest check and degrade to misses)."""

    def __init__(self, root, max_bytes: Optional[int] = None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        if max_bytes is None:
            mb = os.environ.get("AMGX_TPU_STORE_MB")
            max_bytes = int(
                float(mb) * 2**20 if mb else _DEFAULT_BUDGET_MB * 2**20
            )
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self.counters: dict = defaultdict(int)
        self._sweep_tmp()
        # a weak reference: registering never extends the store's life
        from amgx_tpu_torch.telemetry import get_registry

        self.telemetry_name = get_registry().register("store", self)

    def telemetry_snapshot(self) -> dict:
        """Registry source (kind ``store``): the counters, the entries
        on disk and the byte budget."""
        return {
            "counters": self.stats(),
            "entries": len(self),
            "max_bytes": self.max_bytes,
        }

    # tmp files older than this are crash leftovers, not live writers
    _TMP_MAX_AGE_S = 300.0

    def _sweep_tmp(self):
        """Remove stale ``*.tmp.*`` files left by crashed writers —
        they are invisible to the size budget and would otherwise
        accumulate unbounded.  Recent ones are spared (another process
        may be mid-write)."""
        now = time.time()
        try:
            for name in os.listdir(self.root):
                if ".tmp." not in name:
                    continue
                p = os.path.join(self.root, name)
                try:
                    if now - os.stat(p).st_mtime > self._TMP_MAX_AGE_S:
                        os.remove(p)
                        self._count("tmp_sweeps")
                except OSError:
                    pass
        except OSError:
            pass

    # -- keys ----------------------------------------------------------

    @staticmethod
    def entry_key(
        fingerprint: str, config_hash: str, dtype,
        kind: str = "solver_setup",
    ) -> str:
        """Content key for one reusable setup identity.  The schema
        version is part of the key, so a schema bump makes every old
        entry unreachable (a miss) without a migration pass."""
        h = hashlib.blake2b(digest_size=16)
        h.update(
            f"{kind}|{fingerprint}|{config_hash}|{dtype}"
            f"|v{serialize.SCHEMA_VERSION}".encode()
        )
        return h.hexdigest()

    def _paths(self, key: str) -> Tuple[str, str]:
        return (
            os.path.join(self.root, key + ".npz"),
            os.path.join(self.root, key + ".json"),
        )

    def _count(self, name: str, by: int = 1):
        with self._lock:
            self.counters[name] += by

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters)

    # -- write ---------------------------------------------------------

    def put(self, key: str, arrays: dict, manifest: dict) -> bool:
        """Atomically write one entry; returns False (counted) instead
        of raising on any I/O failure — persistence is an optimization,
        never a solve-path liability."""
        try:
            manifest = dict(manifest)
            manifest.setdefault(
                "schema_version", serialize.SCHEMA_VERSION
            )
            blob = serialize.payload_bytes(arrays, manifest)
            digest = hashlib.blake2b(blob, digest_size=16).hexdigest()
            side = dict(manifest)
            side["key"] = key
            side["payload_blake2b"] = digest
            side["payload_bytes"] = len(blob)
            side["stored_unix"] = time.time()
            # the spec tree can be large; the sidecar is for scanning
            side.pop("spec", None)
            npz_path, json_path = self._paths(key)
            self._atomic_write(npz_path, blob)
            self._atomic_write(
                json_path, json.dumps(side).encode()
            )
            self._count("puts")
            self._enforce_budget()
            return True
        except Exception:
            self._count("put_failures")
            return False

    def _atomic_write(self, path: str, data: bytes):
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- read ----------------------------------------------------------

    def _read_entry(self, key: str):
        """One (sidecar, blob) read attempt.  Returns (side, blob),
        or a string verdict: 'missing' / 'stale' / 'corrupt'."""
        npz_path, json_path = self._paths(key)
        try:
            with open(json_path, "rb") as f:
                side = json.loads(f.read())
            if not isinstance(side, dict):
                raise ValueError("sidecar is not an object")
        except FileNotFoundError:
            return "missing"
        except Exception:
            return "corrupt"
        if side.get("schema_version") != serialize.SCHEMA_VERSION:
            return "stale"
        try:
            with open(npz_path, "rb") as f:
                blob = f.read()
        except OSError:
            return "corrupt"
        return side, blob

    def has(self, key: str) -> bool:
        """Verified presence probe: both files exist, the sidecar's
        schema matches, AND the payload digest verifies — the blob
        was already read, so hashing it is the marginal cost of not
        telling a drain-time exporter to skip a good in-memory
        hierarchy in favour of a torn/corrupt on-disk pair (which the
        replacement worker's ``get`` would then delete and
        cold-compile past).  Never deletes; a failed probe just
        reads as absent so the caller re-exports over it."""
        got = self._read_entry(key)
        if isinstance(got, str):
            return False
        side, blob = got
        digest = hashlib.blake2b(blob, digest_size=16).hexdigest()
        return digest == side.get("payload_blake2b")

    def get(self, key: str):
        """(manifest, arrays) for a verified entry, or None — a miss.
        Corrupt entries (digest/JSON/npz failures) are deleted and
        counted under ``corrupt_entries``; stale schemas under
        ``stale_schema``; both read as plain misses to callers.

        The sidecar and payload are two separate atomic writes, so a
        reader racing a concurrent re-put can pair an old sidecar with
        a new payload: on digest mismatch, retry with fresh reads
        once, and if the sidecar CHANGED between attempts treat it as
        a plain miss (an active writer, not rot) instead of deleting a
        just-written valid entry."""
        first_side = None
        for attempt in range(2):
            got = self._read_entry(key)
            if got == "missing":
                self._count("misses")
                return None
            if got == "stale":
                self._count("stale_schema")
                self._count("misses")
                return None
            if got == "corrupt":
                self._drop_corrupt(key)
                return None
            side, blob = got
            digest = hashlib.blake2b(blob, digest_size=16).hexdigest()
            if digest == side.get("payload_blake2b"):
                break
            if attempt == 0:
                first_side = side
                continue
            if side != first_side:
                # writer is actively replacing this entry: back off
                self._count("torn_reads")
                self._count("misses")
                return None
            self._drop_corrupt(key)
            return None
        try:
            arrays, manifest = serialize.read_payload(blob)
        except Exception:
            self._drop_corrupt(key)
            return None
        npz_path, json_path = self._paths(key)
        now = time.time()
        for p in (npz_path, json_path):
            try:
                os.utime(p, (now, now))  # LRU bump
            except OSError:
                pass
        self._count("hits")
        return manifest, arrays

    # -- solvers -------------------------------------------------------

    def setup_key(self, solver) -> str:
        """The entry key of a set-up solver."""
        fp, dtype = solver.A.setup_key()
        return self.entry_key(fp, solver.cfg.content_hash(), dtype)

    def put_setup(self, solver):
        """Store a set-up solver under :meth:`setup_key`; the key, or
        None (counted) where its setup cannot be written."""
        try:
            manifest = serialize.solver_meta(solver)
            spec, arrays = serialize.flatten(solver._export_setup())
        except Exception:  # noqa: BLE001 — persistence never raises
            self._count("put_failures")
            return None
        manifest["spec"] = spec
        key = self.setup_key(solver)
        return key if self.put(key, arrays, manifest) else None

    def get_setup(self, key: str, cfg=None, device="cuda"):
        """The solver of entry ``key`` restored on ``device`` (default
        the card) without setup, or None: a miss, counted, for a missing,
        corrupt or stale entry, and for a payload the restore refuses
        (``restore_failures``: a stale artifact, another configuration
        than ``cfg``), which is then deleted."""
        got = self.get(key)
        if got is None:
            return None
        manifest, arrays = got
        try:
            serialize.check_schema(manifest)
            tree = serialize.unflatten(manifest.get("spec"), arrays, device)
            return serialize.build_solver(manifest, tree, cfg=cfg,
                                          device=device)
        except Exception:  # noqa: BLE001 — a defect is a miss
            self._count("restore_failures")
            self._count("misses")
            self._count("hits", -1)
            self.delete(key)
            return None

    def _drop_corrupt(self, key: str):
        self._count("corrupt_entries")
        self._count("misses")
        self.delete(key)

    def delete(self, key: str):
        for p in self._paths(key):
            try:
                os.remove(p)
            except OSError:
                pass

    # -- scan ----------------------------------------------------------

    def entries(self) -> Iterator[Tuple[str, dict]]:
        """(key, sidecar manifest) for every scannable entry of the
        CURRENT schema version; unparseable sidecars are skipped (and
        counted) — a scan can never raise on a dirty store."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            key = name[: -len(".json")]
            try:
                with open(os.path.join(self.root, name), "rb") as f:
                    side = json.loads(f.read())
                if not isinstance(side, dict):
                    raise ValueError
            except Exception:
                self._count("corrupt_entries")
                continue
            if side.get("schema_version") != serialize.SCHEMA_VERSION:
                self._count("stale_schema")
                continue
            yield key, side

    def __len__(self):
        try:
            return sum(
                1 for n in os.listdir(self.root) if n.endswith(".json")
            )
        except OSError:
            return 0

    # -- budget --------------------------------------------------------

    def _enforce_budget(self):
        """Evict least-recently-used entries until under budget."""
        self._sweep_tmp()
        if self.max_bytes <= 0:
            return
        try:
            ents = []
            total = 0
            for name in os.listdir(self.root):
                if not name.endswith(".npz"):
                    continue
                key = name[: -len(".npz")]
                size = 0
                mtime = None
                for p in self._paths(key):
                    try:
                        st = os.stat(p)
                    except OSError:
                        continue
                    size += st.st_size
                    mtime = (
                        st.st_mtime
                        if mtime is None
                        else max(mtime, st.st_mtime)
                    )
                if mtime is None:
                    continue
                ents.append((mtime, key, size))
                total += size
            ents.sort()
            # never evict the NEWEST entry: a single payload larger
            # than the whole budget would otherwise wipe every other
            # entry and then itself on every put — the store would
            # read as healthy (puts counted) while every get misses.  One oversized entry staying over budget is the
            # lesser failure; it is counted so operators can see it.
            i = 0
            while total > self.max_bytes and i < len(ents) - 1:
                _, key, size = ents[i]
                self.delete(key)
                self._count("evictions")
                total -= size
                i += 1
            if total > self.max_bytes:
                self._count("budget_overflows")
        except Exception:
            # budget enforcement is best-effort housekeeping
            self._count("budget_failures")

    def clear(self):
        for name in list(os.listdir(self.root)):
            if name.endswith((".npz", ".json")):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
