"""Warm-boot serving: the serve layer's hierarchy-cache entries persisted,
and a fresh service filled from disk at startup (the JAX package's
``store/warmboot.py``).

A ``BatchedSolveService(store=...)`` exports every hierarchy entry it
builds (the template solver and the padded pattern) to its
:class:`~amgx_tpu_torch.store.store.ArtifactStore` on the shared
background worker (:func:`amgx_tpu_torch.serve.cache._compile_pool`),
keyed by (padded fingerprint, config hash, dtype).  A new process calls
``service.warm_boot()``: every persisted entry of the service's
configuration is restored on that worker (the restore runs no setup)
and inserted into the :class:`~amgx_tpu_torch.serve.cache.HierarchyCache`,
then its batched solve is built for the entry's persisted batch bucket
(the last bucket it flushed at, or the full-group bucket).  The first
request for a persisted pattern is then a cache hit, with no setup.

The payload is the JAX package's (``serialize.py``, schema version 1):
a serve entry written by either package restores in the other.

The JAX package also points XLA's persistent compile cache into the
store (``enable_persistent_compile_cache``).  The port compiles no
program per pattern: its kernels are built once per checkout into
``amgx_tpu_torch/_build/`` (``ops/kernels.py``), which is what that
cache is to the JAX package, and a restored entry's "compile" is the
build of its batched solve function.

Restores follow the store's failure contract: a corrupt, stale or
incompatible entry counts (``warmboot_failures``) and is skipped; the
service sets the pattern up afresh on first use and never raises.
"""

from __future__ import annotations

import numpy as np

from amgx_tpu_torch.core.errors import StoreError
from amgx_tpu_torch.store import serialize

ENTRY_KIND = "serve_entry"


# ---------------------------------------------------------------------------
# the padded pattern (host numpy only)


def _pattern_tree(pat) -> dict:
    return {
        "row_offsets": np.asarray(pat.row_offsets),
        "col_indices": np.asarray(pat.col_indices),
        "scatter": np.asarray(pat.scatter),
        "ones_pos": np.asarray(pat.ones_pos),
        "n": int(pat.n),
        "nnz": int(pat.nnz),
        "nb": int(pat.nb),
        "nnzb": int(pat.nnzb),
        "max_row_len": int(pat.max_row_len),
        "num_diagonals": int(pat.num_diagonals),
        "fingerprint": str(pat.fingerprint),
    }


def _pattern_from_tree(tree: dict):
    from amgx_tpu_torch.serve.bucketing import PaddedPattern

    try:
        return PaddedPattern(
            row_offsets=np.asarray(tree["row_offsets"], np.int32),
            col_indices=np.asarray(tree["col_indices"], np.int32),
            scatter=np.asarray(tree["scatter"], np.int64),
            ones_pos=np.asarray(tree["ones_pos"], np.int64),
            n=int(tree["n"]),
            nnz=int(tree["nnz"]),
            nb=int(tree["nb"]),
            nnzb=int(tree["nnzb"]),
            max_row_len=int(tree["max_row_len"]),
            num_diagonals=int(tree["num_diagonals"]),
            fingerprint=str(tree["fingerprint"]),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise StoreError(f"malformed serve-entry pattern: {e}") from e


# ---------------------------------------------------------------------------
# export and restore of hierarchy-cache entries


def entry_key(store, fingerprint: str, cfg_key: str, dtype) -> str:
    return store.entry_key(fingerprint, cfg_key, str(np.dtype(dtype)),
                           kind=ENTRY_KIND)


def export_entry(service, entry, dtype) -> bool:
    """Write one hierarchy-cache entry to the service's store.  The
    template solver is shared (the sequential fallback, the quarantine
    and the sessions' cadence resetup it), so the capture of its state
    runs under its lock; the copy to the host and the write run outside
    it (a resetup replaces the solver's tensors, it does not write into
    them).  False on any failure (the caller counts it)."""
    store = service.store
    if store is None:
        return False
    dtype_s = str(np.dtype(dtype))
    meta = serialize.solver_meta(entry.solver)
    with entry.solver_lock:
        entry.settle()
        tree = {
            "solver": entry.solver._export_setup(),
            "pattern": _pattern_tree(entry.pattern),
        }
        spec, arrays = serialize.flatten(tree)
    arrays = serialize.materialize(arrays)
    from amgx_tpu_torch.serve.bucketing import bucket_batch

    # the restored entry's build target: the bucket this entry last
    # flushed at (an export can run before any flush), else the
    # full-group bucket
    bucket = None
    if entry.signature is not None:
        bucket = service._last_bucket.get(entry.signature)
    manifest = dict(meta)
    manifest.update(
        kind=ENTRY_KIND, spec=spec,
        pattern_fingerprint=entry.pattern.fingerprint,
        cfg_key=service.cfg_key, dtype=dtype_s,
        bucket=bucket or bucket_batch(service.max_batch),
    )
    key = entry_key(store, entry.pattern.fingerprint, service.cfg_key,
                    dtype_s)
    return store.put(key, arrays, manifest)


def export_all(service) -> int:
    """Write every entry of the service's hierarchy cache now (a drain:
    the replacement worker must find the hot patterns on disk).  An
    entry already on disk under its key is skipped
    (``store_export_skips``), so ``store_exports`` counts entries
    written.  Best-effort per entry.  Returns the number on disk (written
    now or before)."""
    store = service.store
    if store is None:
        return 0
    exported = 0
    for (fp, cfg_key, dtype_s), entry in service.cache.items():
        try:
            key = entry_key(store, fp, cfg_key, dtype_s)
            if store.has(key):
                service.metrics.inc("store_export_skips")
                exported += 1
                continue
            if export_entry(service, entry, dtype_s):
                exported += 1
                service.metrics.inc("store_exports")
            else:
                service.metrics.inc("store_export_failures")
        except Exception:  # noqa: BLE001 — a drain stays best-effort
            service.metrics.inc("store_export_failures")
    return exported


def restore_entry(service, manifest: dict, arrays):
    """A HierarchyEntry from a store payload, on the service's device:
    the tail of the service's ``_build_entry`` without the setup (the
    restored template solver is set up; its batch template and batched
    solve derive from it)."""
    from amgx_tpu_torch.serve.batched import make_batched_solve
    from amgx_tpu_torch.serve.cache import (
        HierarchyEntry,
        template_signature,
    )

    serialize.check_schema(manifest)
    if manifest.get("kind") != ENTRY_KIND:
        raise StoreError(
            f"payload kind {manifest.get('kind')!r} is not a serve entry")
    tree = serialize.unflatten(manifest.get("spec"), arrays, service.device)
    if not isinstance(tree, dict) or "solver" not in tree \
            or "pattern" not in tree:
        raise StoreError("malformed serve-entry payload tree")
    solver = serialize.build_solver(manifest, tree["solver"],
                                    cfg=service.cfg, device=service.device)
    pattern = _pattern_from_tree(tree["pattern"])
    bp = solver.make_batch_params()
    batch_fn = make_batched_solve(solver)
    template = bp[0] if bp is not None else None
    sig = template_signature(template) if batch_fn is not None else None
    return HierarchyEntry(solver=solver, template=template,
                          batch_fn=batch_fn, signature=sig, pattern=pattern)


def warm_boot(service, wait: bool = True, compile: bool = True) -> int:
    """Fill a service's hierarchy cache from its store.

    Each serve entry of the service's config hash restores on the
    shared background worker and, with ``compile``, builds its batched
    solve for the entry's persisted bucket.  ``wait=True`` returns the
    number restored once every restore settled; ``wait=False`` returns
    the number scheduled at once (a server overlaps its restores with
    live traffic: a request that races its own restore misses and sets
    up afresh)."""
    from amgx_tpu_torch.serve.cache import _compile_pool

    store = service.store
    if store is None:
        return 0
    jobs = [(key, side) for key, side in store.entries()
            if side.get("kind") == ENTRY_KIND
            and side.get("cfg_key") == service.cfg_key]

    def restore_one(key, side):
        try:
            service._enter_device()
            hit = store.get(key)
            if hit is None:
                raise StoreError(f"store entry {key} unreadable")
            manifest, arrays = hit
            entry = restore_entry(service, manifest, arrays)
            service.cache.insert(entry.pattern.fingerprint, service.cfg_key,
                                 manifest.get("dtype", side.get("dtype")),
                                 entry)
            service.metrics.inc("warmboot_restores")
            if compile and entry.batch_fn is not None:
                bb = int(manifest.get("bucket") or service.max_batch)
                service.compile_cache.warm(entry, bb)
            return True
        except Exception:  # noqa: BLE001 — degrade to a cold start
            service.metrics.inc("warmboot_failures")
            return False

    futures = [_compile_pool().submit(restore_one, key, side)
               for key, side in jobs]
    if not wait:
        return len(futures)
    return sum(1 for f in futures if f.result())
