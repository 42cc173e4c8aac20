"""Hierarchy cache: one solver setup per (padded sparsity fingerprint,
config, dtype), shared by every request that reuses the pattern (the
JAX package's ``serve/cache.py``).

The service-side form of ``AMGX_solver_resetup`` /
``structure_reuse_levels``: the hierarchy STRUCTURE (aggregates,
transfer weights, Galerkin plans, colourings) is the one computed from
the first-seen coefficient set; later coefficient sets re-evaluate the
values only, through the solver's batch rebuild
(``make_batch_params``, ``serve/batched.py``).

:class:`CompileCache` is the port's counterpart of the JAX package's
cache of compiled executables: PyTorch runs eagerly, so what it keeps
per (template signature, batch bucket) is the built batched-solve
callable, which every entry of an equal signature reuses with its own
template.  ``compiles`` counts its builds and ``bucket_hits`` its
hits, so the JAX package's counter contracts carry over.  A build
ahead of the first flush (:meth:`CompileCache.warm`: ``prewarm``, a warm
boot's restored entries) runs on the shared background worker
(:func:`_compile_pool`), which the store's exports share too; a flush
that finds the build in flight joins it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Optional

import torch

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.dispatch import named_pool, on_worker
from amgx_tpu_torch.serve.bucketing import PaddedPattern
from amgx_tpu_torch.serve.metrics import ServeMetrics


def config_hash(cfg) -> str:
    """Stable content hash of an AMGConfig (the store keys on it too)."""
    return cfg.content_hash()


@dataclasses.dataclass
class HierarchyEntry:
    """One cached setup: the template solver, its batch template and
    its batched solve (None: no batched path, the service solves each
    request in turn)."""

    solver: object  # set-up Solver (on the padded template matrix)
    template: object  # batch-params template (None: no batched path)
    batch_fn: Optional[Callable]  # fn(template, vals_B, b_B, x0_B)
    signature: object  # hashable description of the template
    pattern: PaddedPattern
    # serializes resetup + solve on the SHARED template solver (the
    # sequential fallback and quarantine paths mutate it)
    solver_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock
    )
    # the template solver's last solve(block=False) (the sequential
    # fallback's), which may still run on the dispatch worker
    pending: object = None
    # the batch buckets whose batched solve has run a group (the first
    # group of each is cold: the watchdog leaves its seconds out)
    ran_buckets: set = dataclasses.field(default_factory=set)

    def settle(self):
        """Wait for the template solver's solve in flight, if any (the
        caller holds ``solver_lock``): a resetup or an export must not
        change the solver under it.  Its outcome, an error included,
        stays with its ticket."""
        p, self.pending = self.pending, None
        fut = getattr(p, "_future", None)
        if fut is not None:
            concurrent.futures.wait([fut])


def template_signature(template) -> tuple:
    """Hashable description of a batch template: its nesting, and for
    each matrix its shape, nonzeros, dtype, format and the format's
    static layout (DIA offsets, ELL width, dense shape), for each tensor
    its shape and dtype.  Two entries with equal signatures and config
    run the same batched solve on their own templates, so they share
    one built callable (the JAX package's treedef-and-leaf-shapes
    signature)."""
    from amgx_tpu_torch.core.matrix import SparseMatrix

    def sig(node):
        if node is None or isinstance(node, (int, float, str, bool)):
            return node
        if isinstance(node, torch.Tensor):
            return ("T", tuple(node.shape), str(node.dtype))
        if isinstance(node, SparseMatrix):
            return ("M", node.n_rows, node.n_cols, node.nnz,
                    node.block_size, str(node.dtype), node.format,
                    node.dia_offsets,
                    None if node.ell_cols is None
                    else tuple(node.ell_cols.shape),
                    None if node.dense is None else tuple(node.dense.shape))
        if isinstance(node, dict):
            return ("D",) + tuple((k, sig(v)) for k, v in sorted(
                node.items()))
        if isinstance(node, (tuple, list)):
            return ("S",) + tuple(sig(v) for v in node)
        if dataclasses.is_dataclass(node):
            return (type(node).__name__,) + tuple(
                (f.name, sig(getattr(node, f.name)))
                for f in dataclasses.fields(node))
        raise TypeError(
            f"template_signature: no signature for {type(node).__name__}")

    return sig(template)


class HierarchyCache:
    """LRU cache: (padded fingerprint, config hash, dtype) -> entry.
    ``on_evict(key, entry)`` runs, outside the lock, for every evicted
    entry (the service drops the entry's built solves with it)."""

    def __init__(self, max_entries: int = 64,
                 metrics: Optional[ServeMetrics] = None,
                 on_evict: Optional[Callable] = None):
        self.max_entries = max_entries
        self.metrics = metrics or ServeMetrics()
        self.on_evict = on_evict
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()

    def __len__(self):
        return len(self._entries)

    def _insert(self, key, entry):
        evicted = []
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                evicted.append(self._entries.popitem(last=False))
                self.metrics.inc("cache_evictions")
        if self.on_evict is not None:
            for k, e in evicted:
                try:
                    self.on_evict(k, e)
                except Exception:  # noqa: BLE001 — eviction housekeeping
                    pass

    def insert(self, fingerprint: str, cfg_key: str, dtype,
               entry: HierarchyEntry):
        """Insert a built entry (a warm boot's restore): neither a hit
        nor a miss; the LRU bound holds."""
        self._insert((fingerprint, cfg_key, str(dtype)), entry)

    def items(self) -> list:
        """((fingerprint, cfg_key, dtype), entry) of every cached entry,
        least recently used first."""
        with self._lock:
            return list(self._entries.items())

    def any_with_signature(self, signature) -> bool:
        """Does any cached entry share this template signature?"""
        with self._lock:
            return any(e.signature == signature
                       for e in self._entries.values())

    def peek(self, fingerprint: str, cfg_key: str, dtype
             ) -> Optional[HierarchyEntry]:
        """The cached entry or None; never builds."""
        key = (fingerprint, cfg_key, str(dtype))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def get_or_build(self, pattern: PaddedPattern, cfg_key: str, dtype,
                     build: Callable[[], HierarchyEntry]) -> HierarchyEntry:
        key = (pattern.fingerprint, cfg_key, str(dtype))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.metrics.inc("cache_hits")
                return entry
        # build outside the lock: setup takes seconds, and other
        # fingerprints must not queue behind it
        self.metrics.inc("cache_misses")
        self.metrics.inc("setups")
        entry = build()
        self._insert(key, entry)
        return entry

    def bytes_by_dtype(self) -> dict:
        """Resident bytes of every cached entry (the template solver's
        params and the batch template), per tensor dtype (``{"float64":
        n, "int32": m, ...}``; ``amgx_cache_hierarchy_bytes{dtype=...}``).
        A tensor reached twice counts once."""
        out: dict = {}
        for _fmt, t in self._resident():
            key = str(t.dtype).replace("torch.", "")
            out[key] = out.get(key, 0) + t.nbytes
        return out

    def bytes_by_format(self) -> dict:
        """The same bytes per format of the matrix that holds them
        (``MATRIX_FREE``, ``DIA``, ``DENSE``, ``ELL``, ``CSR``; ``other``
        for tensors outside a matrix;
        ``amgx_cache_hierarchy_bytes{format=...}``)."""
        out: dict = {}
        for fmt, t in self._resident():
            out[fmt] = out.get(fmt, 0) + t.nbytes
        return out

    def _resident(self):
        """(format, tensor) of every tensor the cached entries hold, each
        once."""
        from amgx_tpu_torch.core.matrix import SparseMatrix

        with self._lock:
            entries = list(self._entries.values())
        seen: set = set()
        found = []

        def walk(node, fmt):
            if id(node) in seen or node is None:
                return
            seen.add(id(node))
            if isinstance(node, torch.Tensor):
                found.append((fmt, node))
            elif isinstance(node, SparseMatrix):
                for v in vars(node).values():
                    walk(v, node.format.upper())
            elif isinstance(node, (tuple, list)):
                for v in node:
                    walk(v, fmt)
            elif isinstance(node, dict):
                for v in node.values():
                    walk(v, fmt)
            elif hasattr(node, "__dict__") and not callable(node):
                for v in vars(node).values():
                    walk(v, fmt)

        for e in entries:
            walk(getattr(e.solver, "_params", None), "other")
            walk(e.template, "other")
        return found


# the process-wide background worker: builds ahead of a flush (prewarm,
# a warm boot's restores and their builds) and the store's exports of
# every service share one thread, so none of them runs on a flush path
# or on the dispatch worker
_COMPILE = "serve-compile"


def _compile_pool() -> concurrent.futures.ThreadPoolExecutor:
    return named_pool(_COMPILE)


class CompileCache:
    """(template signature, batch bucket) -> the built batched-solve
    callable: the first entry of a signature builds it (``compiles``),
    every later lookup of the signature, from any entry, hits
    (``bucket_hits``).  :meth:`warm` builds ahead of the first flush on
    the background worker (``compile_warmups``); a :meth:`get` that
    finds that build in flight waits for it.  A signature evicted while
    its build is in flight is tombstoned, so the finishing build hands
    its callable to its waiters but does not keep it."""

    def __init__(self, metrics: Optional[ServeMetrics] = None):
        self.metrics = metrics or ServeMetrics()
        self._lock = threading.Lock()
        self._fns: dict = {}
        self._futures: dict = {}
        self._dead_sigs: set = set()

    def __len__(self):
        return len(self._fns)

    def _compile(self, entry: HierarchyEntry, Bb: int):
        """Build the callable (the JAX package's AOT compile): each
        build owns its fault decisions, as each of the JAX package's
        compiles traces anew."""
        return faults.built(entry.batch_fn)

    def _resolve(self, key, entry: HierarchyEntry, Bb: int, fut):
        try:
            fn = self._compile(entry, Bb)
        except BaseException as e:  # every waiter sees the failure
            with self._lock:
                self._futures.pop(key, None)
            fut.set_exception(e)
            raise
        with self._lock:
            self._futures.pop(key, None)
            if key[0] not in self._dead_sigs:
                self._fns[key] = fn
        self.metrics.inc("compiles")
        fut.set_result(fn)
        return fn

    def get(self, entry: HierarchyEntry, Bb: int):
        """The callable for (entry.signature, Bb): cached, joined from a
        build in flight, or built here."""
        key = (entry.signature, Bb)
        with self._lock:
            self._dead_sigs.discard(key[0])  # the signature lives again
            fn = self._fns.get(key)
            if fn is not None:
                self.metrics.inc("bucket_hits")
                return fn
            fut = self._futures.get(key)
            mine = fut is None
            if mine:
                fut = self._futures[key] = concurrent.futures.Future()
        if mine:
            return self._resolve(key, entry, Bb, fut)
        return fut.result()

    def warm(self, entry: HierarchyEntry, Bb: int):
        """Build the callable for (entry.signature, Bb) ahead of the
        first flush, unless it exists or is being built: on the
        background worker, or right here when called there."""
        key = (entry.signature, Bb)
        with self._lock:
            self._dead_sigs.discard(key[0])
            if key in self._fns or key in self._futures:
                return
            fut = self._futures[key] = concurrent.futures.Future()
        self.metrics.inc("compile_warmups")

        def job():
            try:
                self._resolve(key, entry, Bb, fut)
            except Exception:  # noqa: BLE001 — on the future
                pass

        if on_worker(_COMPILE):
            job()
        else:
            _compile_pool().submit(job)

    def evict_signature(self, signature) -> int:
        """Drop every callable of one template signature (the hierarchy
        cache evicted its last entry) under ``compile_evictions``; a
        build of it in flight finishes for its waiters, tombstoned."""
        if signature is None:
            return 0
        with self._lock:
            keys = [k for k in self._fns if k[0] == signature]
            for k in keys:
                del self._fns[k]
            if any(k[0] == signature for k in self._futures):
                self._dead_sigs.add(signature)
        if keys:
            self.metrics.inc("compile_evictions", len(keys))
        return len(keys)
