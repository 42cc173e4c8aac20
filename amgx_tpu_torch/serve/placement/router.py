"""Fingerprint-affinity routing state (the JAX package's
``serve/placement/router.py``, its :class:`AffinityRouter`).

A hierarchy entry's expensive state lives where it was built: the
template solver, its batched solve and their working set.  Routing a
fingerprint back to the slot that served it last is free; routing it to
a slot that never saw it pays a setup (or a restore).  The
:class:`AffinityRouter` keeps that view per slot, which fingerprints
are warm where and how loaded each slot is:

  route(fingerprint):
      warm somewhere  -> that slot              (affinity hit)
      cold everywhere -> least-loaded slot      (the fingerprint becomes
                                                 warm there)

Load is the slot's routed, unsettled units, with its accumulated busy
seconds as the tie-break.  The router is pure host state; the port's
fleet (:class:`~amgx_tpu_torch.fleet.router.FleetRouter`) routes worker
processes with it.  The JAX package's ``AffinityPlacement``, which
routes a service's groups among devices with it, waits for the
multi-GPU port (ROADMAP.md, queue A.9): its spec parses and raises
``NotImplementedError`` (``policy.py``).

:data:`DEFAULT_ROW_THRESHOLD` and :data:`ENV_ROW_THRESHOLD` are the JAX
package's ``DistributedPlacement`` eligibility (``AMGX_TPU_DIST_ROWS``),
which the fleet's router reads for its oversized patterns.
"""

from __future__ import annotations

import threading
from typing import Optional

DEFAULT_ROW_THRESHOLD = 65536
ENV_ROW_THRESHOLD = "AMGX_TPU_DIST_ROWS"


class AffinityRouter:
    """Per-slot warm-fingerprint sets and load accounting, thread-safe."""

    def __init__(self, n_devices: int):
        if n_devices < 1:
            raise ValueError("AffinityRouter needs at least one device")
        self.n = int(n_devices)
        self._lock = threading.Lock()
        self._warm = [set() for _ in range(self.n)]
        self._outstanding = [0] * self.n
        self._busy_s = [0.0] * self.n
        self._groups = [0] * self.n
        self.hits = 0
        self.misses = 0

    def peek(self, fingerprint) -> Optional[int]:
        """The slot warm for ``fingerprint`` (no side effects), or None
        when it is cold everywhere."""
        with self._lock:
            for i in range(self.n):
                if fingerprint in self._warm[i]:
                    return i
        return None

    def route(self, fingerprint, allowed=None) -> tuple:
        """(slot, was_warm) for one unit of work; reserves one unit of
        the slot's load until :meth:`settle` / :meth:`release`.
        ``allowed`` (slots, or None for all) restricts the decision: a
        warm slot outside it is ignored and the least-loaded fallback
        picks inside it."""
        with self._lock:
            ok = (set(range(self.n)) if allowed is None
                  else set(allowed)) or set(range(self.n))
            for i in range(self.n):
                if i in ok and fingerprint in self._warm[i]:
                    self.hits += 1
                    self._outstanding[i] += 1
                    return i, True
            i = min(sorted(ok),
                    key=lambda j: (self._outstanding[j], self._busy_s[j]))
            self.misses += 1
            self._warm[i].add(fingerprint)
            self._outstanding[i] += 1
            return i, False

    def route_to(self, fingerprint, index: int) -> tuple:
        """Route to ``index`` (a breaker's half-open probe), with
        :meth:`route`'s accounting."""
        with self._lock:
            warm = fingerprint in self._warm[index]
            if warm:
                self.hits += 1
            else:
                self.misses += 1
                self._warm[index].add(fingerprint)
            self._outstanding[index] += 1
            return index, warm

    def settle(self, index: int, device_s: float) -> None:
        """A routed unit completed: release its load, charge its
        seconds."""
        with self._lock:
            self._outstanding[index] = max(self._outstanding[index] - 1, 0)
            self._busy_s[index] += float(device_s)
            self._groups[index] += 1

    def release(self, index: int) -> None:
        """A routed unit failed before completing: release its load
        without charging time."""
        with self._lock:
            self._outstanding[index] = max(self._outstanding[index] - 1, 0)

    def forget(self, fingerprint) -> None:
        """The fingerprint's state is gone everywhere: stop routing for
        it."""
        with self._lock:
            for w in self._warm:
                w.discard(fingerprint)

    def forget_device(self, index: int) -> int:
        """The slot was lost or replaced: every fingerprint warm there
        re-routes.  Returns how many were forgotten."""
        with self._lock:
            n = len(self._warm[index])
            self._warm[index].clear()
            return n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "outstanding": list(self._outstanding),
                "busy_s": list(self._busy_s),
                "groups": list(self._groups),
                "warm_fingerprints": [len(w) for w in self._warm],
            }
