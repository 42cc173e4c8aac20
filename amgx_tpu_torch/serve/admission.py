"""Multi-tenant admission control of the gateway (the JAX package's
``serve/admission.py``): host state only, unit-testable on a scripted
clock.

* :class:`TokenBucket`: a tenant's rate quota, refilled continuously at
  ``rate`` tokens a second up to ``burst``; ``try_take`` admits
  (returns 0.0) or returns the seconds until the tokens are there, the
  ``retry_after_s`` of the typed rejection.
* :class:`AdmissionController`: the composed decision.  The tenant's
  quota, then its post-paid device-seconds budget, then the concurrency
  budget (the batch lane sheds at ``(1 - interactive_reserve_frac)`` of
  it, so batch work never takes the interactive lane's room), then the
  deadline predictor.

The controller never looks at the service: the gateway hands it the
pipeline's end-to-end p99 (the serve layer's latency reservoirs) as
``predicted_s``.  A missing percentile (None: a cold service) admits:
the first tickets are what fills the reservoir.  Rejections are the
typed :class:`~amgx_tpu_torch.core.errors.Overloaded` (budget, drain)
and its base :class:`~amgx_tpu_torch.core.errors.AdmissionRejected`
(quota, device budget, deadline, breaker), both with ``retry_after_s``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from amgx_tpu_torch.core.errors import AdmissionRejected, Overloaded


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's token bucket: ``rate`` requests a second, bursts up
    to ``burst``.  ``device_seconds_rate`` (optional) adds a budget of
    device seconds, refilled at that rate up to ``device_seconds_burst``
    (default 10 x the rate) and charged post-paid with each settled
    ticket's share of its group's device time: a tenant in debt is shed
    (``reason="device_budget"``, ``retry_after_s`` the refill time back
    to zero) until the refill clears it."""

    rate: float = 1000.0
    burst: float = 100.0
    device_seconds_rate: Optional[float] = None
    device_seconds_burst: Optional[float] = None


class TokenBucket:
    """Continuous-refill token bucket (the controller's lock guards it).
    The clock is injectable; the default is ``time.monotonic``."""

    __slots__ = ("rate", "burst", "tokens", "_t_last", "_clock")

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock
        self._t_last = clock()

    def try_take(self, n: float = 1.0) -> float:
        """Take ``n`` tokens if there are: 0.0 (admitted), else the
        seconds until ``n`` will have refilled; ``inf`` for a zero-rate
        bucket out of burst (the caller caps it)."""
        now = self._clock()
        if self.rate > 0:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t_last) * self.rate)
        self._t_last = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (n - self.tokens) / self.rate


def can_meet_deadline(deadline_s, predicted_s,
                      headroom: float = 1.0) -> bool:
    """The shed predictor: can a request with ``deadline_s`` seconds of
    slack complete, given the pipeline's tail estimate ``predicted_s``?
    No deadline, or no estimate, admits; only a deadline below
    ``headroom * predicted_s`` sheds."""
    if deadline_s is None or predicted_s is None:
        return True
    return float(deadline_s) >= headroom * float(predicted_s)


class AdmissionController:
    """The composed admission decision and the in-flight count.

    ``admit()`` reserves one unit of the concurrency budget (paired with
    ``release()`` when the request settles) or raises typed, cheapest
    gate first: the ``admission_quota`` fault site and the tenant's
    token bucket (``reason="quota"``); the tenant's device-seconds
    budget (``device_budget``); the concurrency budget, the batch lane's
    ceiling below the interactive one (:class:`Overloaded`,
    ``overloaded``); the deadline predictor (``deadline_unmeetable``),
    after the budget, so that an overloaded service answers with the
    back-off hint."""

    def __init__(self, max_inflight: int = 256,
                 interactive_reserve_frac: float = 0.25,
                 default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[dict] = None,
                 deadline_headroom: float = 1.0,
                 retry_after_cap_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_inflight = int(max_inflight)
        self.interactive_reserve_frac = float(interactive_reserve_frac)
        self.default_quota = default_quota  # None: unlimited
        self.quota_spec = dict(quotas or {})
        self.deadline_headroom = float(deadline_headroom)
        self.retry_after_cap_s = float(retry_after_cap_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict = {}
        self._device_buckets: dict = {}
        self.inflight = 0

    # -- quota ---------------------------------------------------------

    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        """The tenant's token bucket, made at first use from its quota
        (caller holds the lock); None: unlimited."""
        b = self._buckets.get(tenant)
        if b is not None:
            return b
        spec = self.quota_spec.get(tenant, self.default_quota)
        if spec is None:
            return None
        b = self._buckets[tenant] = TokenBucket(spec.rate, spec.burst,
                                                clock=self._clock)
        return b

    def _device_bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        """The tenant's device-seconds bucket (caller holds the lock);
        None when its quota has no device budget."""
        b = self._device_buckets.get(tenant)
        if b is not None:
            return b
        spec = self.quota_spec.get(tenant, self.default_quota)
        if spec is None or spec.device_seconds_rate is None:
            return None
        burst = (spec.device_seconds_burst
                 if spec.device_seconds_burst is not None
                 else 10.0 * spec.device_seconds_rate)
        b = self._device_buckets[tenant] = TokenBucket(
            spec.device_seconds_rate, burst, clock=self._clock)
        return b

    def charge_device_seconds(self, tenant: str, seconds: float,
                              lane: str = None) -> None:
        """Post-paid charge of a settled ticket's device seconds (the
        gateway wires it to ``ServeMetrics.on_tenant_device``); the
        balance may go negative, and :meth:`admit` sheds until the
        refill clears the debt."""
        with self._lock:
            b = self._device_bucket_for(tenant)
            if b is None:
                return
            b.try_take(0.0)  # refill to now before the debit
            b.tokens -= float(seconds)

    def _cap(self, retry_after: float) -> float:
        return min(retry_after, self.retry_after_cap_s)

    @property
    def batch_budget(self) -> int:
        """The batch lane's in-flight ceiling: the interactive reserve
        stays admittable when batch has filled its share."""
        return max(int(self.max_inflight
                       * (1.0 - self.interactive_reserve_frac)), 1)

    # -- the decision --------------------------------------------------

    def admit(self, tenant: str = "default", lane: str = "interactive",
              deadline_s: Optional[float] = None,
              predicted_s=None) -> None:
        """Admit (reserving one in-flight unit) or raise typed.
        ``predicted_s`` is a float, None or a callable of no argument,
        resolved at most once and outside the lock: up front for a
        request with a deadline (the gate needs it), else only for a
        budget shed's hint."""
        from amgx_tpu_torch.core import faults

        def resolve():
            return predicted_s() if callable(predicted_s) else predicted_s

        pred = resolve() if deadline_s is not None else None
        over = None
        with self._lock:
            bucket = self._bucket_for(tenant)
            if faults.should_fire("admission_quota"):
                raise AdmissionRejected(
                    f"tenant {tenant!r} quota exhausted (injected fault "
                    "site admission_quota)",
                    retry_after_s=self._cap(1.0), reason="quota")
            token_taken = False
            if bucket is not None:
                wait = bucket.try_take(1.0)
                if wait > 0.0:
                    raise AdmissionRejected(
                        f"tenant {tenant!r} over its request quota "
                        f"({bucket.rate:g}/s, burst {bucket.burst:g})",
                        retry_after_s=self._cap(wait), reason="quota")
                token_taken = True

            def refund():
                # a request shed by a later gate was never served: its
                # token goes back
                if token_taken:
                    bucket.tokens = min(bucket.burst, bucket.tokens + 1.0)

            dbucket = self._device_bucket_for(tenant)
            if dbucket is not None:
                # post-paid: admit while the balance is not negative;
                # try_take(0) refills to now and returns the seconds
                # back to a zero balance
                wait = dbucket.try_take(0.0)
                if wait > 0.0:
                    refund()
                    raise AdmissionRejected(
                        f"tenant {tenant!r} device-seconds budget "
                        f"exhausted ({dbucket.rate:g} dev-s/s refill, "
                        f"balance {dbucket.tokens:g}s)",
                        retry_after_s=self._cap(wait),
                        reason="device_budget")
            limit = (self.max_inflight if lane == "interactive"
                     else self.batch_budget)
            if self.inflight >= limit:
                # the hint may need the reservoir's sort: raise outside
                # the lock
                refund()
                over = (self.inflight, limit)
            elif not can_meet_deadline(deadline_s, pred,
                                       self.deadline_headroom):
                refund()
                raise AdmissionRejected(
                    f"deadline_s={float(deadline_s):g} cannot be met "
                    f"(current p99 {float(pred):g}s)",
                    retry_after_s=self._cap(float(pred)),
                    reason="deadline_unmeetable")
            else:
                self.inflight += 1
        if over is not None:
            inflight, limit = over
            # one pipeline tail latency of draining, where known
            hint = pred if deadline_s is not None else resolve()
            raise Overloaded(
                f"concurrency budget exhausted ({inflight} in flight, "
                f"{lane} lane limit {limit})",
                retry_after_s=self._cap(float(hint or 0.05)),
                reason="overloaded")

    def release(self, n: int = 1) -> None:
        """Return ``n`` in-flight units (their tickets settled)."""
        with self._lock:
            self.inflight = max(self.inflight - n, 0)

    def snapshot(self) -> dict:
        """Budget occupancy, each tenant's tokens, and each tenant's
        device-seconds balance refilled to now (read only)."""
        with self._lock:
            return {
                "inflight": self.inflight,
                "max_inflight": self.max_inflight,
                "batch_budget": self.batch_budget,
                "tenant_tokens": {t: b.tokens
                                  for t, b in self._buckets.items()},
                "tenant_device_tokens": {
                    t: min(b.burst, b.tokens + max(
                        self._clock() - b._t_last, 0.0) * b.rate)
                    for t, b in self._device_buckets.items()},
            }
