"""Client-side retry policy: jittered exponential backoff that honours
the typed shed hints (the JAX package's ``serve/retry.py``).

Every rejection of the gateway is typed (:class:`~amgx_tpu_torch.core.
errors.AdmissionRejected` / :class:`~amgx_tpu_torch.core.errors.
Overloaded`) and carries ``retry_after_s``, the back-off sized to the
event that restores capacity (a token refill, the breaker's probe
cadence, a drain hand-off).  A client sleeps that long::

    policy = RetryPolicy(max_attempts=5, base_s=0.05)
    res = policy.call(lambda: gw.submit(A, b, tenant="web").result())

* The retryable errors are the recoverable classes (admission sheds,
  deadline misses, device loss, which the serve layer has already
  requeued once) and any the caller lists.
* The sleep before retry ``k`` is ``base_s * factor**k``, or the error's
  ``retry_after_s`` where it has one, jittered by a seeded fraction and
  capped at ``max_s``.
* Any other error (a setup error, a validation reject) raises at once.

The jitter comes from a private ``numpy.random.Generator``: under a
seed the schedule is the same on every run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from amgx_tpu_torch.core.errors import (
    AdmissionRejected,
    DeadlineExceededError,
    DeviceLostError,
)

# the recoverable classes: a later attempt can succeed
DEFAULT_RETRYABLE = (
    AdmissionRejected,  # Overloaded too
    DeadlineExceededError,
    DeviceLostError,
)


@dataclasses.dataclass
class RetryPolicy:
    """Jittered exponential backoff honouring typed shed hints.

    ``max_attempts`` tries in all (the first counts); ``base_s`` and
    ``factor`` the exponential schedule; ``jitter_frac`` the uniform
    factor in ``[1 - j, 1 + j]``; ``max_s`` the cap of one sleep;
    ``retryable`` the classes worth a retry; ``seed`` the jitter
    stream's; ``sleep`` injectable for tests (``time.sleep``)."""

    max_attempts: int = 4
    base_s: float = 0.05
    factor: float = 2.0
    jitter_frac: float = 0.25
    max_s: float = 5.0
    retryable: tuple = DEFAULT_RETRYABLE
    seed: Optional[int] = None
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.retries = 0
        self.giveups = 0

    def backoff_s(self, attempt: int,
                  retry_after_s: Optional[float] = None) -> float:
        """The sleep before retry ``attempt`` (from 0): the hint where
        there is one, else ``base_s * factor**attempt``; jittered,
        capped at ``max_s``, never negative."""
        base = (float(retry_after_s) if retry_after_s is not None
                else self.base_s * self.factor ** attempt)
        if self.jitter_frac > 0:
            base *= 1.0 + self.jitter_frac * float(
                self._rng.uniform(-1.0, 1.0))
        return float(min(max(base, 0.0), self.max_s))

    def call(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` with retries: its result, or the last
        error after ``max_attempts`` (counted in ``giveups``), or a
        non-retryable error at once."""
        attempts = max(int(self.max_attempts), 1)
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:
                if attempt + 1 >= attempts:
                    self.giveups += 1
                    raise
                self.retries += 1
                self.sleep(self.backoff_s(
                    attempt, getattr(e, "retry_after_s", None)))
        raise AssertionError("unreachable")  # pragma: no cover
