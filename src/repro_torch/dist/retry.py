"""Retry with exponential backoff + seeded jitter, deadline-aware.

A copy of ``repro/dist/retry.py`` (numpy only, so a schedule equals the
reference's float for float). The one retry vocabulary of the port
(DESIGN.md §13): supervised restart (`fault.supervise`), checkpoint reads
(`checkpoint.restore`) and the modeled DiskANN-hybrid I/O path
(`HybridEngine.io_time`) all share this module.

Design points:

* **Seeded jitter.** `backoff_schedule(policy, seed=s)` is a pure function
  of (policy, seed): the same plan replays the same delays, so chaos drills
  (`fault.ChaosPlan`) and their assertions are deterministic. `seed=None`
  returns the nominal (un-jittered) schedule — what expectation models
  (`HybridEngine.io_time`) integrate over.
* **Deadline-aware attempt caps.** A `deadline_s` bounds *total* time spent
  (attempt latencies are the caller's; sleeps are ours): `call_with_retry`
  never starts a sleep that would cross the deadline — it re-raises the
  last error instead, so a caller with a 50 ms budget is never parked in a
  500 ms backoff.
* **Injectable clocks.** `sleep=`/`clock=` default to the real thing and are
  injectable for tests — the schedule is unit-tested with a fake sleep, no
  wall-clock flakiness.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np


class TransientIOError(OSError):
    """A read/fetch failure worth retrying (injected by chaos drills)."""


class DeadlineExceeded(TimeoutError):
    """Retries stopped because the deadline left no room for another try."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: delay_i = base · multiplier^i, capped, jittered.

    ``jitter`` is the symmetric relative amplitude: each delay is scaled by
    a seeded uniform draw from [1 - jitter, 1 + jitter] (full jitter would
    synchronize-at-zero; symmetric keeps the expectation at the nominal
    delay, which the I/O model relies on). ``deadline_s`` bounds the total
    time budget across all attempts (None = unbounded).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.01
    multiplier: float = 2.0
    max_delay_s: float = 1.0
    jitter: float = 0.1
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("RetryPolicy: max_attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("RetryPolicy: jitter must be in [0, 1)")


def backoff_schedule(policy: RetryPolicy,
                     seed: Optional[int] = None) -> list:
    """The sleep before retry attempt i+1, for i in [0, max_attempts-1).

    Deterministic in (policy, seed); ``seed=None`` gives the nominal
    un-jittered exponential.
    """
    nominal = [min(policy.base_delay_s * policy.multiplier ** i,
                   policy.max_delay_s)
               for i in range(policy.max_attempts - 1)]
    if seed is None or policy.jitter == 0.0:
        return nominal
    rng = np.random.default_rng(seed)
    lo, hi = 1.0 - policy.jitter, 1.0 + policy.jitter
    return [d * float(rng.uniform(lo, hi)) for d in nominal]


def call_with_retry(fn: Callable[[], object], *,
                    policy: RetryPolicy,
                    retry_on: Sequence[type] = (TransientIOError,),
                    seed: Optional[int] = None,
                    sleep: Callable[[float], None] = time.sleep,
                    clock: Callable[[], float] = time.monotonic,
                    on_retry: Optional[Callable[[int, BaseException],
                                                None]] = None):
    """Call ``fn()`` with up to ``policy.max_attempts`` tries.

    Only exceptions matching ``retry_on`` are retried; anything else
    propagates immediately (a genuine bug should crash loudly, not loop).
    When a ``policy.deadline_s`` is set and the next backoff sleep would
    cross it, raises :class:`DeadlineExceeded` chained from the last error.
    Returns ``(result, n_retries)``.
    """
    retry_on = tuple(retry_on)
    delays = backoff_schedule(policy, seed)
    t0 = clock()
    for attempt in range(policy.max_attempts):
        try:
            return fn(), attempt
        except retry_on as e:  # noqa: PERF203 - retry loop is cold
            if attempt >= policy.max_attempts - 1:
                raise
            delay = delays[attempt]
            if (policy.deadline_s is not None
                    and clock() - t0 + delay > policy.deadline_s):
                raise DeadlineExceeded(
                    f"retry deadline {policy.deadline_s}s would be exceeded "
                    f"by a {delay:.3f}s backoff after attempt "
                    f"{attempt + 1}/{policy.max_attempts}") from e
            if on_retry is not None:
                on_retry(attempt + 1, e)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover


def expected_retry_time_s(policy: RetryPolicy, attempt_latency_s: float,
                          fail_p: float) -> float:
    """Expected total time of one retried call under i.i.d. failures.

    Attempt a (0-indexed) runs with probability fail_p^a (all previous
    attempts failed) and costs ``attempt_latency_s``; the backoff sleep
    before it is paid with the same probability. A call whose final attempt
    also fails is still charged its full time (the caller then degrades or
    errors — the time was spent either way). This closed form is what
    ``HybridEngine.io_time`` adds per modeled read: deterministic, no
    sampling, exact in expectation under the policy's nominal schedule.
    """
    delays = backoff_schedule(policy, seed=None)
    total = 0.0
    for a in range(policy.max_attempts):
        p_reach = fail_p ** a
        total += p_reach * attempt_latency_s
        if a >= 1:
            total += p_reach * delays[a - 1]
    return total
