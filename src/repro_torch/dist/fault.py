"""Fault tolerance: failure injection, supervised restart, partial merge,
quorum resolution, and the seeded chaos plan.

Port of ``repro/dist/fault.py``. The host-side pieces — ``FailureInjector``,
``supervise``, ``resolve_quorum``, ``ChaosPlan`` and ``corrupt_snapshot`` —
are numpy and plain Python, copied so that a plan or a schedule replays the
reference's exactly. :func:`partial_merge` recombines the shard shortlists
on their device (the JAX function merges on the host in numpy): a dead or
straggling shard degrades recall instead of failing the query, and
:func:`resolve_quorum` decides which shards count under a straggler
deadline. :func:`supervise` restarts a crashed driver up to
``max_restarts`` times with backoff (:mod:`repro_torch.dist.retry`);
paired with the per-step generators of ``core/trainer.fit``, a restart
replays the draws of the uninterrupted run.

:class:`ChaosPlan` (DESIGN.md §13) is the seeded fault script: dead
shards, stragglers, transient I/O errors, corrupted snapshot bytes and
crash phases, reproducible from one seed, parseable from a ``serve.py
--chaos`` spec string.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.dist.retry import (RetryPolicy, TransientIOError,
                                    backoff_schedule)


class InjectedFailure(RuntimeError):
    """A deliberately injected crash (fault-tolerance drills)."""


@dataclasses.dataclass
class FailureInjector:
    """Raises :class:`InjectedFailure` when training reaches a given step.

    Drivers construct one per attempt; a restarted (i.e. replaced) node is
    built with ``fail_at_step=None`` so it does not re-crash at the same
    step (see launch/train.py).
    """

    fail_at_step: Optional[int] = None

    def maybe_fail(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise InjectedFailure(f"injected failure at step {step}")


# Restart backoff used by supervise() when the caller passes none: fast
# first retry (a restart already costs a re-init), exponential after, ±10%
# seeded jitter so a gang of restarting workers doesn't stampede in sync.
DEFAULT_RESTART_BACKOFF = RetryPolicy(max_attempts=2, base_delay_s=0.01,
                                      multiplier=2.0, max_delay_s=2.0,
                                      jitter=0.1)


def supervise(run: Callable[[], object], max_restarts: int = 0,
              on_restart: Optional[Callable[[int, BaseException], None]] = None,
              retry_on: tuple = (InjectedFailure,),
              backoff: Optional[RetryPolicy] = DEFAULT_RESTART_BACKOFF,
              seed: int = 0,
              sleep: Callable[[float], None] = time.sleep):
    """Run ``run()`` under a restart supervisor.

    Returns ``(result, n_restarts)``. Only exceptions in ``retry_on`` are
    retried (default: injected failures — a genuine bug should crash loudly,
    not loop); anything else, or exhausting ``max_restarts``, propagates.

    Restart r (1-indexed) sleeps ``backoff``'s r-th backoff delay first —
    exponential with seeded jitter, so crash loops don't hot-spin and
    the schedule replays deterministically from ``seed``. ``backoff=None``
    restarts immediately (the pre-§13 behavior); ``sleep`` is injectable
    for tests.
    """
    delays: list = []
    if backoff is not None and max_restarts > 0:
        delays = backoff_schedule(
            dataclasses.replace(backoff, max_attempts=max_restarts + 1),
            seed=seed if backoff.jitter else None)
    restarts = 0
    while True:
        try:
            return run(), restarts
        except retry_on as e:  # noqa: PERF203 - restart loop is cold
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            if delays:
                sleep(delays[restarts - 1])


class MergedTopK(NamedTuple):
    ids: torch.Tensor     # (Q, k) int32 global ids, -1 padding
    dists: torch.Tensor   # (Q, k) float32 ascending, +inf padding
    # True whenever any shard was dead/dropped — the answer may be missing
    # rows it would have had. All-dead yields full sentinel rows, NOT an
    # exception: under a deadline the serving layer must always answer.
    degraded: bool = False


def partial_merge(ids: Sequence, dists: Sequence, alive: Sequence[bool],
                  k: int) -> MergedTopK:
    """Merge per-shard (Q, k_s) GLOBAL ids and ascending distances into the
    (Q, k) best by ascending distance, ties to the earlier shard and slot
    (a stable sort). Dead shards are skipped; rows are padded with
    (-1, +inf) when the live shards give fewer than ``k`` candidates, and
    no live shard at all answers all-sentinel rows with ``degraded=True``.
    """
    alive = list(alive)
    live = [(torch.as_tensor(i), torch.as_tensor(d))
            for i, d, a in zip(ids, dists, alive) if a]
    degraded = len(live) < len(alive)
    if not live:
        first = torch.as_tensor(ids[0]) if len(ids) else torch.empty((0, 0))
        q, dev = first.shape[0], first.device
        return MergedTopK(torch.full((q, k), -1, dtype=torch.int32, device=dev),
                          torch.full((q, k), float("inf"), device=dev), True)
    cat_i = torch.cat([i for i, _ in live], dim=1)
    cat_d = torch.cat([d for _, d in live], dim=1).float()
    if cat_i.shape[1] < k:  # pad so the top-k below is well-defined
        pad = k - cat_i.shape[1]
        cat_i = torch.nn.functional.pad(cat_i, (0, pad), value=-1)
        cat_d = torch.nn.functional.pad(cat_d, (0, pad), value=float("inf"))
    order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
    return MergedTopK(cat_i.gather(1, order).to(torch.int32),
                      cat_d.gather(1, order), degraded)


class QuorumDecision(NamedTuple):
    alive: list          # per-shard: counts toward the merge this query
    waited_s: float      # modeled gather wall time (slowest counted shard)
    degraded: bool       # any healthy shard charged dead (straggler or down)


def resolve_quorum(alive: Sequence[bool],
                   latency_s: Optional[Sequence[float]] = None,
                   deadline_s: Optional[float] = None,
                   quorum: Optional[int] = None) -> QuorumDecision:
    """Decide which shards count toward a merge under a straggler deadline.

    Serve when ≥Q of S shards respond within ``deadline_s``: shards over
    the deadline are charged as dead (their rows go missing — the existing
    :func:`partial_merge` degradation path). If fewer than Q make the
    deadline, wait for the fastest Q alive shards instead — quorum outranks
    the deadline, because an answer from too few shards is worse than a
    late one. ``quorum=None`` defaults to a majority of the alive shards.
    Pure host logic (latencies are modeled, e.g. from a chaos plan), so the
    policy is unit-testable at S=1 without any multi-device mesh.
    """
    alive = [bool(a) for a in alive]
    n_alive = sum(alive)
    if quorum is None:
        quorum = max(1, (n_alive + 1) // 2)
    if n_alive == 0:
        return QuorumDecision(alive, 0.0, True)
    if deadline_s is None or latency_s is None:
        return QuorumDecision(alive, 0.0, n_alive < len(alive))
    lat = np.asarray(latency_s, np.float64)
    within = [a and lat[i] <= deadline_s for i, a in enumerate(alive)]
    if sum(within) < quorum:
        # deadline leaves us under quorum: take the fastest Q alive shards
        order = sorted((i for i, a in enumerate(alive) if a),
                       key=lambda i: lat[i])[:min(quorum, n_alive)]
        within = [i in set(order) for i in range(len(alive))]
    waited = max((float(lat[i]) for i, w in enumerate(within) if w),
                 default=0.0)
    degraded = sum(within) < len(alive)
    return QuorumDecision(within, waited, degraded)


# --------------------------------------------------------------------------
# Chaos plan — the seeded fault script for resilience drills (DESIGN.md §13)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """One seeded, declarative fault script.

    Spec string grammar (``serve.py --chaos``, comma/semicolon-separated):

    ``dead=0+2`` dead shard indices · ``straggler=1`` straggler indices ·
    ``straggler_ms=50`` straggler latency · ``latency_ms=2`` healthy-shard
    latency · ``io=0.05`` transient-read failure probability ·
    ``corrupt`` flip a byte in the latest snapshot ·
    ``corrupt_record`` flip a byte in a storage-segment record (silent —
    the header stays intact; only a data audit or recall drill sees it) ·
    ``slow_read=5`` per-read-batch storage latency in ms (a REAL sleep in
    the segment reader's workers — overlappable wall-clock) ·
    ``crash=consolidate|refresh`` injected crash phase · ``seed=7``.

    Everything downstream (jitter, fault draws, corrupted byte choice) is a
    pure function of ``seed``, so a drill and its assertions replay exactly.
    """

    seed: int = 0
    dead_shards: tuple = ()
    straggler_shards: tuple = ()
    straggler_latency_s: float = 0.050
    shard_latency_s: float = 0.002
    io_fault_p: float = 0.0
    corrupt_latest_snapshot: bool = False
    crash_phase: Optional[str] = None   # "consolidate" | "refresh"
    corrupt_record: bool = False        # storage tier: silent record flip
    slow_read_ms: float = 0.0           # storage tier: per-batch latency

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        kw: dict = {}
        for tok in spec.replace(";", ",").split(","):
            tok = tok.strip()
            if not tok:
                continue
            key, _, val = tok.partition("=")
            if key == "dead":
                kw["dead_shards"] = tuple(int(v) for v in val.split("+"))
            elif key == "straggler":
                kw["straggler_shards"] = tuple(int(v) for v in val.split("+"))
            elif key == "straggler_ms":
                kw["straggler_latency_s"] = float(val) / 1e3
            elif key == "latency_ms":
                kw["shard_latency_s"] = float(val) / 1e3
            elif key == "io":
                kw["io_fault_p"] = float(val)
            elif key == "corrupt":
                kw["corrupt_latest_snapshot"] = True
            elif key == "corrupt_record":
                kw["corrupt_record"] = True
            elif key == "slow_read":
                kw["slow_read_ms"] = float(val)
            elif key == "crash":
                if val not in ("consolidate", "refresh"):
                    raise ValueError(f"--chaos: unknown crash phase {val!r}")
                kw["crash_phase"] = val
            elif key == "seed":
                kw["seed"] = int(val)
            else:
                raise ValueError(f"--chaos: unknown token {tok!r}")
        return cls(**kw)

    def alive(self, n_shards: int) -> list:
        """Per-shard liveness under this plan (dead shards are down)."""
        return [i not in set(self.dead_shards) for i in range(n_shards)]

    def latencies(self, n_shards: int) -> np.ndarray:
        """Modeled per-shard response latency: base, stragglers slower."""
        lat = np.full((n_shards,), self.shard_latency_s, np.float64)
        for i in self.straggler_shards:
            if i < n_shards:
                lat[i] = self.straggler_latency_s
        return lat

    def io_fault(self) -> Optional[Callable[[str], None]]:
        """Hook for checkpoint reads: raises TransientIOError with
        probability ``io_fault_p`` per call, seeded (install via
        ``checkpoint.set_io_fault_hook``)."""
        if self.io_fault_p <= 0.0:
            return None
        rng = np.random.default_rng(self.seed)

        def hook(path: str) -> None:
            if rng.random() < self.io_fault_p:
                raise TransientIOError(f"injected transient read fault: "
                                       f"{path}")
        return hook

    def consolidate_hook(self) -> Optional[Callable[[str], None]]:
        """Phase hook for ``index.consolidate(..., chaos=)``.

        ``crash=refresh`` raises at ``pre_snapshot`` (mid-refresh — nothing
        new is durable, the previous generation restores); ``consolidate``
        raises at ``post_snapshot`` (snapshot written, in-memory swap not
        reached — the classic crash-consistency window: EITHER generation
        restores intact).
        """
        if self.crash_phase is None:
            return None
        phase_at = ("pre_snapshot" if self.crash_phase == "refresh"
                    else "post_snapshot")

        def hook(phase: str) -> None:
            if phase == phase_at:
                raise InjectedFailure(
                    f"injected crash at {phase} (chaos crash="
                    f"{self.crash_phase})")
        return hook


def corrupt_snapshot(ckpt_dir: str, step: Optional[int] = None, *,
                     seed: int = 0) -> int:
    """Silently flip one byte inside a snapshot's array payload.

    Rewrites the ``.npz`` with the flipped array so the zip container's own
    CRC is CONSISTENT with the corrupt bytes — only the manifest-level
    CRC32 (``checkpoint.ChecksumError``) can catch it. A raw on-disk byte
    flip would be caught by ``zipfile`` first, which exercises the wrong
    layer: real silent corruption (bad DMA, bitrot past the container
    checksum, a buggy transform) presents exactly like this. Returns the
    corrupted step.
    """
    from repro_torch.dist import checkpoint as ckpt

    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    sdir = ckpt._step_dir(ckpt_dir, step)
    rng = np.random.default_rng(seed)
    npzs = sorted(f for f in os.listdir(sdir) if f.endswith(".npz"))
    if not npzs:
        raise FileNotFoundError(f"no array payloads under {sdir!r}")
    path = os.path.join(sdir, npzs[int(rng.integers(len(npzs)))])
    with np.load(path) as z:
        arrays = {k: z[k].copy() for k in z.files}
    # flip a byte in the largest array — the one a restore can least
    # afford to trust blindly
    name = max(arrays, key=lambda k: arrays[k].nbytes)
    buf = arrays[name].view(np.uint8).reshape(-1)
    i = int(rng.integers(buf.shape[0]))
    buf[i] ^= np.uint8(0xFF)
    np.savez(path, **arrays)
    return int(step)
