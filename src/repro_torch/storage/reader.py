"""Async record reader: a thread pool over pread, retry on every read.

Port of ``repro/storage/reader.py`` over the port's ``dist/retry.py``.
The worker threads only ``pread`` and sleep: they touch no torch tensor,
so every call into PyTorch (and the card) stays on the searching thread.

The I/O half of the storage tier (DESIGN.md §14). A beam round asks for a
batch of vertex records (the round's E·R candidate ids); the reader splits
the batch across ``io_threads`` workers, each issuing positional
``os.pread`` calls — no shared file offset, no locking — and reassembles
``(adjacency, codes)`` arrays in request order. ``submit`` returns a
Future so the prefetcher (:mod:`repro_torch.storage.prefetch`) can keep round
N's reads in flight while round N−1's scoring computes; ``read_records``
is the synchronous convenience over it.

Resilience wiring (DESIGN.md §13) on REAL reads:

* every worker chunk runs under ``dist.retry.call_with_retry`` — a
  :class:`~repro_torch.dist.retry.TransientIOError` (chaos-injected or real) is
  retried with exponential backoff before it can fail the round;
* the chaos ``fault_hook`` (``ChaosPlan.io_fault()``) is invoked once per
  worker chunk BEFORE its preads, so ``--chaos io=0.05`` exercises this
  path exactly like checkpoint reads;
* ``slow_read_ms`` models device latency with a real ``time.sleep`` per
  chunk — genuinely overlappable wall-clock, which is what lets the
  prefetch benchmarks measure compute/I/O overlap honestly on a
  page-cached CI host where raw preads cost microseconds.

Counters (``bytes_read``, ``n_reads``, ``n_retries``, ``io_busy_s``) feed
the bench's bytes-read/hit-rate rows and the measured-I/O adapter on
``HybridEngine.io_time``.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from repro_torch.dist import retry as _retry
from repro_torch.storage.format import HEADER_SIZE, SegmentHeader


class AsyncSegmentReader:
    """Thread-pooled positional reads of per-vertex records.

    Args:
      path:        segment file (``storage.format`` layout).
      header:      its verified :class:`SegmentHeader`.
      io_threads:  worker threads; a batch is split into that many chunks.
      retry:       :class:`repro_torch.dist.retry.RetryPolicy` wrapped around
                   every chunk read (None = fail fast).
      fault_hook:  chaos seam — called with the path once per chunk; may
                   raise :class:`TransientIOError` (``ChaosPlan.io_fault``).
      slow_read_ms: modeled per-batch device latency (a real sleep inside
                   each worker chunk, so it overlaps with host compute).
    """

    def __init__(self, path: str, header: SegmentHeader, *,
                 io_threads: int = 4,
                 retry: Optional[_retry.RetryPolicy] = None,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 slow_read_ms: float = 0.0):
        self.path = path
        self.header = header
        self.io_threads = max(1, int(io_threads))
        self.retry = retry
        self.fault_hook = fault_hook
        self.slow_read_ms = float(slow_read_ms)
        self._fd = os.open(path, os.O_RDONLY)
        self._pool = ThreadPoolExecutor(
            max_workers=self.io_threads,
            thread_name_prefix="seg-reader")
        self._lock = threading.Lock()
        self.bytes_read = 0
        self.n_reads = 0          # individual record preads issued
        self.n_batches = 0
        self.n_retries = 0
        self.io_busy_s = 0.0      # summed worker wall time (not wall-clock)

    # -- internals ---------------------------------------------------------

    def _n_chunks(self, size: int) -> int:
        """A batch claims only HALF the workers: the double-buffered engine
        keeps two batches in flight, and if one batch's chunks saturated
        the pool the next batch would queue entirely behind it — the
        buffers would serialize and the overlap would evaporate exactly
        when io ≈ compute, the regime prefetch exists for."""
        return max(1, min(self.io_threads // 2, size))

    def _read_chunk(self, ids: np.ndarray,
                    t_issue: Optional[float] = None) -> bytes:
        """One worker's share: seeded faults, modeled latency, preads."""
        t0 = time.perf_counter()

        def attempt() -> bytes:
            if self.fault_hook is not None:
                self.fault_hook(self.path)
            if self.slow_read_ms > 0.0:
                # a device's latency clock starts when the request is
                # ISSUED, not when a worker thread wins the GIL and picks
                # the task up — sleep to the absolute deadline so queue/
                # GIL handoff delays eat into the modeled latency instead
                # of stacking on top of it
                deadline = ((t_issue if t_issue is not None else t0)
                            + self.slow_read_ms / 1e3)
                left = deadline - time.perf_counter()
                if left > 0.0:
                    time.sleep(left)
            # one pread per record, as the reference issues them; the
            # offsets come from numpy and the records are joined once
            rb, fd = self.header.record_bytes, self._fd
            offsets = (HEADER_SIZE + np.asarray(ids, np.int64) * rb).tolist()
            parts = [os.pread(fd, rb, off) for off in offsets]
            for j, raw in enumerate(parts):
                if len(raw) != rb:
                    raise _retry.TransientIOError(
                        f"{self.path}: short read of record {int(ids[j])} "
                        f"({len(raw)}/{rb} bytes)")
            return b"".join(parts)

        if self.retry is None:
            raw, retries = attempt(), 0
        else:
            raw, retries = _retry.call_with_retry(
                attempt, policy=self.retry,
                retry_on=(_retry.TransientIOError,),
                seed=int(ids[0]) if len(ids) else 0)
        with self._lock:
            self.bytes_read += len(raw)
            self.n_reads += len(ids)
            self.n_retries += retries
            self.io_busy_s += time.perf_counter() - t0
        return raw

    def _gather(self, ids: np.ndarray):
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return (np.zeros((0, self.header.r), np.int32),
                    np.zeros((0, self.header.code_width), np.uint8))
        if ids.min() < 0 or ids.max() >= self.header.n:
            raise ValueError(
                f"record ids out of range [0, {self.header.n}): "
                f"{ids[(ids < 0) | (ids >= self.header.n)]}")
        t_issue = time.perf_counter()
        chunks = np.array_split(ids, self._n_chunks(ids.size))
        futs = [self._pool.submit(self._read_chunk, c, t_issue)
                for c in chunks]
        raw = b"".join(f.result() for f in futs)
        with self._lock:
            self.n_batches += 1
        return self.header.parse_records(raw, ids.size)

    # -- public API --------------------------------------------------------

    def submit(self, ids) -> Future:
        """Issue an async batch read. The Future resolves to
        ``(adjacency (B, R) int32, codes (B, code_width) uint8)`` in
        request order.

        The split + chunk submission happens HERE, in the caller's thread
        (cheap: an ``array_split`` and a few queue puts), so the worker
        sleeps/preads start immediately and overlap the caller's compute.
        A dispatch-thread hop would make the issue itself contend for the
        GIL with scoring — measurably inflating effective I/O latency in
        the pipelined engine. The last-finishing chunk's done-callback
        reassembles and parses the batch; out-of-range ids raise here,
        synchronously."""
        ids = np.asarray(ids, np.int64).copy()
        fut: Future = Future()
        if ids.size == 0:
            fut.set_result(
                (np.zeros((0, self.header.r), np.int32),
                 np.zeros((0, self.header.code_width), np.uint8)))
            return fut
        if ids.min() < 0 or ids.max() >= self.header.n:
            raise ValueError(
                f"record ids out of range [0, {self.header.n}): "
                f"{ids[(ids < 0) | (ids >= self.header.n)]}")
        t_issue = time.perf_counter()
        chunks = np.array_split(ids, self._n_chunks(ids.size))
        futs = [self._pool.submit(self._read_chunk, c, t_issue)
                for c in chunks]
        pending = [len(futs)]
        done_lock = threading.Lock()

        def _one_done(_f) -> None:
            with done_lock:
                pending[0] -= 1
                if pending[0]:
                    return
            try:
                raw = b"".join(f.result() for f in futs)
                with self._lock:
                    self.n_batches += 1
                fut.set_result(self.header.parse_records(raw, ids.size))
            except BaseException as e:   # surfaced via Future.result()
                fut.set_exception(e)

        for f in futs:
            f.add_done_callback(_one_done)
        return fut

    def read_records(self, ids):
        """Synchronous batch read (same return as :meth:`submit`)."""
        return self._gather(np.asarray(ids, np.int64))

    def stats(self) -> dict:
        with self._lock:
            return {"bytes_read": self.bytes_read, "n_reads": self.n_reads,
                    "n_batches": self.n_batches,
                    "n_retries": self.n_retries,
                    "io_busy_s": self.io_busy_s}

    def reset_stats(self) -> None:
        with self._lock:
            self.bytes_read = self.n_reads = 0
            self.n_batches = self.n_retries = 0
            self.io_busy_s = 0.0

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "AsyncSegmentReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
