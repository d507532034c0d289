"""Double-buffered frontier prefetch: round N's reads under round N−1's
compute.

Port of ``repro/storage/prefetch.py`` (numpy only). The overlap half of
the storage tier (DESIGN.md §14). A storage-backed beam round is two
phases — fetch the frontier's candidate records, then
score them — and run serially the round costs ``io + compute``. The
prefetcher turns that into ``max(io, compute)``: the engine calls
:meth:`prefetch` for the NEXT round's ids (selected one round stale, see
``storage/engine.py``) BEFORE scoring the in-flight round, so the reader's
threads fill the next buffer while the round's scoring runs.

The cache sits in front of every fetch: ``prefetch`` partitions the
request into cache hits (served immediately, zero I/O) and misses (one
async reader batch), and ``collect`` reassembles them in request order and
inserts the fresh records — so hot top-layer vertices never hit the disk
twice regardless of which round asks.

``io_wait_s`` accumulates only the time ``collect`` actually BLOCKED on
the in-flight Future — the measured, post-overlap I/O stall that
``HybridEngine.io_time(..., measured_io_s=)`` cross-checks against the
closed-form model.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from repro_torch.storage.cache import HotVertexCache
from repro_torch.storage.reader import AsyncSegmentReader


@dataclasses.dataclass
class PendingFetch:
    """One in-flight round: the request order, its cache hits, and the
    Future covering the misses (None = fully cache-served)."""

    ids: np.ndarray                 # requested ids, dedup'd, request order
    hits: dict                      # vid -> (adj_row, code_row)
    missing: np.ndarray
    future: Optional[Future]


class FrontierPrefetcher:
    """Cache-fronted async fetch of per-vertex records."""

    def __init__(self, reader: AsyncSegmentReader,
                 cache: Optional[HotVertexCache] = None):
        self.reader = reader
        self.cache = cache if cache is not None else HotVertexCache(0)
        self.io_wait_s = 0.0        # blocked time in collect() (post-overlap)
        self.n_prefetches = 0

    def prefetch(self, ids) -> PendingFetch:
        """Issue the next round's reads: cache hits resolve now, misses go
        to the reader's thread pool. Returns the token ``collect`` needs."""
        ids = np.unique(np.asarray(ids, np.int64))
        hits, missing = self.cache.get_many(ids)
        fut = self.reader.submit(missing) if missing.size else None
        self.n_prefetches += 1
        return PendingFetch(ids=ids, hits=hits, missing=missing, future=fut)

    def collect(self, pending: PendingFetch):
        """Wait for the in-flight reads and assemble ``(ids, adjacency,
        codes)`` in request order; fresh records enter the cache."""
        hdr = self.reader.header
        b = pending.ids.size
        adj = np.empty((b, hdr.r), np.int32)
        codes = np.empty((b, hdr.code_width), np.uint8)
        if pending.future is not None:
            t0 = time.perf_counter()
            madj, mcodes = pending.future.result()
            self.io_wait_s += time.perf_counter() - t0
            self.cache.put_many(pending.missing, madj, mcodes)
            # ids are sorted and distinct, the misses a subset of them
            at = np.searchsorted(pending.ids, pending.missing)
            adj[at], codes[at] = madj, mcodes
        for j, vid in enumerate(pending.ids.tolist()):
            row = pending.hits.get(vid)
            if row is not None:
                adj[j], codes[j] = row
        return pending.ids, adj, codes

    def fetch(self, ids):
        """Synchronous fetch — ``collect(prefetch(ids))`` (the serial
        baseline path; identical records, no overlap)."""
        return self.collect(self.prefetch(ids))

    def stats(self) -> dict:
        return {"io_wait_s": self.io_wait_s,
                "n_prefetches": self.n_prefetches,
                **{f"cache_{k}": v for k, v in self.cache.stats().items()},
                **self.reader.stats()}

    def reset_stats(self) -> None:
        self.io_wait_s = 0.0
        self.n_prefetches = 0
        self.cache.reset_stats()
        self.reader.reset_stats()
