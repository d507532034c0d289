"""LRU hot-vertex cache, BFS-seeded from the medoid.

Port of ``repro/storage/cache.py`` (numpy only). The DRAM half of the
storage tier's working set (DESIGN.md §14): a bounded map ``vertex id →
(adjacency row, code row)``. Graph-routed search traffic
is wildly skewed — every query enters at the medoid and fans out through
the graph's "top layers", so the few thousand vertices within a couple of
hops of the entry point appear in almost every query's early rounds.
:meth:`HotVertexCache.seed_bfs` pre-loads exactly that set (breadth-first
from the medoid until the budget fills), and LRU keeps whatever else the
live traffic re-touches.

Counters are first-class: ``hits`` / ``misses`` (record granularity) and
the hit rate feed the bench's per-row cache accounting, and a cached hit
is a read that never reached the reader — so (cache hits × record_bytes)
+ reader ``bytes_read`` is the total record traffic either way.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.storage.format import SegmentHeader


class HotVertexCache:
    """Bounded LRU of per-vertex records.

    Args:
      capacity: maximum records held (0 disables — every get misses).
    """

    def __init__(self, capacity: int):
        self.capacity = max(0, int(capacity))
        self._map: OrderedDict = OrderedDict()   # LRU half
        self._pinned: dict = {}                  # BFS seeds, never evicted
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.seeded = 0

    @classmethod
    def from_bytes(cls, budget_bytes: int,
                   header: SegmentHeader) -> "HotVertexCache":
        """Size by a DRAM budget: floor(budget / record_bytes) records."""
        return cls(int(budget_bytes) // max(1, header.record_bytes))

    def __len__(self) -> int:
        return len(self._map) + len(self._pinned)

    def __contains__(self, vid) -> bool:
        return int(vid) in self._pinned or int(vid) in self._map

    # -- read/write --------------------------------------------------------

    def get_many(self, ids):
        """Partition a request: ``(found: {vid: (adj, codes)}, missing)``.

        Hits move to MRU position; counters update per record requested
        (``ids`` should already be deduplicated by the caller).
        """
        found, missing = {}, []
        pinned, lru = self._pinned, self._map
        ids = np.asarray(ids, np.int64).tolist()
        for vid in ids:
            rec = pinned.get(vid)
            if rec is None:
                rec = lru.get(vid)
                if rec is not None:
                    lru.move_to_end(vid)
            if rec is None:
                missing.append(vid)
            else:
                found[vid] = rec
        self.misses += len(missing)
        self.hits += len(ids) - len(missing)
        return found, np.asarray(missing, np.int64)

    def put_many(self, ids, adj, codes) -> None:
        """Insert freshly-read records ((B, R) adjacency, (B, W) codes)
        into the LRU half, evicting past its share of capacity. Pinned
        (BFS-seeded) records are never evicted — a beam search streams
        ~every record it touches exactly once, which would otherwise flush
        the hot top layers right before the next query re-enters at the
        medoid (sequential-scan LRU pathology)."""
        lru_cap = self.capacity - len(self._pinned)
        if lru_cap <= 0:
            return
        pinned, lru = self._pinned, self._map
        for j, vid in enumerate(np.asarray(ids, np.int64).tolist()):
            if vid in pinned:
                continue
            if vid in lru:
                lru.move_to_end(vid)
                continue
            lru[vid] = (adj[j], codes[j])
            if len(lru) > lru_cap:
                lru.popitem(last=False)
                self.evictions += 1

    # -- seeding -----------------------------------------------------------

    def seed_bfs(self, reader, medoid: int, *,
                 budget: int = 0) -> np.ndarray:
        """Pre-load and PIN the graph's top layers: BFS from ``medoid``
        through the on-disk adjacency until ``budget`` records (default:
        half the capacity — the other half stays LRU for live traffic)
        are resident. Pinned records are exempt from eviction: they are
        the set every query's early rounds touch, and the cache exists to
        keep exactly them DRAM-resident. Returns the seeded ids in BFS
        order — the natural multi-entry set for
        :class:`~repro_torch.storage.engine.DiskEngine` (``entries=S`` starts
        the beam on the first S of them).

        Seeding reads THROUGH ``reader`` (levels fetched as batches), so
        its bytes land in the reader's counters like any other traffic.
        """
        budget = min(budget or self.capacity // 2, self.capacity)
        n = reader.header.n
        if budget <= 0 or n == 0:
            return np.zeros((0,), np.int64)
        seen = {int(medoid)}
        order = []
        frontier = np.asarray([int(medoid)], np.int64)
        while frontier.size and len(order) < budget:
            frontier = frontier[:budget - len(order)]
            adj, codes = reader.read_records(frontier)
            for j, vid in enumerate(frontier):
                self._pinned[int(vid)] = (adj[j], codes[j])
            order.extend(int(v) for v in frontier)
            nxt = np.unique(adj[(adj >= 0) & (adj < n)])
            frontier = np.asarray(
                [int(v) for v in nxt if int(v) not in seen], np.int64)
            seen.update(int(v) for v in frontier)
        self.seeded = len(order)
        return np.asarray(order, np.int64)

    # -- accounting --------------------------------------------------------

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"capacity": self.capacity, "resident": len(self),
                "pinned": len(self._pinned),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "seeded": self.seeded,
                "hit_rate": self.hit_rate()}

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0
