"""Bounded append-only delta segment for the streaming index.

Port of ``repro/index/delta.py``, plain numpy as the reference is. New rows
land here: ``append`` stores the full vector and its pre-encoded PQ codes,
and greedily links the row into a small delta adjacency (exact nearest
neighbors among the rows already present, plus capped reverse edges). The
query path never walks this adjacency — the delta is bounded small so one
bulk ADC scan covers it — but consolidation seeds each delta vertex's
candidate set from it.

Capacity is a hard bound (the serving path's fixed shapes): overflowing
raises :class:`DeltaFullError`, the caller's cue to ``consolidate()``.
"""

from __future__ import annotations

import numpy as np

# Elements of the (rows, hi) f32 distance block _link computes at once: a
# batch of 12,500 inserts into a 50,000-slot delta would hold 2.5 GB.
LINK_BLOCK_ELEMS = 1 << 26


class DeltaFullError(RuntimeError):
    """Raised when an insert batch would exceed the delta capacity."""


class DeltaSegment:
    """Append-only row store: vectors + codes + greedy local adjacency.

    All state is host numpy (inserts are host-side mutations; the serving
    path uploads ``codes`` once per mutation). Local ids are [0, capacity)
    with sentinel ``capacity`` padding the adjacency.
    """

    def __init__(self, capacity: int, dim: int, code_width: int, *,
                 degree: int = 8, code_dtype=np.uint8):
        if capacity < 1:
            raise ValueError(f"delta capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.degree = int(degree)
        self.vectors = np.zeros((capacity, dim), np.float32)
        # dtype follows the base segment's codes (uint8 for K <= 256 and
        # fs4 packed bytes, int32 beyond — pq.base.encode's convention)
        self.codes = np.zeros((capacity, code_width), code_dtype)
        self.neighbors = np.full((capacity, self.degree), capacity, np.int32)
        self.count = 0

    def append(self, vectors: np.ndarray, codes: np.ndarray) -> np.ndarray:
        """Append a batch; returns the assigned LOCAL slots (b,).

        Raises :class:`DeltaFullError` when the batch does not fit —
        consolidate the index to drain the delta, then retry.
        """
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        codes = np.atleast_2d(np.asarray(codes))
        if not np.can_cast(codes.dtype, self.codes.dtype, casting="safe"):
            raise ValueError(
                f"delta codes are {self.codes.dtype} but the batch is "
                f"{codes.dtype} — encode with the base segment's quantizer")
        b = vectors.shape[0]
        if codes.shape[0] != b:
            raise ValueError(f"{b} vectors but {codes.shape[0]} code rows")
        if self.count + b > self.capacity:
            raise DeltaFullError(
                f"delta segment full: {self.count} occupied + {b} new > "
                f"capacity {self.capacity}; run consolidate() to fold the "
                f"delta into the base segment, then retry the insert")
        slots = np.arange(self.count, self.count + b)
        self.vectors[slots] = vectors
        self.codes[slots] = codes
        self._link(slots)
        self.count += b
        return slots

    def _link(self, slots: np.ndarray) -> None:
        """Greedy incremental linking: row i connects to its ``degree``
        exact-nearest predecessors (earlier rows, including earlier rows of
        the same batch), which gain a capped reverse edge. The (b, hi)
        distance block is computed LINK_BLOCK_ELEMS at a time, by rows."""
        hi = slots[-1] + 1
        old = self.vectors[:hi]                                # (hi, D)
        old2 = np.sum(old * old, 1)[None, :]
        step = max(1, LINK_BLOCK_ELEMS // hi)
        for s in range(0, len(slots), step):
            new = self.vectors[slots[s:s + step]]              # (rows, D)
            # squared distances new × all rows up to the end of the batch
            d = np.sum(new * new, 1)[:, None] - 2.0 * new @ old.T + old2
            for row, gi in enumerate(slots[s:s + step]):
                cand = d[row, :gi]                  # strictly earlier rows
                if cand.size == 0:
                    continue
                take = min(self.degree, cand.size)
                nbrs = np.argpartition(cand, take - 1)[:take].astype(np.int32)
                self.neighbors[gi, :take] = nbrs
                for j in nbrs:                       # capped reverse edges
                    free = np.flatnonzero(self.neighbors[j] == self.capacity)
                    if free.size:
                        self.neighbors[j, free[0]] = gi
                    # full reverse lists drop the edge (the bulk scan, not
                    # the adjacency, answers queries)

    def memory_bytes(self) -> int:
        return (self.vectors.size * 4 + self.codes.size
                + self.neighbors.size * 4)
