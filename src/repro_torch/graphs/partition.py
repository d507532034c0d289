"""Graph partitioning for sharded serving (DESIGN.md §6).

Port of ``repro/graphs/partition.py``. The distributed-DiskANN layout: the
dataset is split into contiguous per-shard row ranges and an INDEPENDENT
Vamana subgraph is built over each shard's rows. Shard s owns global rows
``[s·n_local, min((s+1)·n_local, n))`` and its adjacency uses LOCAL ids in
``[0, n_local)`` with sentinel ``n_local``, so the whole partition stacks
into one fixed-shape ``(n_shards, n_local, R)`` tensor.

Independent subgraphs mean a beam search never crosses a shard boundary:
every shard is searched and the per-shard top-k lists are merged, so a dead
shard removes exactly its row range from the answer
(``dist.fault.partial_merge``).

On one device the engines route over :func:`block_diagonal`, the S
subgraphs as one graph of S·n_local rows with global ids: a beam that
starts in shard s never reaches another shard's rows.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.adjacency import Graph

# graphs.vamana is imported inside the builders: search.engine imports this
# module for PartitionedGraph, and vamana imports search.beam, so a
# module-level import would close an import cycle.


@dataclasses.dataclass
class PartitionedGraph:
    """A stack of independent per-shard proximity graphs.

    Attributes:
      neighbors: (S, n_local, R) int32 adjacency per shard, LOCAL ids with
        sentinel ``n_local`` (pad rows, beyond a shard's real row count,
        are all-sentinel and unreachable).
      medoids:   (S,) int32 per-shard entry vertex, LOCAL id.
      n:         total number of REAL rows across all shards (the global
        dataset size before divisibility padding).
    """
    neighbors: torch.Tensor
    medoids: torch.Tensor
    n: int

    @property
    def n_shards(self) -> int:
        return self.neighbors.shape[0]

    @property
    def n_local(self) -> int:
        """Rows per shard including divisibility padding."""
        return self.neighbors.shape[1]

    @property
    def degree(self) -> int:
        return self.neighbors.shape[2]

    def shard_rows(self, s: int) -> tuple[int, int]:
        """Global [lo, hi) row range owned by shard ``s``."""
        lo = s * self.n_local
        return lo, min(lo + self.n_local, self.n)

    def to(self, device) -> "PartitionedGraph":
        return PartitionedGraph(self.neighbors.to(device), self.medoids.to(device),
                                self.n)


def shard_bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous per-shard global row ranges [lo, hi).

    Every shard gets ``ceil(n / n_shards)`` row slots; the last shard(s) may
    own fewer real rows (the remainder is sentinel-padded, never
    fabricated)."""
    n_local = -(-n // n_shards)
    return [(s * n_local, min((s + 1) * n_local, n)) for s in range(n_shards)]


def _check_split(n: int, n_shards: int) -> None:
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n < n_shards:
        raise ValueError(f"cannot split {n} rows into {n_shards} shards")


def build_partitioned_vamana(x: torch.Tensor, n_shards: int, *,
                             generator: torch.Generator, r: int = 32,
                             l: int = 64, alpha: float = 1.2, passes: int = 2,
                             batch: int = 1024, verbose: bool = False,
                             device=None) -> PartitionedGraph:
    """Partition ``x`` (N, D) into ``n_shards`` row ranges and build one
    independent Vamana graph per range on ``device`` (default ``cuda``),
    one after another. The CPU ``generator`` gives each shard with more
    than one row its draws (:func:`graphs.vamana.vamana_draws`), in shard
    order. Local ids map to global ids as ``gid = s * n_local + local``."""
    from repro_torch.graphs.vamana import vamana_draws

    n = int(x.shape[0])
    _check_split(n, n_shards)
    draws = [vamana_draws(generator, hi - lo, r, passes) if hi - lo > 1 else None
             for lo, hi in shard_bounds(n, n_shards)]
    return build_partitioned_vamana_from_draws(
        x.to(resolve_device(device)), n_shards, draws, r=r, l=l, alpha=alpha,
        batch=batch, verbose=verbose)


def build_partitioned_vamana_from_draws(
        x: torch.Tensor, n_shards: int,
        draws: Sequence[Optional[tuple[np.ndarray, list]]], *, r: int = 32,
        l: int = 64, alpha: float = 1.2, batch: int = 1024,
        verbose: bool = False) -> PartitionedGraph:
    """The build itself, on x's device, from per-shard ``(init, orders)``
    draws (``draws[s]``; ignored for a shard of ≤ 1 row), so a test can
    inject the JAX builder's. A degenerate shard (≤ 1 row) has nothing to
    route over: it stays all-sentinel with entry 0, as in the reference."""
    from repro_torch.graphs.vamana import build_vamana_from_draws

    n = int(x.shape[0])
    _check_split(n, n_shards)
    bounds = shard_bounds(n, n_shards)
    n_local = bounds[0][1] - bounds[0][0]
    nbrs = torch.full((n_shards, n_local, r), n_local, dtype=torch.int32,
                      device=x.device)
    medoids = torch.zeros((n_shards,), dtype=torch.int32, device=x.device)
    for s, (lo, hi) in enumerate(bounds):
        ns = hi - lo
        if ns <= 1:
            continue
        init, orders = draws[s]
        t0 = time.perf_counter()
        g = build_vamana_from_draws(x[lo:hi], init, orders, r=r, l=l,
                                    alpha=alpha, batch=batch)
        # the subgraph's sentinel (ns) becomes the stack's sentinel (n_local)
        nbrs[s, :ns] = torch.where(g.neighbors >= ns, n_local, g.neighbors)
        medoids[s] = int(g.medoid)
        if verbose:
            print(f"[partition] shard {s}: rows [{lo}, {hi}) "
                  f"medoid(local)={int(medoids[s])}, built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return PartitionedGraph(neighbors=nbrs, medoids=medoids, n=n)


def shard_subgraph(pg: PartitionedGraph, s: int) -> Graph:
    """Shard ``s`` as a standalone :class:`Graph` (sentinel stays
    ``n_local``)."""
    return Graph(neighbors=pg.neighbors[s], medoid=pg.medoids[s].long())


def block_diagonal(pg: PartitionedGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """The S subgraphs as ONE graph over S·n_local rows: row ``s·n_local +
    i`` is shard s's local row i, local neighbour j becomes ``s·n_local +
    j`` and every local sentinel the one global sentinel ``S·n_local``. No
    edge leaves its shard's block. Returns ((S·n_local, R) int32
    adjacency, (S,) int64 global medoids)."""
    s, nl, r = pg.neighbors.shape
    off = (torch.arange(s, device=pg.neighbors.device) * nl).to(torch.int32)
    glob = torch.where(pg.neighbors < nl, pg.neighbors + off[:, None, None], s * nl)
    return (glob.reshape(s * nl, r).to(torch.int32).contiguous(),
            pg.medoids.long() + off.long())
