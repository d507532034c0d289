"""Serving engines (paper §7): in-memory, SSD-hybrid (DiskANN) and the
exhaustive scatter-gather scan.

Port of ``repro/search/engine.py`` with the default ``search()`` arguments.
The graph engines route with PQ-ADC distances through the fused hop-ADC
kernel, one launch per beam round for the whole batch. They accept any
quantizer exposing the (codes, lut_fn) protocol (``pq.base.QuantizerModel``
of classic PQ, OPQ or the learned RPQ).

* :class:`InMemoryEngine` — codes + PG resident; next-hop selection and the
  final top-k use ONLY PQ distances. Memory = code bytes + graph.
* :class:`HybridEngine` — DiskANN: codes resident; full vectors + PG "on
  SSD". Routing uses ADC; every expansion costs one modeled SSD read; the
  final candidates are re-ranked with exact distances.
* :class:`ShardedEngine` — the exhaustive ADC scan with a local top-k (or
  an ADC shortlist and exact rerank), merged by ``dist.fault.partial_merge``
  so a dead shard degrades the answer instead of failing it. One shard:
  the JAX engine on a one-device mesh.

Every engine takes either layout, and the type of ``lut_fn``'s return
decides which: (N, M) byte codes with (Q, M, K) f32 LUTs (u8), or
(N, ceil(M/2)) packed nibble codes with a ``pq.pack.QuantizedLUT`` (fs4).

The engines hold their state on ``device`` (default ``cuda``) and route
from the graph's medoid. Multi-entry seeding, hop pruning, budgets, the
degradation ladder's rerank levels, more than one shard and the graph-
routed sharded engine belong to later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.fault import partial_merge
from repro_torch.graphs.adjacency import Graph
from repro_torch.kernels import ops as kops
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.search import beam
from repro_torch.search.beam import SearchResult


def _is_packed(luts) -> bool:
    return isinstance(luts, QuantizedLUT)


def _bulk_adc(codes: torch.Tensor, luts) -> torch.Tensor:
    """(N, M|Mb) codes × (Q, ...) LUTs → (Q, N) ADC distances, dispatching
    on the layout (the one switch of the scan engine)."""
    if _is_packed(luts):
        return kops.adc_scan_fs(codes, luts.lut, luts.scale, luts.bias)
    return kops.adc_scan_batch(codes, luts)


def topk_lower(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of (Q, N) ``d``, ascending, ties to the
    LOWER index — the order of ``lax.top_k(-d, k)``, which ``torch.topk``
    does not promise (and fs4 distances tie often).

    ``torch.topk`` finds each row's k-th value, then only the entries at or
    below it (≥ k per row, a few more on ties) are stably sorted by (row,
    value); their column order is ascending already. Returns (values
    (Q, k), indices (Q, k) int64)."""
    q = d.shape[0]
    thr = torch.topk(d, k, dim=1, largest=False).values[:, -1:]   # sorted
    rows, cols = torch.nonzero(d <= thr, as_tuple=True)   # row-major order
    vals = d[rows, cols]
    order = torch.sort(vals, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    vals, cols = vals[order], cols[order]
    counts = torch.bincount(rows, minlength=q)
    start = torch.cumsum(counts, 0) - counts
    pos = start[:, None] + torch.arange(k, device=d.device)[None, :]
    return vals[pos], cols[pos]


@dataclasses.dataclass
class InMemoryEngine:
    graph: Graph
    codes: torch.Tensor               # (N, M) uint8 codes, or fs4 (N, ceil(M/2))
    lut_fn: Callable                  # (Q, D) queries -> LUTs or QuantizedLUT
    device: object = None             # default cuda

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.graph = self.graph.to(self.device)
        self.codes = self.codes.to(self.device)
        self._codes_p = kops.pad_sentinel_row(self.codes)

    def search(self, queries: torch.Tensor, *, k: int = 10, h: int = 32,
               max_steps: int = 512, expand: int = 1) -> SearchResult:
        queries = queries.to(self.device)
        luts = self.lut_fn(queries)
        dist_fn = beam.make_adc_dist_fn(self._codes_p, packed=_is_packed(luts))
        res = beam.beam_search(self.graph.neighbors, self.graph.medoid, luts,
                               dist_fn, h=h, max_steps=max_steps,
                               expand=expand)
        return SearchResult(res.ids[:, :k], res.dists[:, :k], res.hops,
                            res.n_dist, res.rounds, res.truncated)

    def memory_bytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.graph.neighbors.numel() * 4)


@dataclasses.dataclass
class HybridEngine:
    """DiskANN-style: ADC routing + exact rerank from "SSD" vectors."""
    graph: Graph
    codes: torch.Tensor
    lut_fn: Callable
    vectors: torch.Tensor             # (N, D) original vectors ("on SSD")
    io_latency_s: float = 100e-6      # per 4 KiB node read (NVMe-class)
    device: object = None             # default cuda

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.graph = self.graph.to(self.device)
        self.codes = self.codes.to(self.device)
        self.vectors = self.vectors.to(self.device)
        self._codes_p = kops.pad_sentinel_row(self.codes)
        self._vec_p = kops.pad_sentinel_row(self.vectors.float())

    def search(self, queries: torch.Tensor, *, k: int = 10, h: int = 32,
               max_steps: int = 512, expand: int = 1) -> SearchResult:
        """ADC-routed beam of width h, then the exact rerank of all h
        candidates."""
        k = min(k, h)  # cannot return more results than candidates
        queries = queries.to(self.device)
        luts = self.lut_fn(queries)
        dist_fn = beam.make_adc_dist_fn(self._codes_p, packed=_is_packed(luts))
        res = beam.beam_search(self.graph.neighbors, self.graph.medoid, luts,
                               dist_fn, h=h, max_steps=max_steps,
                               expand=expand)
        ids, dists = _exact_rerank(self._vec_p, queries, res.ids, k)
        return SearchResult(ids, dists, res.hops, res.n_dist, res.rounds,
                            res.truncated)

    def io_time(self, res: SearchResult) -> torch.Tensor:
        """Modeled SSD time per query: one 4 KiB block read per expansion,
        but the ≤E reads of a round (``expand=E``) are issued concurrently,
        so the wall-clock is the measured ROUNDS × latency."""
        return res.rounds.float() * self.io_latency_s

    def memory_bytes(self) -> int:
        # resident = codes (+ codebook, negligible); graph+vectors on SSD
        return self.codes.numel() * self.codes.element_size()


def _exact_rerank(vec_p: torch.Tensor, queries: torch.Tensor,
                  cand_ids: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact distances of the (Q, h) beam candidates; the k best
    (ties → lower slot). Sentinel candidates rank +inf."""
    cand = cand_ids.long()
    v = vec_p[cand]                                        # (Q, h, D)
    d = ((v - queries[:, None, :].float()) ** 2).sum(dim=-1)
    d = torch.where(cand == vec_p.shape[0] - 1, float("inf"), d)
    vals, order = torch.sort(d, dim=1, stable=True)
    return cand.gather(1, order[:, :k]).to(torch.int32), vals[:, :k]


# ==========================================================================
# Scatter-gather scan (one shard): the per-shard bodies of the JAX engine
# ==========================================================================

def _local_adc_topk(codes: torch.Tensor, luts, *, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's scatter half: ADC-scan its rows, return the LOCAL top-k
    (Q, k) ids and distances (one shard: local ids are global)."""
    vals, ids = topk_lower(_bulk_adc(codes, luts), k)
    return ids, vals


def _local_adc_serve(codes: torch.Tensor, vectors: torch.Tensor, luts,
                     queries: torch.Tensor, *, k: int, shortlist: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter half with DiskANN-style local refinement: ADC shortlist →
    exact rerank against the shard's vector rows → LOCAL top-k."""
    _, cand = topk_lower(_bulk_adc(codes, luts), shortlist)   # (Q, S)
    exact = ((vectors[cand] - queries[:, None, :]) ** 2).sum(dim=-1)
    vals, order = torch.sort(exact, dim=1, stable=True)
    return cand.gather(1, order[:, :k]), vals[:, :k]


@dataclasses.dataclass
class ShardedEngine:
    """Scatter-gather serving by exhaustive ADC scan, one shard.

    A query batch builds its LUTs, the shard scans every row and answers a
    local top-k — or, with ``vectors``, an ADC shortlist of
    ``shortlist_mult · k`` re-ranked exactly — and ``partial_merge`` merges
    the shard shortlists, dropping shards reported dead via ``alive``.
    """
    codes: torch.Tensor               # (N, M) u8 codes, or fs4 (N, ceil(M/2))
    lut_fn: Callable                  # (Q, D) queries -> LUTs or QuantizedLUT
    vectors: Optional[torch.Tensor] = None   # (N, D): enables local rerank
    shortlist_mult: int = 4           # rerank shortlist = mult × k
    device: object = None             # default cuda
    n_shards: int = dataclasses.field(default=1, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.codes = self.codes.to(self.device).contiguous()
        self.n = int(self.codes.shape[0])
        if self.vectors is not None:
            self.vectors = self.vectors.to(self.device, torch.float32)

    def search(self, queries: torch.Tensor, *, k: int = 10,
               alive: Optional[Sequence[bool]] = None) -> SearchResult:
        queries = torch.atleast_2d(queries.to(self.device, torch.float32))
        kk = min(k, self.n)
        luts = self.lut_fn(queries)
        if self.vectors is None:
            gids, dists = _local_adc_topk(self.codes, luts, k=kk)
        else:
            gids, dists = _local_adc_serve(
                self.codes, self.vectors, luts, queries, k=kk,
                shortlist=min(self.shortlist_mult * kk, self.n))
        if alive is None:
            alive = [True] * self.n_shards
        merged = partial_merge([gids], [dists], alive, k)
        q = queries.shape[0]
        # n_dist counts the rows each alive shard scanned
        scanned = self.n * sum(bool(a) for a in alive)
        zeros = torch.zeros(q, dtype=torch.int32, device=self.device)
        return SearchResult(merged.ids, merged.dists, hops=zeros,
                            n_dist=torch.full((q,), scanned, dtype=torch.int32,
                                              device=self.device),
                            rounds=zeros.clone(),
                            truncated=torch.zeros(q, dtype=torch.bool,
                                                  device=self.device),
                            degraded=merged.degraded)

    def memory_bytes(self) -> int:
        vec = 0 if self.vectors is None else self.vectors.numel() * 4
        return self.codes.numel() * self.codes.element_size() + vec
