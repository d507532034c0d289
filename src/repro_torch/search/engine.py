"""Serving engines (paper §7): in-memory and SSD-hybrid (DiskANN).

Port of the single-device engines of ``repro/search/engine.py``, u8 layout
((N, M) byte codes + (Q, M, K) f32 LUTs) and the default ``search()``
arguments. Both route with PQ-ADC distances through the fused ``hop_adc``
kernel, one launch per beam round for the whole batch. They accept any
quantizer exposing the (codes, lut_fn) protocol (``pq.base.QuantizerModel``
of classic PQ, OPQ or the learned RPQ).

* :class:`InMemoryEngine` — codes + PG resident; next-hop selection and the
  final top-k use ONLY PQ distances. Memory = N·M bytes + graph.
* :class:`HybridEngine` — DiskANN: codes resident; full vectors + PG "on
  SSD". Routing uses ADC; every expansion costs one modeled SSD read; the
  final candidates are re-ranked with exact distances.

The engines hold their state on ``device`` (default ``cuda``) and route
from the graph's medoid. The fs4 layout, multi-entry seeding, hop pruning,
budgets, the degradation ladder's rerank levels and the sharded engines
belong to later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.adjacency import Graph
from repro_torch.kernels import ops as kops
from repro_torch.search import beam
from repro_torch.search.beam import SearchResult


@dataclasses.dataclass
class InMemoryEngine:
    graph: Graph
    codes: torch.Tensor               # (N, M) uint8 compact codes
    lut_fn: Callable                  # (Q, D) queries -> (Q, M, K) LUTs
    device: object = None             # default cuda

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.graph = self.graph.to(self.device)
        self.codes = self.codes.to(self.device)
        self._codes_p = kops.pad_sentinel_row(self.codes)
        self._dist_fn = beam.make_adc_dist_fn(self._codes_p)

    def search(self, queries: torch.Tensor, *, k: int = 10, h: int = 32,
               max_steps: int = 512, expand: int = 1) -> SearchResult:
        queries = queries.to(self.device)
        luts = self.lut_fn(queries)
        res = beam.beam_search(self.graph.neighbors, self.graph.medoid, luts,
                               self._dist_fn, h=h, max_steps=max_steps,
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
        self._dist_fn = beam.make_adc_dist_fn(self._codes_p)

    def search(self, queries: torch.Tensor, *, k: int = 10, h: int = 32,
               max_steps: int = 512, expand: int = 1) -> SearchResult:
        """ADC-routed beam of width h, then the exact rerank of all h
        candidates."""
        k = min(k, h)  # cannot return more results than candidates
        queries = queries.to(self.device)
        luts = self.lut_fn(queries)
        res = beam.beam_search(self.graph.neighbors, self.graph.medoid, luts,
                               self._dist_fn, h=h, max_steps=max_steps,
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
