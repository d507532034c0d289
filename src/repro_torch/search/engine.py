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

The engines hold their state on ``device`` (default ``cuda``). The graph
engines thread the reference's adaptive-routing and budget knobs
(DESIGN.md §11, §13): ``entries=S`` seeds each beam with S entry points
from a PQ-hash coarse index over the resident codes (``search/seed.py``,
built lazily on the first seeded search), ``prune_eps=ε`` gates each
round's full scoring behind a partial-LUT lower bound over ``m_prefix``
subspaces, ``max_rounds`` / ``max_n_dist`` bound the work per call, and
``HybridEngine.search(rerank=)`` re-ranks a count of candidates, or none
(the degradation ladder's L4). ``entries=1, prune_eps=0`` and no budget
are bit-identical to the classic beam. The streaming engine
(``index/engine.py``) reuses ``_bulk_adc``, ``_prune_cfg`` and
``topk_lower``. Still to port: HNSW descent (``entry_fn``, with
``graphs/hnsw.py``), more than one shard and the graph-routed sharded
engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import retry as _retry
from repro_torch.dist.fault import partial_merge
from repro_torch.graphs.adjacency import Graph
from repro_torch.kernels import ops as kops
from repro_torch.pq.pack import QuantizedLUT, unpack_codes
from repro_torch.search import beam
from repro_torch.search import seed as sseed
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


def _lut_m(luts) -> int:
    """Number of subquantizers M from either LUT layout."""
    return (luts.lut if _is_packed(luts) else luts).shape[1]


def _prune_cfg(luts, prune_eps: float, m_prefix: int) -> tuple[int, int]:
    """Resolve the hop-pruning (m_prefix, m_total): ε ≤ 0 disables — (0,
    0), the bit-identical path; ``m_prefix=0`` picks a quarter of the
    subspaces; the prefix is clamped to [1, M−1] (an M=1 corpus never
    prunes)."""
    if prune_eps <= 0:
        return 0, 0
    mt = _lut_m(luts)
    if mt < 2:
        return 0, 0
    mp = m_prefix if m_prefix > 0 else max(1, mt // 4)
    return max(1, min(mp, mt - 1)), mt


class _GraphRouting:
    """The routing half shared by the two graph engines: the resident
    codes, the lazy seed index, and one ADC beam search with the
    adaptive-routing knobs. Subclasses set ``graph``, ``codes`` and
    ``lut_fn`` and call :meth:`_init_routing`."""

    def _init_routing(self) -> None:
        self._codes_p = kops.pad_sentinel_row(self.codes)
        self._seedix = None

    def _seed_index(self, luts) -> sseed.SeedIndex:
        """Coarse seeding index over the resident codes, built on the
        first ``entries > 1`` search (the lut type reveals the layout: fs4
        codes unpack once to build the table and are scored packed)."""
        if self._seedix is None:
            unpacked = (unpack_codes(self.codes, _lut_m(luts))
                        if _is_packed(luts) else self.codes)
            ix = sseed.build_seed_index(unpacked, device=self.device)
            self._seedix = dataclasses.replace(ix, codes=self.codes)
        return self._seedix

    def _route(self, luts, *, h, max_steps, expand, entries, prune_eps,
               m_prefix, max_rounds, max_n_dist) -> SearchResult:
        """The beam over the graph, with ``n_dist`` counting the seed
        probe's scored candidates."""
        packed = _is_packed(luts)
        dist_fn = beam.make_adc_dist_fn(self._codes_p, packed=packed)
        mp, mt = _prune_cfg(luts, prune_eps, m_prefix)
        lb_fn = (beam.make_adc_dist_fn(self._codes_p, packed=packed, m_prefix=mp)
                 if mp else None)
        cal_fn = beam.make_lb_scale_fn(packed=packed, m_prefix=mp) if mp else None
        seed_cost = 0
        if entries > 1:
            ix = self._seed_index(luts)
            entry = ix.seed_entries(luts, entries)
            seed_cost = ix.n_candidates
        else:
            entry = self.graph.medoid
        res = beam.beam_search(self.graph.neighbors, entry, luts, dist_fn, h=h,
                               max_steps=max_steps, expand=expand,
                               lb_dist_fn=lb_fn, m_prefix=mp, m_total=mt,
                               prune_eps=prune_eps if mp else 0.0,
                               lb_scale_fn=cal_fn, max_rounds=max_rounds,
                               max_n_dist=max_n_dist)
        if seed_cost:
            res.n_dist = res.n_dist + seed_cost
        return res


@dataclasses.dataclass
class InMemoryEngine(_GraphRouting):
    graph: Graph
    codes: torch.Tensor               # (N, M) uint8 codes, or fs4 (N, ceil(M/2))
    lut_fn: Callable                  # (Q, D) queries -> LUTs or QuantizedLUT
    device: object = None             # default cuda

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.graph = self.graph.to(self.device)
        self.codes = self.codes.to(self.device)
        self._init_routing()

    def search(self, queries: torch.Tensor, *, k: int = 10, h: int = 32,
               max_steps: int = 512, expand: int = 1, entries: int = 1,
               prune_eps: float = 0.0, m_prefix: int = 0,
               max_rounds=None, max_n_dist=None) -> SearchResult:
        """``max_rounds`` / ``max_n_dist`` are per-call budgets (DESIGN.md
        §13); an exhausted query returns best-so-far with
        ``truncated=True``."""
        queries = queries.to(self.device)
        res = self._route(self.lut_fn(queries), h=h, max_steps=max_steps,
                          expand=expand, entries=entries, prune_eps=prune_eps,
                          m_prefix=m_prefix, max_rounds=max_rounds,
                          max_n_dist=max_n_dist)
        return SearchResult(res.ids[:, :k], res.dists[:, :k], res.hops,
                            res.n_dist, res.rounds, res.truncated)

    def memory_bytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.graph.neighbors.numel() * 4)


@dataclasses.dataclass
class HybridEngine(_GraphRouting):
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
        self._init_routing()
        self._vec_p = kops.pad_sentinel_row(self.vectors.float())

    def search(self, queries: torch.Tensor, *, k: int = 10, h: int = 32,
               max_steps: int = 512, rerank: int = 0, expand: int = 1,
               entries: int = 1, prune_eps: float = 0.0, m_prefix: int = 0,
               max_rounds=None, max_n_dist=None) -> SearchResult:
        """``rerank`` = how many beam candidates to re-rank exactly (0 → h;
        NEGATIVE skips the rerank and answers from the ADC distances — the
        degradation ladder's L4, saving the "SSD" vector reads).
        ``max_rounds`` / ``max_n_dist``: per-call budgets."""
        skip_rerank = rerank < 0
        rerank = h if rerank <= 0 else rerank
        k = min(k, rerank)  # cannot return more results than candidates
        queries = queries.to(self.device)
        res = self._route(self.lut_fn(queries), h=h, max_steps=max_steps,
                          expand=expand, entries=entries, prune_eps=prune_eps,
                          m_prefix=m_prefix, max_rounds=max_rounds,
                          max_n_dist=max_n_dist)
        if skip_rerank:
            ids, dists = res.ids[:, :k], res.dists[:, :k]
        else:
            ids, dists = _exact_rerank(self._vec_p, queries, res.ids, rerank, k)
        return SearchResult(ids, dists, res.hops, res.n_dist, res.rounds,
                            res.truncated)

    def io_time(self, res: SearchResult, *, expand: int = 1, entries: int = 1,
                io_fault_p: float = 0.0, retry: Optional[_retry.RetryPolicy] = None,
                measured_io_s: Optional[float] = None) -> torch.Tensor:
        """Modeled SSD time per query: one 4 KiB block read per expansion,
        but the ≤E reads of a round are issued concurrently, so the
        wall-clock is ROUNDS × latency (``ceil(hops/E)`` for a result
        without rounds). A seeded search (``entries > 1``) adds one batched
        read for the bucket probe. With ``io_fault_p`` and ``retry``, each
        read costs the closed-form expected time of a retried call
        (``retry.expected_retry_time_s``). ``measured_io_s`` replaces the
        model by a measured batch-total stall, spread over the batch."""
        if measured_io_s is not None:
            q = int(res.hops.shape[0])
            return torch.full((q,), measured_io_s / max(1, q),
                              dtype=torch.float32, device=res.hops.device)
        if res.rounds is not None:
            rounds = res.rounds.float()
        else:
            rounds = torch.ceil(res.hops.float() / expand)
        if entries > 1:
            rounds = rounds + 1.0
        per_read = self.io_latency_s
        if io_fault_p > 0.0 and retry is not None:
            per_read = _retry.expected_retry_time_s(retry, self.io_latency_s,
                                                    io_fault_p)
        return rounds * torch.tensor(per_read, dtype=torch.float32,
                                     device=rounds.device)

    def memory_bytes(self) -> int:
        # resident = codes (+ codebook, negligible); graph+vectors on SSD
        return self.codes.numel() * self.codes.element_size()


def _exact_rerank(vec_p: torch.Tensor, queries: torch.Tensor,
                  cand_ids: torch.Tensor, rerank: int, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact distances of the first ``rerank`` beam candidates; the k best
    (ties → lower slot). Sentinel candidates rank +inf."""
    cand = cand_ids[:, :rerank].long()
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
               alive: Optional[Sequence[bool]] = None,
               h: Optional[int] = None, expand: Optional[int] = None,
               entries: Optional[int] = None, prune_eps: Optional[float] = None,
               m_prefix: Optional[int] = None) -> SearchResult:
        """Exhaustive scan. ``h``, ``expand``, ``entries``, ``prune_eps``
        and ``m_prefix`` are accepted for the engine protocol (one
        degradation policy drives every engine) and ignored: there is no
        beam to seed or prune."""
        del h, expand, entries, prune_eps, m_prefix
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
