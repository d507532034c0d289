"""Serving engines (paper §7): in-memory, SSD-hybrid (DiskANN), and the two
sharded scatter-gather scenarios (exhaustive scan and graph-routed).

Port of ``repro/search/engine.py``. The graph engines route with PQ-ADC
distances through the fused hop-ADC kernel, one launch per beam round for
the whole batch. They accept any quantizer exposing the (codes, lut_fn)
protocol (``pq.base.QuantizerModel`` of classic PQ, OPQ or the learned RPQ).

* :class:`InMemoryEngine` — codes + PG resident; next-hop selection and the
  final top-k use ONLY PQ distances. Memory = code bytes + graph.
* :class:`HybridEngine` — DiskANN: codes resident; full vectors + PG "on
  SSD". Routing uses ADC; every expansion costs one modeled SSD read; the
  final candidates are re-ranked with exact distances.
* :class:`ShardedEngine` — the exhaustive ADC scan over S shards with a
  local top-k per shard (or an ADC shortlist and exact rerank), merged by
  ``dist.fault.partial_merge`` so a dead shard degrades the answer instead
  of failing it.
* :class:`ShardedGraphEngine` — graph ROUTING over S shards (DESIGN.md §6):
  each shard owns a contiguous row range and an independent Vamana
  subgraph (``graphs/partition.py``), every query's beam runs on every
  shard, optionally exact-reranks against the shard's vectors, and the
  shard shortlists merge as in the scan engine, under an optional quorum
  deadline (``dist.fault.resolve_quorum``).

The reference runs its shards as a device mesh under ``shard_map``; here
the S shards are row blocks of one device. The scan engine makes one bulk
ADC launch over all rows and takes each shard's top-k on a (Q·S, n_local)
view; the graph engine routes the S·Q shard-local beams as one lockstep
beam over the partition's block-diagonal graph, one distance launch a
round. Both give the reference's per-shard answers.

Every engine takes either layout, and the type of ``lut_fn``'s return
decides which: (N, M) byte codes with (Q, M, K) f32 LUTs (u8), or
(N, ceil(M/2)) packed nibble codes with a ``pq.pack.QuantizedLUT`` (fs4).

The engines hold their state on ``device`` (default ``cuda``). The graph
engines thread the reference's adaptive-routing and budget knobs
(DESIGN.md §11, §13): ``entries=S`` seeds each beam with S entry points
from a PQ-hash coarse index over the resident codes (``search/seed.py``,
built lazily on the first seeded search; per shard for the sharded
engine), ``prune_eps=ε`` gates each round's full scoring behind a
partial-LUT lower bound over ``m_prefix`` subspaces, ``max_rounds`` /
``max_n_dist`` bound the work per call, and ``HybridEngine.search(rerank=)``
re-ranks a count of candidates, or none (the degradation ladder's L4).
``entries=1, prune_eps=0`` and no budget are bit-identical to the classic
beam. The streaming engine (``index/engine.py``) reuses ``_bulk_adc``,
``_prune_cfg`` and ``topk_lower`` (which lives in ``graphs/knn.py``).
``InMemoryEngine`` and ``HybridEngine`` take ``entry_fn(queries) → (Q,)``
entry ids (HNSW's ``descend``); an entry set (``entries > 1``) wins over
it, and without either the beam starts at the medoid.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.device import resolve_device, visible_cuda_devices
from repro_torch.dist import retry as _retry
from repro_torch.dist.fault import partial_merge, resolve_quorum
from repro_torch.graphs.adjacency import Graph
from repro_torch.graphs.knn import topk_lower
from repro_torch.graphs.partition import PartitionedGraph, block_diagonal
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
    adaptive-routing knobs. Subclasses set ``graph``, ``codes``,
    ``lut_fn`` and ``entry_fn`` and call :meth:`_init_routing`."""

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

    def _route(self, luts, queries, *, h, max_steps, expand, entries,
               prune_eps, m_prefix, max_rounds, max_n_dist) -> SearchResult:
        """The beam over the graph, with ``n_dist`` counting the seed
        probe's scored candidates. The entry: a seeded set when ``entries >
        1``, else ``entry_fn(queries)`` when the engine has one, else the
        medoid (the reference's precedence)."""
        seed_cost = 0
        if entries > 1:
            ix = self._seed_index(luts)
            entry = ix.seed_entries(luts, entries)
            seed_cost = ix.n_candidates
        elif self.entry_fn is not None:
            entry = self.entry_fn(queries)
        else:
            entry = self.graph.medoid
        return _adc_beam(self.graph.neighbors, self._codes_p, entry, luts,
                         seed_cost, h=h, max_steps=max_steps, expand=expand,
                         prune_eps=prune_eps, m_prefix=m_prefix,
                         max_rounds=max_rounds, max_n_dist=max_n_dist)


def _adc_beam(neighbors, codes_p, entry, luts, seed_cost: int, *, h, max_steps,
              expand, prune_eps, m_prefix, max_rounds, max_n_dist,
              lanes_per_query: int = 1) -> SearchResult:
    """One ADC beam search over sentinel-padded ``codes_p`` with the hop
    pruning and budget knobs; ``seed_cost`` (the seed probe's scored
    candidates) is added to ``n_dist``."""
    packed = _is_packed(luts)
    dist_fn = beam.make_adc_dist_fn(codes_p, packed=packed)
    mp, mt = _prune_cfg(luts, prune_eps, m_prefix)
    lb_fn = beam.make_adc_dist_fn(codes_p, packed=packed, m_prefix=mp) if mp else None
    cal_fn = beam.make_lb_scale_fn(packed=packed, m_prefix=mp) if mp else None
    res = beam.beam_search(neighbors, entry, luts, dist_fn, h=h,
                           max_steps=max_steps, expand=expand,
                           lb_dist_fn=lb_fn, m_prefix=mp, m_total=mt,
                           prune_eps=prune_eps if mp else 0.0,
                           lb_scale_fn=cal_fn, max_rounds=max_rounds,
                           max_n_dist=max_n_dist,
                           lanes_per_query=lanes_per_query)
    if seed_cost:
        res.n_dist = res.n_dist + seed_cost
    return res


@dataclasses.dataclass
class InMemoryEngine(_GraphRouting):
    graph: Graph
    codes: torch.Tensor               # (N, M) uint8 codes, or fs4 (N, ceil(M/2))
    lut_fn: Callable                  # (Q, D) queries -> LUTs or QuantizedLUT
    device: object = None             # default cuda
    entry_fn: Optional[Callable] = None  # queries -> (Q,) entries (HNSW descend)

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
        res = self._route(self.lut_fn(queries), queries, h=h,
                          max_steps=max_steps, expand=expand, entries=entries,
                          prune_eps=prune_eps, m_prefix=m_prefix,
                          max_rounds=max_rounds, max_n_dist=max_n_dist)
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
    entry_fn: Optional[Callable] = None  # queries -> (Q,) entries (HNSW descend)

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
        res = self._route(self.lut_fn(queries), queries, h=h,
                          max_steps=max_steps, expand=expand, entries=entries,
                          prune_eps=prune_eps, m_prefix=m_prefix,
                          max_rounds=max_rounds, max_n_dist=max_n_dist)
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
# Sharded scatter-gather: S shards as row blocks of one device. Shard s owns
# rows [s·n_local, (s+1)·n_local) of the row-padded codes (and vectors);
# every per-shard result is the reference's shard_map body's, stacked on a
# leading (S,) axis.
# ==========================================================================

def _stack_rows(x: torch.Tensor, n_shards: int, n_local: int) -> torch.Tensor:
    """(N, ...) global rows → (S, n_local, ...) shard-stacked, zero-padded."""
    return kops.pad_rows_to_multiple(x, n_shards).reshape(
        (n_shards, n_local) + tuple(x.shape[1:]))


def _by_shard(t: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(Q·S, ...) query-major lanes (lane q·S + s) → (S, Q, ...)."""
    return t.reshape((-1, n_shards) + tuple(t.shape[1:])).transpose(0, 1)


def _lane_offsets(q: int, n_shards: int, n_local: int, device) -> torch.Tensor:
    """(Q·S, 1) first global row of each lane's shard: s·n_local."""
    off = torch.arange(n_shards, device=device) * n_local
    return off.repeat(q)[:, None]


def _shard_scan(codes: torch.Tensor, luts, n_shards: int,
                n_valid: Optional[int]) -> torch.Tensor:
    """ONE bulk ADC launch over every shard's rows, the padding rows (global
    row ≥ ``n_valid``) at +inf, viewed as (Q·S, n_local): row q·S + s is
    shard s's block for query q. Each distance depends only on its (query,
    row), so these are the floats of S per-shard scans."""
    d = _bulk_adc(codes, luts)
    if n_valid is not None and n_valid < d.shape[1]:
        pad = torch.arange(d.shape[1], device=d.device) >= n_valid
        d = d.masked_fill(pad, float("inf"))
    return d.reshape(d.shape[0] * n_shards, -1)


def sharded_adc_scan(codes: torch.Tensor, luts, *, n_shards: int, k: int,
                     n_valid: Optional[int] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter: row-stacked (S·n_local, M|Mb) codes × (Q, ...) LUTs → per-
    shard LOCAL top-k as (S, Q, k) GLOBAL ids + ADC distances (ties to the
    lower row, as ``lax.top_k``). ``n_valid`` = real rows (masks the last
    shard's padding)."""
    d = _shard_scan(codes, luts, n_shards, n_valid)
    q, n_local = d.shape[0] // n_shards, d.shape[1]
    vals, ids = topk_lower(d, k)
    ids = ids + _lane_offsets(q, n_shards, n_local, d.device)
    return _by_shard(ids, n_shards), _by_shard(vals, n_shards)


def sharded_adc_serve(codes: torch.Tensor, vectors: torch.Tensor, luts,
                      queries: torch.Tensor, *, n_shards: int, k: int,
                      shortlist: int, n_valid: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter with local exact rerank: each shard's ADC shortlist of
    ``min(shortlist, n_local)`` is re-ranked against its own rows of the
    row-stacked (S·n_local, D) ``vectors`` → (S, Q, k) global ids + exact
    distances."""
    d = _shard_scan(codes, luts, n_shards, n_valid)
    q, n_local = d.shape[0] // n_shards, d.shape[1]
    _, cand = topk_lower(d, min(shortlist, n_local))
    cand = cand + _lane_offsets(q, n_shards, n_local, d.device)   # global rows
    cv = vectors[cand].reshape(q, -1, vectors.shape[1])          # (Q, S·sl, D)
    exact = ((cv - queries[:, None, :]) ** 2).sum(dim=-1).reshape(cand.shape)
    if n_valid is not None:
        exact = torch.where(cand < n_valid, exact, float("inf"))
    vals, order = torch.sort(exact, dim=1, stable=True)
    gids = cand.gather(1, order[:, :k])
    return _by_shard(gids, n_shards), _by_shard(vals[:, :k], n_shards)


def merge_shard_topk(gids: torch.Tensor, dists: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather: (S, Q, k_s) per-shard shortlists → global (Q, k) top-k, ties
    to the earlier shard and slot. The all-shards-alive merge;
    ``ShardedEngine`` merges with ``dist.fault.partial_merge`` to tolerate
    dead shards."""
    q = gids.shape[1]
    vals, order = topk_lower(dists.transpose(0, 1).reshape(q, -1), k)
    return gids.transpose(0, 1).reshape(q, -1).gather(1, order), vals


def _zero_counters(q: int, device) -> dict:
    zeros = torch.zeros(q, dtype=torch.int32, device=device)
    return dict(hops=zeros, n_dist=zeros.clone(), rounds=zeros.clone(),
                truncated=torch.zeros(q, dtype=torch.bool, device=device))


@dataclasses.dataclass
class ShardedEngine:
    """Scatter-gather serving by exhaustive ADC scan over ``n_shards``
    shards (default: the visible CUDA devices, as the reference's default
    mesh).

    The shards are contiguous row blocks of one device: a query batch
    builds its LUTs, one scan covers every shard's rows, and each shard
    answers a local top-k — or, with ``vectors``, an ADC shortlist of
    ``shortlist_mult · k`` re-ranked exactly against its own rows — and
    ``partial_merge`` merges the shard shortlists, dropping shards reported
    dead via ``alive``.
    """
    codes: torch.Tensor               # (N, M) u8 codes, or fs4 (N, ceil(M/2))
    lut_fn: Callable                  # (Q, D) queries -> LUTs or QuantizedLUT
    vectors: Optional[torch.Tensor] = None   # (N, D): enables local rerank
    shortlist_mult: int = 4           # rerank shortlist = mult × k
    device: object = None             # default cuda
    n_shards: Optional[int] = None    # default: visible CUDA devices

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.n_shards is None:
            self.n_shards = visible_cuda_devices()
        codes = self.codes.to(self.device)
        self.n = int(codes.shape[0])
        self._codes_bytes = codes.numel() * codes.element_size()
        self.codes = kops.pad_rows_to_multiple(codes, self.n_shards).contiguous()
        self.n_local = self.codes.shape[0] // self.n_shards
        self._vec_bytes = 0
        if self.vectors is not None:
            vec = self.vectors.to(self.device, torch.float32)
            self._vec_bytes = vec.numel() * 4
            self.vectors = kops.pad_rows_to_multiple(vec, self.n_shards)

    def search(self, queries: torch.Tensor, *, k: int = 10,
               alive: Optional[Sequence[bool]] = None,
               h: Optional[int] = None, expand: Optional[int] = None,
               entries: Optional[int] = None, prune_eps: Optional[float] = None,
               m_prefix: Optional[int] = None) -> SearchResult:
        """Exhaustive sharded scan. ``h``, ``expand``, ``entries``,
        ``prune_eps`` and ``m_prefix`` are accepted for the engine protocol
        (one degradation policy drives every engine) and ignored: there is
        no beam to seed or prune."""
        del h, expand, entries, prune_eps, m_prefix
        queries = torch.atleast_2d(queries.to(self.device, torch.float32))
        kk = min(k, self.n_local)
        luts = self.lut_fn(queries)
        if self.vectors is None:
            gids, dists = sharded_adc_scan(self.codes, luts, n_shards=self.n_shards,
                                           k=kk, n_valid=self.n)
        else:
            gids, dists = sharded_adc_serve(
                self.codes, self.vectors, luts, queries, n_shards=self.n_shards,
                k=kk, shortlist=self.shortlist_mult * kk, n_valid=self.n)
        if alive is None:
            alive = [True] * self.n_shards
        merged = partial_merge(list(gids), list(dists), alive, k)
        q = queries.shape[0]
        # n_dist counts REAL rows scanned: each alive shard's slice of the n
        # rows (the padding rows it also touched are +inf-masked sentinels)
        scanned = sum(max(0, min(self.n - i * self.n_local, self.n_local))
                      for i, a in enumerate(alive) if a)
        counters = _zero_counters(q, self.device)
        counters["n_dist"] = torch.full((q,), scanned, dtype=torch.int32,
                                        device=self.device)
        return SearchResult(merged.ids, merged.dists, degraded=merged.degraded,
                            **counters)

    def memory_bytes(self) -> int:
        # UNPADDED sizes: what the index costs, not the divisibility slack
        return self._codes_bytes + self._vec_bytes


# ==========================================================================
# Graph-routed sharded serving (DESIGN.md §6): every shard's beam runs over
# its OWN Vamana subgraph. On one device the S subgraphs are the blocks of
# one block-diagonal graph (graphs/partition.block_diagonal) and the S
# beams of each query are S lanes of ONE lockstep beam (lane q·S + s), so a
# round is still one hop_adc / hop_adc_fs launch for the whole batch.
# ==========================================================================

def _graph_scatter(neighbors, medoids, codes, luts, *, k: int, h: int = 32,
                   max_steps: int = 512, n_valid: Optional[int] = None,
                   expand: int = 1, entry: Optional[torch.Tensor] = None,
                   seed_cost: int = 0, prune_eps: float = 0.0, m_prefix: int = 0,
                   max_rounds=None, max_n_dist=None, vectors=None, queries=None) -> tuple:
    """The one scatter body of :func:`sharded_graph_topk` and
    :func:`sharded_graph_serve`: the S·Q shard-local beams as one lockstep
    beam over the block-diagonal graph, then each lane's LOCAL top-k (or,
    with ``vectors``, its whole beam re-ranked exactly against its shard's
    rows). Returns the reference's per-shard outputs: (S, Q, k) global ids
    (-1 for sentinel and padding slots) and distances (+inf there), and
    (S, Q) hops, n_dist, rounds and truncated."""
    s, nl = int(neighbors.shape[0]), int(neighbors.shape[1])
    q = (luts.lut if _is_packed(luts) else luts).shape[0]
    nbrs, meds = block_diagonal(PartitionedGraph(neighbors=neighbors, medoids=medoids,
                                                 n=s * nl))
    codes_p = kops.pad_sentinel_row(
        codes.reshape((s * nl,) + tuple(codes.shape[2:]))).contiguous()
    if entry is None:
        entry = meds.repeat(q)
    res = _adc_beam(nbrs, codes_p, entry, luts, seed_cost, h=h,
                    max_steps=max_steps, expand=expand, prune_eps=prune_eps,
                    m_prefix=m_prefix, max_rounds=max_rounds,
                    max_n_dist=max_n_dist, lanes_per_query=s)
    if vectors is None:
        ids, d = res.ids[:, :k].long(), res.dists[:, :k]
    else:
        # DiskANN-style local refinement: the whole beam re-ranked against
        # the shard's own rows (sentinel slots rank +inf whatever row the
        # clamped id reads)
        vec = vectors.reshape(s * nl, vectors.shape[-1])
        cand = res.ids.long()
        cv = vec[cand.clamp(max=s * nl - 1)].reshape(q, -1, vec.shape[1])
        exact = ((cv - queries.float()[:, None, :]) ** 2).sum(dim=-1).reshape(cand.shape)
        exact = torch.where(torch.isfinite(res.dists), exact, float("inf"))
        d, order = torch.sort(exact, dim=1, stable=True)
        ids, d = cand.gather(1, order[:, :k]), d[:, :k]
    # sentinel slots and padding rows become (-1, +inf): the merge never
    # sees them
    n_valid = s * nl if n_valid is None else n_valid
    ok = (ids < n_valid) & torch.isfinite(d)
    lanes = (torch.where(ok, ids, -1), torch.where(ok, d, float("inf")),
             res.hops, res.n_dist, res.rounds, res.truncated)
    return tuple(_by_shard(t, s) for t in lanes)


def sharded_graph_topk(neighbors: torch.Tensor, medoids: torch.Tensor,
                       codes: torch.Tensor, luts, *, k: int, **knobs) -> tuple:
    """Scatter: shard-stacked independent subgraphs × the batch's LUTs →
    per-shard LOCAL top-k with GLOBAL ids.

    Args:
      neighbors:  (S, n_local, R) stacked local adjacency (graphs/partition),
                  sentinel ``n_local``.
      medoids:    (S,) local entry vertices.
      codes:      (S, n_local, M) shard-stacked codes, or fs4 (S, n_local,
                  ceil(M/2)) with a ``QuantizedLUT``.
      luts:       (Q, M, K) query LUTs (or a ``QuantizedLUT``), shared by
                  every shard.
      k:          per-shard shortlist size.
      knobs:      ``h`` / ``max_steps`` / ``expand`` (each LOCAL beam's
                  width, round cap and frontier; 32, 512, 1), ``n_valid``
                  (total REAL rows, masking the last shard's padding),
                  ``entry`` ((Q·S,) or (Q·S, E) global entry ids, lane q·S +
                  s; default each shard's medoid) with ``seed_cost`` (the
                  seed probe's candidates a lane, added to ``n_dist``),
                  ``prune_eps`` / ``m_prefix`` / ``max_rounds`` /
                  ``max_n_dist`` (each local beam's pruning and budgets).

    Returns (gids (S, Q, k), dists (S, Q, k), hops, n_dist, rounds,
    truncated (S, Q)). Each shard routes ONLY over its own subgraph.
    """
    return _graph_scatter(neighbors, medoids, codes, luts, k=k, **knobs)


def sharded_graph_serve(neighbors: torch.Tensor, medoids: torch.Tensor,
                        codes: torch.Tensor, vectors: torch.Tensor, luts,
                        queries: torch.Tensor, *, k: int, **knobs) -> tuple:
    """Scatter with local exact rerank: like :func:`sharded_graph_topk`, but
    every shard re-ranks its whole beam against its resident vector rows
    (S, n_local, D) before answering — the DiskANN shortlist with the SSD
    replaced by the shard's own memory."""
    return _graph_scatter(neighbors, medoids, codes, luts, k=k, vectors=vectors,
                          queries=queries, **knobs)


@dataclasses.dataclass
class ShardedGraphEngine:
    """Graph-ROUTED scatter-gather serving over ``n_shards`` shards.

    The dataset is partitioned into contiguous per-shard row ranges with an
    independent Vamana subgraph per shard (``graphs/partition.py``). Each
    query's beam runs on every shard, walking only that shard's subgraph
    with ADC distances, optionally exact-reranks its beam against the
    shard's resident vector rows (DiskANN-style), and answers a LOCAL top-k
    with GLOBAL ids; ``partial_merge`` merges the shard shortlists, so a
    dead shard's row range drops out of the answer and the query never
    fails.

    Attributes:
      graph:    PartitionedGraph over the same row order as ``codes``.
      codes:    (N, M) u8 codes, or fs4 (N, ceil(M/2)), global row order.
      lut_fn:   (Q, D) queries → LUTs or QuantizedLUT.
      vectors:  optional (N, D) full vectors; enables local exact rerank.
      device:   default cuda.
      n_shards: the reference's mesh size (default: the visible CUDA
                devices); must equal the graph's shard count.
    """
    graph: PartitionedGraph
    codes: torch.Tensor
    lut_fn: Callable
    vectors: Optional[torch.Tensor] = None
    device: object = None
    n_shards: Optional[int] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.n_shards is None:
            self.n_shards = visible_cuda_devices()
        if self.n_shards != self.graph.n_shards:
            raise ValueError(
                f"graph has {self.graph.n_shards} shards but the engine has "
                f"{self.n_shards} — partition with n_shards={self.n_shards}")
        self.n = int(self.graph.n)
        if int(self.codes.shape[0]) != self.n:
            raise ValueError(f"codes rows {self.codes.shape[0]} != "
                             f"graph rows {self.n}")
        self.graph = self.graph.to(self.device)
        self.n_local = self.graph.n_local
        codes = self.codes.to(self.device)
        self._codes_bytes = codes.numel() * codes.element_size()
        self.codes = codes
        self._codes_stk = _stack_rows(codes, self.n_shards, self.n_local).contiguous()
        self._vec_bytes = 0
        if self.vectors is not None:
            vec = self.vectors.to(self.device, torch.float32)
            self._vec_bytes = vec.numel() * 4
            self._vec_stk = _stack_rows(vec, self.n_shards, self.n_local)
            self.vectors = vec
        self._seedstk = None

    def _shard_codes(self, s: int) -> torch.Tensor:
        return self._codes_stk[s]

    def _seed_stack(self, luts) -> tuple:
        """Per-shard coarse seeding indexes, built on the first ``entries >
        1`` search: one ``seed.build_seed_index`` over each shard's REAL rows
        (a beam must never start on padding), with ``k`` and ``m_hash``
        shared across shards and the pivots padded with -1 to one width, as
        the reference stacks them. Returns (tables, pivots, k, m_hash,
        candidates scored per query)."""
        if self._seedstk is None:
            codes = self.codes
            if _is_packed(luts):
                codes = unpack_codes(codes, _lut_m(luts))
            codes = _stack_rows(codes, self.n_shards, self.n_local)
            k = int(codes.max()) + 1
            m_hash = sseed.auto_m_hash(codes.shape[2], k)
            ixs = [sseed.build_seed_index(
                codes[i, :max(1, min(self.n - i * self.n_local, self.n_local))],
                k=k, m_hash=m_hash, device=self.device)
                for i in range(self.n_shards)]
            pw = max(ix.pivots.shape[0] for ix in ixs)
            pivots = [torch.nn.functional.pad(ix.pivots, (0, pw - ix.pivots.shape[0]),
                                              value=-1) for ix in ixs]
            self._seedstk = ([ix.table for ix in ixs], pivots, k, m_hash,
                             ixs[0].table.shape[1] + pw)
        return self._seedstk

    def _entries(self, luts, q: int, entries: int) -> tuple[torch.Tensor, int]:
        """Each lane's entry: its shard's medoid, or with ``entries > 1`` the
        shard's own seeded entry set (global ids, -1 padding). Returns
        ((Q·S,) or (Q·S, entries) ids, the seed probe's cost per lane)."""
        if entries <= 1:
            return None, 0
        tables, pivots, k, m_hash, cost = self._seed_stack(luts)
        per = []
        for s in range(self.n_shards):
            e = sseed.seed_entries_from(tables[s], pivots[s], self._shard_codes(s),
                                        luts, k=k, m_hash=m_hash, s=entries)
            per.append(torch.where(e >= 0, e + s * self.n_local, -1))
        return torch.stack(per, dim=1).reshape(q * self.n_shards, entries), cost

    def _scatter(self, luts, queries: torch.Tensor, *, k: int, entries: int,
                 **knobs) -> tuple:
        """Every shard's LOCAL answer through :func:`sharded_graph_topk` (or
        :func:`sharded_graph_serve` with vectors): (S, Q, k) global ids and
        distances, and the (S, Q) counters of each shard's beam."""
        entry, seed_cost = self._entries(luts, queries.shape[0], entries)
        stk = dict(k=k, n_valid=self.n, entry=entry, seed_cost=seed_cost, **knobs)
        nbrs, meds = self.graph.neighbors, self.graph.medoids
        if self.vectors is None:
            return sharded_graph_topk(nbrs, meds, self._codes_stk, luts, **stk)
        return sharded_graph_serve(nbrs, meds, self._codes_stk, self._vec_stk, luts,
                                   queries, **stk)

    def search(self, queries: torch.Tensor, *, k: int = 10, h: int = 32,
               max_steps: int = 512, expand: int = 1,
               alive: Optional[Sequence[bool]] = None, entries: int = 1,
               prune_eps: float = 0.0, m_prefix: int = 0,
               max_rounds=None, max_n_dist=None,
               deadline_s: Optional[float] = None,
               quorum: Optional[int] = None,
               shard_latency_s: Optional[Sequence[float]] = None
               ) -> SearchResult:
        """Route every query on every (alive) shard, merge the shortlists.

        ``hops`` / ``n_dist`` are the SUM over merged shards (the total
        work), ``rounds`` the MAX (the shards route concurrently), and
        ``truncated`` is any-over-merged-shards. ``entries`` / ``prune_eps``
        / ``m_prefix`` / ``max_rounds`` / ``max_n_dist`` apply to EVERY
        shard's beam: each shard seeds from its own coarse index.
        ``deadline_s`` + ``shard_latency_s`` model the quorum merge
        (``dist.fault.resolve_quorum``): shards over the deadline count as
        dead for this call unless fewer than ``quorum`` (default: a
        majority of the alive) would remain. ``degraded`` is True whenever
        the answer merged fewer shards than exist."""
        queries = torch.atleast_2d(queries.to(self.device, torch.float32))
        kk = min(k, h, self.n_local)
        luts = self.lut_fn(queries)
        gids, dists, hops, n_dist, rounds, truncated = self._scatter(
            luts, queries, k=kk, h=h, max_steps=max_steps, expand=expand,
            entries=entries, prune_eps=prune_eps, m_prefix=m_prefix,
            max_rounds=max_rounds, max_n_dist=max_n_dist)
        alive = [True] * self.n_shards if alive is None else list(alive)
        quorum_degraded = False
        if deadline_s is not None or quorum is not None:
            lat = (list(shard_latency_s) if shard_latency_s is not None
                   else [0.0] * self.n_shards)
            decision = resolve_quorum(alive, lat, deadline_s, quorum)
            alive = list(decision.alive)
            quorum_degraded = decision.degraded
        merged = partial_merge(list(gids), list(dists), alive, k)
        q = queries.shape[0]
        mask = torch.tensor(alive, dtype=torch.bool, device=self.device)
        if bool(mask.any()):
            lanes = lambda t: t.transpose(0, 1)[:, mask]
            counters = dict(hops=lanes(hops).sum(dim=1, dtype=torch.int32),
                            n_dist=lanes(n_dist).sum(dim=1, dtype=torch.int32),
                            rounds=lanes(rounds).amax(dim=1),
                            truncated=lanes(truncated).any(dim=1))
        else:  # every shard dead: sentinel answer, zero-work counters
            counters = _zero_counters(q, self.device)
        return SearchResult(merged.ids, merged.dists,
                            degraded=bool(merged.degraded or quorum_degraded),
                            **counters)

    def memory_bytes(self) -> int:
        # UNPADDED codes + per-shard adjacency (+ vectors when resident)
        return (self._codes_bytes + self.graph.neighbors.numel() * 4
                + self._vec_bytes)
