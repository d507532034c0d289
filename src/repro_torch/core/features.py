"""Sampling-based feature extractor (paper §5, Algorithms 1 and 2).

Port of ``repro/core/features.py``.

Neighborhood features (Alg. 1, n-propagation sampling), batched: each
anchor's ≤ n-hop neighborhood is gathered from the padded adjacency,
deduplicated, ranked by exact distance, and one positive is drawn from the
top ``k_pos`` and one hard negative from the next ``k_neg``. The ranking is
deterministic (:func:`rank_neighborhoods`, stable sorts as
``jnp.argsort``); the draws are separate, so a test can hand in the
reference's (``draws=``).

Routing features (Alg. 2), batched: real beam searches with the current
quantizer's ADC distances record the ranked candidate set at every round
(``beam_search_trace``), and each set is labelled with its candidate that
is truly closest to the query in the original space.

Sampling under churn (the streaming index's codebook refresh): both
samplers take an optional ``tombstones`` bitset (the deleted-id words of
``index.segment.Tombstones``). No dead vertex reaches a feature: triplet
neighborhoods and traced routing beams mask dead ids to the sentinel, a
dead anchor invalidates its triplet, and the routing label is the
exact-distance argmin over the live candidates only.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.graphs.adjacency import Graph
from repro_torch.kernels import ops as kops
from repro_torch.search import beam

# Bytes of gathered candidate rows per chunk of anchors in
# rank_neighborhoods: an anchor gathers R + R² rows of D f32 (2.1 MB at
# R=64, D=128), so 8192 anchors at once would hold 17 GB.
TRIPLET_CHUNK_BYTES = 1 << 29


class TripletBatch(NamedTuple):
    v: torch.Tensor      # (B,) anchor ids
    vpos: torch.Tensor   # (B,) positive ids
    vneg: torch.Tensor   # (B,) negative ids
    valid: torch.Tensor  # (B,) bool — neighborhood was large enough


class RoutingBatch(NamedTuple):
    q: torch.Tensor      # (B, D) query vectors
    cand: torch.Tensor   # (B, h) ranked candidate ids (sentinel-padded)
    label: torch.Tensor  # (B,) index of the true best candidate within cand
    valid: torch.Tensor  # (B,) bool — hop happened and ≥ 2 candidates


# --------------------------------------------------------------------------
# Alg. 1 — n-propagation sampling
# --------------------------------------------------------------------------

def _dead_fn(tombstones, n: int, device) -> Callable:
    """ids → bool "tombstoned" mask (all False without a bitset). Ids
    outside [0, n) — the sentinel, padding — are never dead."""
    if tombstones is None:
        return lambda ids: torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    ts = beam.as_bitset(tombstones, device)
    return lambda ids: beam._is_dead(ts, ids.long(), n)


def _gather_hops(neighbors: torch.Tensor, v: torch.Tensor,
                 n_hops: int) -> torch.Tensor:
    """(B,) anchors → (B, R + R² + ...) candidate ids, duplicates included,
    sentinel n past a sentinel frontier."""
    n, r = neighbors.shape
    frontier = neighbors[v].long()
    cand = [frontier]
    for _ in range(n_hops - 1):
        nxt = neighbors[torch.where(frontier < n, frontier, 0)].long()
        nxt = torch.where((frontier < n)[:, :, None], nxt, n)
        frontier = nxt.reshape(v.shape[0], -1)
        cand.append(frontier)
    return torch.cat(cand, dim=1)


def rank_neighborhoods(graph: Graph, x: torch.Tensor, anchors: torch.Tensor, *,
                       n_hops: int = 2, keep: Optional[int] = None,
                       tombstones=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1's deterministic half: each anchor's distinct ≤ n-hop
    neighbors (itself and tombstoned vertices excluded), ranked by exact
    distance to it.

    Returns (ranked (B, keep) int64 ids — the nearest first, sentinel n
    after the last valid one — and n_valid (B,) int64). Ties keep the
    ascending-id order (two stable sorts). Anchors go in chunks of
    ``TRIPLET_CHUNK_BYTES`` of gathered rows."""
    n, d = x.shape
    anchors = anchors.long()
    c = sum(graph.degree ** (i + 1) for i in range(n_hops))
    keep = c if keep is None else min(keep, c)
    chunk = max(1, TRIPLET_CHUNK_BYTES // (c * d * x.element_size()))
    dead = _dead_fn(tombstones, n, x.device)
    ranked, n_valid = [], []
    for s in range(0, anchors.shape[0], chunk):
        v = anchors[s:s + chunk]
        cand = _gather_hops(graph.neighbors, v, n_hops)
        cand = torch.where((cand == v[:, None]) | dead(cand), n, cand)
        # dedup: sort by id, keep the first of each run
        sc = torch.sort(cand, dim=1, stable=True).values
        dup = torch.zeros_like(sc, dtype=torch.bool)
        dup[:, 1:] = sc[:, 1:] == sc[:, :-1]
        cand = torch.where(dup, n, sc)
        # the sentinel reads row n-1 and is masked: no padded copy of x
        dist = ((x[torch.clamp(cand, max=n - 1)] - x[v][:, None, :]) ** 2).sum(dim=-1)
        dist = torch.where(cand == n, float("inf"), dist)
        rank = torch.sort(dist, dim=1, stable=True).indices
        ranked.append(cand.gather(1, rank[:, :keep]))
        n_valid.append((dist < float("inf")).sum(dim=1))
    return torch.cat(ranked), torch.cat(n_valid)


def uniform_draws(generator: Optional[torch.Generator]) -> Callable:
    """``draws`` for :func:`sample_triplets`: for each anchor one index
    uniform in [0, max(span, 1)) per span tensor."""
    def draws(*spans):
        out = []
        for span in spans:
            hi = torch.clamp(span, min=1)
            u = torch.rand(span.shape, generator=generator, device=span.device,
                           dtype=torch.float64)
            out.append(torch.minimum((u * hi).long(), hi - 1))
        return tuple(out)
    return draws


def sample_triplets(graph: Graph, x: torch.Tensor, anchors: torch.Tensor, *,
                    n_hops: int = 2, k_pos: int = 10, k_neg: int = 30,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Callable] = None,
                    tombstones=None) -> TripletBatch:
    """Batched Alg. 1. anchors: (B,) vertex ids.

    ``draws(pos_span, neg_span) → (pos_idx, neg_off)`` picks, per anchor, a
    positive rank in [0, max(pos_span, 1)) and a negative offset in
    [0, max(neg_span, 1)); by default uniform from ``generator``.
    ``tombstones``: dead vertices never rank as positives or negatives, and
    a dead anchor gives ``valid=False`` (callers draw anchors from the live
    set; this is the backstop)."""
    draws = draws or uniform_draws(generator)
    ranked, n_valid = rank_neighborhoods(graph, x, anchors, n_hops=n_hops,
                                         keep=k_pos + k_neg,
                                         tombstones=tombstones)
    pos_hi = torch.clamp(n_valid, max=k_pos)
    neg_hi = torch.clamp(n_valid, max=k_pos + k_neg)
    pos_idx, neg_off = draws(pos_hi, neg_hi - pos_hi)
    neg_idx = torch.clamp(pos_hi + neg_off, max=ranked.shape[1] - 1)
    vpos = ranked.gather(1, pos_idx[:, None].long())[:, 0]
    vneg = ranked.gather(1, neg_idx[:, None].long())[:, 0]
    valid = ((n_valid >= 2) & (neg_hi > pos_hi)
             & ~_dead_fn(tombstones, graph.n, x.device)(anchors))
    return TripletBatch(v=anchors.long(), vpos=vpos, vneg=vneg, valid=valid)


# --------------------------------------------------------------------------
# Alg. 2 — routing features sampling
# --------------------------------------------------------------------------

@torch.no_grad()
def sample_routing(graph: Graph, x: torch.Tensor, queries: torch.Tensor,
                   codes: torch.Tensor, lut_fn: Callable, *, h: int = 16,
                   trace_len: int = 48, max_steps: int = 128,
                   tombstones=None, entry=None) -> RoutingBatch:
    """Batched Alg. 2 with exact-distance next-hop labels, routed from the
    medoid (or ``entry``, e.g. the streaming engine's re-anchored live
    vertex).

    codes: (N, M) CURRENT compact codes of the base vectors (re-extract when
    the quantizer moves, paper Fig. 2). ``tombstones``: the beams route
    around dead vertices, and every traced candidate is re-scrubbed (a
    rescued dead entry, an unfilled beam's dead slots), so each label is a
    live vertex."""
    n = graph.n
    dist_fn = beam.make_adc_dist_fn(kops.pad_sentinel_row(codes))
    tr = beam.beam_search_trace(graph.neighbors,
                                graph.medoid if entry is None else entry,
                                lut_fn(queries), dist_fn, h=h,
                                max_steps=max_steps, trace_len=trace_len,
                                tombstones=tombstones)
    nq = queries.shape[0]
    cand = tr.beam_ids.reshape(nq * trace_len, h).long()
    cand = torch.where(_dead_fn(tombstones, n, queries.device)(cand), n, cand)
    hop_valid = tr.hop_valid.reshape(nq * trace_len)
    qrep = torch.repeat_interleave(queries, trace_len, dim=0)
    cv = x[torch.where(cand == n, 0, cand)]
    dexact = ((cv - qrep[:, None, :]) ** 2).sum(dim=-1)
    dexact = torch.where(cand == n, float("inf"), dexact)
    label = torch.argmin(dexact, dim=1)
    valid = hop_valid & ((cand != n).sum(dim=1) >= 2)
    return RoutingBatch(q=qrep, cand=cand, label=label, valid=valid)


def subsample_routing(batch: RoutingBatch, size: int, *,
                      generator: Optional[torch.Generator] = None,
                      idx: Optional[torch.Tensor] = None) -> RoutingBatch:
    """Pick ``size`` examples uniformly among the valid ones (all of them
    invalid → rows flagged invalid). ``idx`` (size,) indexes the valid
    examples in their stable order; by default uniform from ``generator``."""
    pri = torch.sort((~batch.valid).to(torch.uint8), stable=True).indices
    nvalid = batch.valid.sum()
    if idx is None:
        idx, = uniform_draws(generator)(nvalid.expand(size))
    take = pri[idx.long()]
    return RoutingBatch(q=batch.q[take], cand=batch.cand[take],
                        label=batch.label[take],
                        valid=batch.valid[take] & (nvalid > 0))
