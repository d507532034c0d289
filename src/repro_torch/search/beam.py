"""Batched graph beam search — the routing engine (paper §3.1, Alg. 2 core).

Port of ``repro/search/beam.py``. The JAX side runs one vmapped
``lax.while_loop`` per query; here the whole (Q, ·) batch steps in lockstep
rounds. Each round computes the JAX loop condition per lane (``live``) and
updates every state tensor under ``torch.where(live, new, old)``, so a
converged lane freezes exactly as vmap freezes it, and ``rounds`` is each
lane's own step count.

* beam = (Q, h) ids / dists / expanded, kept sorted by a merge whose ties go
  to the lower index, as ``lax.top_k`` breaks them (a stable sort);
* visited set = a bitset of ``(n+31)//32 + 1`` words per query, the JAX
  word layout, stored as int32 (PyTorch's uint32 lacks the CUDA bitwise
  ops); bits are set by a scatter-add of distinct, clear bits;
* distances come from ``dist_fn(qdatas (Q, ...), ids (Q, B)) → (Q, B)``,
  so one round is ONE distance call for the whole batch — with
  :func:`make_adc_dist_fn`, one ``hop_adc`` (fs4: ``hop_adc_fs``) kernel
  launch. ``qdatas`` is a (Q, ...) tensor or a per-query
  :class:`~repro_torch.pq.pack.QuantizedLUT`.

``expand=E`` expands the E best unexpanded entries per round, their E·R
neighbors deduplicated and scored in one call (DESIGN.md §9); ``expand=1``
keeps the classic semantics, in-row duplicates included.

``lanes_per_query=L`` runs L lanes per query (lane ``q·L + l``) against Q
rows of LUTs: the sharded engines' S shard-local beams of one query, over
the partition's block-diagonal graph, still one distance call a round.

``beam_search_trace`` also records the ranked beam after every round, the
paper's Definition 6 routing features (RPQ training's ``sample_routing``).

The reference's other knobs are here too, each with its zero-cost OFF
value bit-identical to the classic beam:

* **entry sets** (Q, S): the S entries are deduplicated, scored in one
  ``dist_fn`` call, ranked (ties to the lower lane) and installed as the
  initial beam; lanes outside [0, N) are padding (``search/seed.py`` pads
  with -1). S = 1 runs the classic single-entry init op for op.
* **tombstones**: a bitset over vertex ids (the visited set's word
  layout). A dead frontier vertex is scored and counted, then ranks +inf; a
  dead ENTRY gets ``DEAD_ENTRY_DIST`` so the search still routes off it;
  dead ids are scrubbed from the returned beam after ``truncated`` is
  computed.
* **hop pruning** (``lb_dist_fn``, ``m_prefix``, ``m_total``,
  ``prune_eps``, ``lb_scale_fn``): each round first scores the frontier on
  the first ``m_prefix`` subspaces (a certified lower bound), and
  full-scores only the lanes with ``d_lb · cal · (1+ε) ≤ τ``, τ the worst
  beam distance. Pruned lanes stay visited. ``n_dist`` counts subspace
  units inside the loop and full-LUT equivalents (a ceiling division)
  after it. So each pruned round launches the distance kernel twice.
* **budgets** ``max_rounds`` / ``max_n_dist``: caps checked before each
  round in the lane's own loop condition; an exhausted lane freezes with
  its best-so-far beam and ``truncated=True``. ``None`` adds no check.

``make_adc_dist_fn(tombstones=)`` bakes a deleted-vertex mask into the
distance function instead (a frozen snapshot's variant: dead ids score
+inf, with neither the dead-entry rescue nor the scrub).

With the recorder of :mod:`repro_torch.common.spans` on, the beam emits the
span ``beam.init`` (from its start through the first ``bool(live.any())``)
and one ``beam.round`` per round (the loop's body through the
``bool(live.any())`` that decides the next round), and counts ``sync`` at
each of those waits for the card and at each of the hop-pruning set-up's
scalar copies to the card. Ops and their order are the same on and off.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common import spans
from repro_torch.kernels import ops as kops
from repro_torch.pq.pack import QuantizedLUT

INF = float("inf")

# Distance of a tombstoned ENTRY vertex: any real candidate outranks it, but
# it is finite, so the search still expands it (the deleted-medoid case).
DEAD_ENTRY_DIST = 1e30


@dataclasses.dataclass
class SearchResult:
    ids: torch.Tensor     # (Q, h) int32 ascending by dist (sentinel-padded)
    dists: torch.Tensor   # (Q, h) f32
    hops: torch.Tensor    # (Q,) int32 — number of node expansions
    n_dist: torch.Tensor  # (Q,) int32 — number of distance computations
    # (Q,) int32 — rounds (sequential trips) each query took; with
    # expand=E, rounds ∈ [ceil(hops/E), hops]
    rounds: torch.Tensor
    # (Q,) bool — stopped with unexpanded finite candidates pending
    # (max_steps cut it off): the beam is best-so-far, not converged
    truncated: torch.Tensor
    # True when the serving layer knows the answer is incomplete (a dead
    # shard dropped from the merge); False for beams and single engines
    degraded: bool = False


@dataclasses.dataclass
class Trace:
    beam_ids: torch.Tensor    # (Q, T, h) int32 beam AFTER each round's merge
    beam_dists: torch.Tensor  # (Q, T, h) f32
    hop_valid: torch.Tensor   # (Q, T) bool — round actually happened
    result: SearchResult


def _bit_get(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(Q, W) int32 bitset, (Q, B) int64 ids → (Q, B) bool membership."""
    words = bits.gather(1, idx >> 5)
    return ((words >> (idx & 31).to(torch.int32)) & 1).bool()


def _bit_masks(idx: torch.Tensor) -> torch.Tensor:
    """(Q, B) int64 ids → int32 words with the id's one bit set (bit 31
    wraps to the int32 sign bit, the same 32 bits as the JAX uint32)."""
    return (torch.ones_like(idx) << (idx & 31)).to(torch.int32)


def _first_occurrence(idx: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """Per row, True for the FIRST ``on`` lane holding each distinct id.

    Stable-sort the ids (off lanes pushed to +max so they sort last), mark
    lanes equal to their sorted predecessor as duplicates, scatter the
    flags back — the JAX function's sort-based branch; its all-pairs branch
    computes the same flags."""
    key = torch.where(on, idx, torch.iinfo(torch.int64).max)
    sk, order = torch.sort(key, dim=1, stable=True)
    first_sorted = torch.ones_like(on)
    first_sorted[:, 1:] = sk[:, 1:] != sk[:, :-1]
    return torch.zeros_like(on).scatter_(1, order, first_sorted) & on


def _scatter_bits_(bits: torch.Tensor, idx: torch.Tensor,
                   on: torch.Tensor) -> None:
    """Set bit ``idx`` of each row's bitset, in place, for every ``on`` lane.

    Precondition: the ``on`` lanes of a row hold DISTINCT ids whose bits are
    still clear. Then every (word, bit) contribution is unique and the
    scatter-ADD equals the missing scatter-OR."""
    word = torch.where(on, idx >> 5, 0)
    mask = torch.where(on, _bit_masks(idx), 0)
    bits.scatter_add_(1, word, mask)


def _normalize_entries(entry, nq: int, device) -> torch.Tensor:
    """``entry`` as a (Q, S) int64 entry-set matrix: a shared vertex (int
    or 0-d) or one vertex per query ((Q,)) become (Q, 1); (Q, S) entry sets
    pass through. S = 1 runs the classic single-entry init."""
    entry = torch.as_tensor(entry, device=device).long()
    if entry.dim() == 0:
        return entry.expand(nq, 1).contiguous()
    if entry.dim() == 1:
        entry = entry[:, None]
    if entry.dim() != 2 or entry.shape[0] != nq:
        raise ValueError(f"entry must be shared, (Q,) or (Q, S); got "
                         f"{tuple(entry.shape)} for Q={nq}")
    return entry


def as_bitset(words, device) -> torch.Tensor:
    """A (W,) bitset of 32-bit words (numpy uint32 as the reference keeps
    it, or any integer tensor) as the port's int32 words: the same 32 bits,
    bit 31 as the sign."""
    if isinstance(words, torch.Tensor) and words.dtype == torch.int32:
        return words.to(device)
    w = np.asarray(words.cpu() if isinstance(words, torch.Tensor) else words)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32).copy()).to(device)


def _is_dead(tombstones: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(Q, B) ids → bool, True where the id is a tombstoned vertex; lookups
    are guarded to [0, n) (sentinels and padding lanes are never dead)."""
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, 0)
    words = tombstones[safe >> 5]
    return (((words >> (safe & 31).to(torch.int32)) & 1) != 0) & ok


def beam_search(neighbors: torch.Tensor, entry, qdatas: torch.Tensor,
                dist_fn: Callable, *, h: int = 32, max_steps: int = 256,
                expand: int = 1, tombstones=None,
                lb_dist_fn: Optional[Callable] = None, m_prefix: int = 0,
                m_total: int = 0, prune_eps: float = 0.0,
                lb_scale_fn: Optional[Callable] = None,
                max_rounds=None, max_n_dist=None,
                lanes_per_query: int = 1) -> SearchResult:
    """Batched beam search.

    Args:
      neighbors: (N, R) padded adjacency (sentinel N), int32.
      entry:     shared entry vertex (the PG medoid), (Q,) per query, or a
                 (Q, S) entry SET per query (``search/seed.py``; lanes
                 outside [0, N) are padding).
      qdatas:    (Q, ...) per-query data: LUTs (Q, M, K) or a QuantizedLUT
                 (fs4) for ADC routing, raw queries (Q, D) for exact
                 routing.
      dist_fn:   (qdatas, ids (Q, B)) -> (Q, B) f32; B is the frontier
                 width expand·R (1 for the entry, S for an entry set).
      h:         beam width (the paper's global candidate set size).
      max_steps: ROUND cap per query.
      expand:    frontier batch size E — nodes expanded per round.
      tombstones: optional (W,) bitset of deleted vertices (numpy uint32 or
                 an integer tensor; W ≥ (N+31)//32), shared by the batch.
      lb_dist_fn / m_prefix / m_total / prune_eps: hop pruning — all four
                 set and ``prune_eps > 0`` switch it on; ``lb_dist_fn`` is
                 ``make_adc_dist_fn(m_prefix=)``.
      lb_scale_fn: optional per-query extrapolation factor
                 (``make_lb_scale_fn``), qdatas -> (Q,); default M/m′.
      max_rounds / max_n_dist: per-call budgets (rounds; full-LUT-equivalent
                 distance evaluations). ``None`` adds no check.
      lanes_per_query: L beam lanes per row of ``qdatas``, query-major (lane
                 ``q·L + l``): the sharded engines' S shards of each query
                 (``entry`` then holds Q·L rows). Each distance call still
                 scores the whole batch at once: the (Q·L, W) frontier goes
                 to ``dist_fn`` as (Q, L·W) against the unchanged (Q, ...)
                 qdatas. 1 is the classic beam.
    """
    return _beam(neighbors, entry, qdatas, dist_fn, h=h, max_steps=max_steps,
                 expand=expand, trace_len=0, tombstones=tombstones,
                 lb_dist_fn=lb_dist_fn, m_prefix=m_prefix, m_total=m_total,
                 prune_eps=prune_eps, lb_scale_fn=lb_scale_fn,
                 max_rounds=max_rounds, max_n_dist=max_n_dist,
                 lanes_per_query=lanes_per_query)[0]


def beam_search_trace(neighbors: torch.Tensor, entry, qdatas: torch.Tensor,
                      dist_fn: Callable, *, h: int = 32, max_steps: int = 256,
                      trace_len: int = 64, expand: int = 1, tombstones=None,
                      lb_dist_fn: Optional[Callable] = None, m_prefix: int = 0,
                      m_total: int = 0, prune_eps: float = 0.0,
                      lb_scale_fn: Optional[Callable] = None,
                      max_rounds=None, max_n_dist=None) -> Trace:
    """:func:`beam_search` that also records the ranked beam after every
    round. ``hop_valid[q, t]`` flags ROUNDS: a live lane records its beam at
    slot ``t = rounds so far`` while ``t < trace_len``, so the flagged prefix
    counts ``min(rounds, trace_len)``; later rounds leave the last slot
    alone, and frozen lanes record nothing. Unrecorded slots hold the
    sentinel id N at +inf."""
    if trace_len < 1:
        raise ValueError("beam_search_trace: trace_len must be at least 1")
    res, trace = _beam(neighbors, entry, qdatas, dist_fn, h=h,
                       max_steps=max_steps, expand=expand, trace_len=trace_len,
                       tombstones=tombstones, lb_dist_fn=lb_dist_fn,
                       m_prefix=m_prefix, m_total=m_total, prune_eps=prune_eps,
                       lb_scale_fn=lb_scale_fn, max_rounds=max_rounds,
                       max_n_dist=max_n_dist)
    tbi, tbd, tbv = trace
    return Trace(tbi.to(torch.int32), tbd, tbv, res)


def _per_lane(fn: Callable, nq_data: int) -> Callable:
    """``fn`` over (Q·L, W) lane ids, query-major, as ONE call of (Q, L·W)
    ids against the Q rows of qdatas."""
    def lane_fn(qdatas, ids):
        return fn(qdatas, ids.reshape(nq_data, -1)).reshape(ids.shape[0], -1)
    return lane_fn


def _any_live(live: torch.Tensor) -> bool:
    """Whether any lane is still live: the host waits for the card here,
    once before the first round and once after each."""
    if spans.on:
        spans.count("sync")
    return bool(live.any())


def _scalar(x: float, dev) -> torch.Tensor:
    """``x`` as a float32 scalar on ``dev``: a copy from the host that makes
    the host wait for the card (counted as a ``sync`` on any device)."""
    if spans.on:
        spans.count("sync")
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _beam(neighbors, entry, qdatas, dist_fn, *, h, max_steps, expand,
          trace_len, tombstones=None, lb_dist_fn=None, m_prefix=0, m_total=0,
          prune_eps=0.0, lb_scale_fn=None, max_rounds=None, max_n_dist=None,
          lanes_per_query=1):
    sp = spans.begin("beam.init") if spans.on else -1
    n, r = neighbors.shape
    dev = neighbors.device
    nq = (qdatas.lut if isinstance(qdatas, QuantizedLUT) else qdatas).shape[0]
    if lanes_per_query > 1:
        dist_fn = _per_lane(dist_fn, nq)
        if lb_dist_fn is not None:
            lb_dist_fn = _per_lane(lb_dist_fn, nq)
        nq = nq * lanes_per_query
    e = max(1, min(expand, h))
    nwords = (n + 31) // 32 + 1
    entries = _normalize_entries(entry, nq, dev)
    s = entries.shape[1]
    ts = None if tombstones is None else as_bitset(tombstones, dev)
    # hop pruning runs only when fully configured; prune_eps=0 is the OFF
    # switch (bit-identical to the unpruned beam)
    prune = (lb_dist_fn is not None and prune_eps > 0.0
             and 0 < m_prefix < m_total)
    if prune:
        # d̂ = d_lb · cal, folded with (1+ε) into one per-query gate scale
        cal = (lb_scale_fn(qdatas) if lb_scale_fn is not None
               else _scalar(float(m_total), dev) / _scalar(float(m_prefix), dev))
        gate = (cal * _scalar(1.0 + prune_eps, dev)).reshape(-1, 1)
        if lanes_per_query > 1 and gate.shape[0] > 1:   # one row per lane
            gate = gate.repeat_interleave(lanes_per_query, dim=0)

    ids = torch.full((nq, h), n, dtype=torch.int64, device=dev)
    dists = torch.full((nq, h), INF, dtype=torch.float32, device=dev)
    exp = torch.ones((nq, h), dtype=torch.bool, device=dev)
    # one bitset over all N ids per lane: with the sharded engines' S lanes
    # per query over S·n_local rows it is S·Q × S·n_local/32 words, 500 MB at
    # Q=1000, S=4 and 1M rows (a shard's beam never sets a bit outside its
    # block; the reference keeps n_local bits per shard)
    visited = torch.zeros((nq, nwords), dtype=torch.int32, device=dev)
    if s == 1:
        # the classic single-entry init, op for op (bit-identity contract)
        first = entries[:, 0]
        ids[:, 0] = first
        d_entry = dist_fn(qdatas, entries)[:, 0]
        if ts is not None:
            d_entry = torch.where(_is_dead(ts, first, n), DEAD_ENTRY_DIST, d_entry)
        dists[:, 0] = d_entry
        exp[:, 0] = False
        _scatter_bits_(visited, entries,
                       torch.ones((nq, 1), dtype=torch.bool, device=dev))
        n_seeds = torch.ones(nq, dtype=torch.int32, device=dev)
    else:
        # multi-entry init: dedupe the set, score the distinct valid entries
        # in ONE dist_fn call, rank (ties → lower lane), install the top h
        sh = min(s, h)
        ok = (entries >= 0) & (entries < n)
        uniq = _first_occurrence(entries, ok)
        d_ent = torch.where(uniq, dist_fn(qdatas, torch.where(uniq, entries, 0)),
                            INF)
        if ts is not None:
            d_ent = torch.where(uniq & _is_dead(ts, entries, n), DEAD_ENTRY_DIST,
                                d_ent)
        sd, order = torch.sort(d_ent, dim=1, stable=True)
        sids = torch.where(sd < INF, entries.gather(1, order), n)
        ids[:, :sh] = sids[:, :sh]
        dists[:, :sh] = sd[:, :sh]
        exp[:, :sh] = sd[:, :sh] == INF
        _scatter_bits_(visited, entries, uniq)
        n_seeds = uniq.sum(dim=1, dtype=torch.int32)
    hops = torch.zeros(nq, dtype=torch.int32, device=dev)
    ndist = n_seeds * m_total if prune else n_seeds
    step = torch.zeros(nq, dtype=torch.int32, device=dev)
    pad = torch.zeros((nq, e * r), dtype=torch.bool, device=dev)
    # the n_dist cap, in subspace units while pruning (as ndist is)
    nd_cap = (None if max_n_dist is None
              else int(max_n_dist) * (m_total if prune else 1))

    if trace_len:
        lanes = torch.arange(nq, device=dev)
        tbi = torch.full((nq, trace_len, h), n, dtype=torch.int64, device=dev)
        tbd = torch.full((nq, trace_len, h), INF, dtype=torch.float32, device=dev)
        tbv = torch.zeros((nq, trace_len), dtype=torch.bool, device=dev)

    def live_lanes():
        live = (step < max_steps) & (~exp & (dists < INF)).any(dim=1)
        # budgets: checked before each round, so rounds never exceed
        # max_rounds and n_dist overshoots its cap by at most one frontier
        if max_rounds is not None:
            live = live & (step < int(max_rounds))
        if nd_cap is not None:
            live = live & (ndist < nd_cap)
        return live

    live = live_lanes()
    going = _any_live(live)
    if sp >= 0:
        spans.end(sp)
    while going:
        sp = spans.begin("beam.round") if spans.on else -1
        # 1. pick the best `e` unexpanded beam entries (ties → lower slot)
        cand = torch.where(~exp & (dists < INF), dists, INF)
        sel_d, sel = torch.sort(cand, dim=1, stable=True)
        sel_d, sel = sel_d[:, :e], sel[:, :e]
        sel_ok = (sel_d < INF) & live[:, None]
        exp = exp.scatter(1, sel, exp.gather(1, sel) | sel_ok)
        hops = hops + sel_ok.sum(dim=1, dtype=torch.int32)
        # 2. expand the frontier: e·R neighbor ids minus pads and visited
        src = torch.where(sel_ok, ids.gather(1, sel), 0)
        nbr = neighbors[src].long()                         # (Q, e, R)
        flat = nbr.reshape(nq, e * r)
        valid = (sel_ok[:, :, None] & (nbr < n)).reshape(nq, e * r)
        fresh = valid & ~_bit_get(visited, torch.where(valid, flat, 0))
        if e > 1:
            # two frontier rows may share a neighbor; keep the first lane
            fresh = _first_occurrence(flat, fresh)
            _scatter_bits_(visited, flat, fresh)
        else:
            # classic semantics: in-row duplicates stay fresh (scored
            # twice); only the bitset update deduplicates
            _scatter_bits_(visited, flat, _first_occurrence(flat, fresh))
        # 3. ONE dist_fn call for the whole batch's frontier (two when
        #    pruning: the prefix lower bound, then the lanes it keeps)
        if prune:
            tau = dists[:, h - 1:h]
            d_lb = lb_dist_fn(qdatas, torch.where(fresh, flat, 0))
            front = fresh & (d_lb * gate <= tau)
            nd = torch.where(front, dist_fn(qdatas, torch.where(front, flat, 0)),
                             INF)
            ndist = ndist + (m_prefix * fresh.sum(dim=1, dtype=torch.int32)
                             + m_total * front.sum(dim=1, dtype=torch.int32))
        else:
            front = fresh
            nd = torch.where(fresh, dist_fn(qdatas, torch.where(fresh, flat, 0)),
                             INF)
            ndist = ndist + fresh.sum(dim=1, dtype=torch.int32)
        if ts is not None:
            # dead neighbors were scored (and counted) but rank +inf
            nd = torch.where(_is_dead(ts, flat, n), INF, nd)
        # 4. merge beam ∪ frontier, keep the h best (stable: ties → lower)
        all_ids = torch.cat([ids, torch.where(front, flat, n)], dim=1)
        all_d = torch.cat([dists, nd], dim=1)
        all_e = torch.cat([exp, pad], dim=1)
        new_d, order = torch.sort(all_d, dim=1, stable=True)
        new_d, order = new_d[:, :h], order[:, :h]
        keep = live[:, None]
        ids = torch.where(keep, all_ids.gather(1, order), ids)
        exp = torch.where(keep, all_e.gather(1, order) | (new_d == INF), exp)
        dists = torch.where(keep, new_d, dists)
        if trace_len:
            # 5. record each live lane's ranked beam at slot step (paper
            #    Def. 6); rounds beyond trace_len keep the last slot
            slot = step.long().clamp(max=trace_len - 1)
            rec = live & (step < trace_len)
            tbi[lanes, slot] = torch.where(rec[:, None], ids, tbi[lanes, slot])
            tbd[lanes, slot] = torch.where(rec[:, None], dists, tbd[lanes, slot])
            tbv[lanes, slot] = tbv[lanes, slot] | rec
        step = step + live.to(torch.int32)
        live = live_lanes()
        going = _any_live(live)
        if sp >= 0:
            spans.end(sp)

    if prune:
        # subspace units → full-LUT equivalents (a lone partial score still
        # counts as work done)
        ndist = (ndist + (m_total - 1)) // m_total
    # pending unexpanded finite candidates mean a budget or max_steps cut
    # the lane short; decided before the tombstone scrub
    truncated = (~exp & (dists < INF)).any(dim=1)
    if ts is not None:
        dead = _is_dead(ts, ids, n)
        ids = torch.where(dead, n, ids)
        dists = torch.where(dead, INF, dists)
    res = SearchResult(ids.to(torch.int32), dists, hops, ndist, step, truncated)
    return res, ((tbi, tbd, tbv) if trace_len else None)


# --------------------------------------------------------------------------
# Distance functions
# --------------------------------------------------------------------------

def make_exact_dist_fn(vectors: torch.Tensor) -> Callable:
    """qdatas = query vectors (Q, D); vectors must be (N+1, D)
    sentinel-padded."""
    def dist_fn(q, ids):
        v = vectors[ids]                                     # (Q, B, D)
        return ((v - q[:, None, :]) ** 2).sum(dim=-1)
    return dist_fn


def make_lb_scale_fn(*, packed: bool = False, m_prefix: int) -> Callable:
    """Per-query calibration of the hop-pruning extrapolation factor.

    qdatas match ``make_adc_dist_fn``: LUTs (Q, M, K), or a per-query
    :class:`~repro_torch.pq.pack.QuantizedLUT` when ``packed=True``.
    Returns (Q,) ``cal ≥ 1``: the ratio of the full LUT's mean mass to the
    first ``m_prefix`` rows' mean mass (the estimate of E[d_M] / E[d_m′]
    under code-independent draws), which replaces the uniform M/m′ that
    over-prunes on anisotropic data. Clamped below at 1, so d̂ never drops
    under the certified bound."""
    if packed:
        def scale_fn(qlut):
            m = qlut.lut.shape[1]
            # zero padding in unused LUT columns deflates every row's mean
            # by the same K/16 factor — it cancels in the ratio
            rm = qlut.lut.float().mean(dim=-1)                  # (Q, M)
            num = qlut.scale * rm.sum(dim=1) + m * qlut.bias
            den = qlut.scale * rm[:, :m_prefix].sum(dim=1) + m_prefix * qlut.bias
            return torch.clamp(num / torch.clamp(den, min=1e-20), min=1.0)
        return scale_fn

    def scale_fn(luts):
        rm = luts.mean(dim=-1)                                   # (Q, M)
        return torch.clamp(rm.sum(dim=1) / torch.clamp(rm[:, :m_prefix].sum(dim=1),
                                                       min=1e-20), min=1.0)
    return scale_fn


def make_adc_dist_fn(codes: torch.Tensor, *, packed: bool = False,
                     tombstones=None, m_prefix: int = 0) -> Callable:
    """qdatas = LUTs (Q, M, K); codes must be (N+1, M) sentinel-padded
    uint8. Each call is one fused ``hop_adc`` over the batch's frontier —
    the kernel on the card, its plain version on the CPU.

    ``packed=True`` is the fs4 layout: qdatas is a per-query
    :class:`~repro_torch.pq.pack.QuantizedLUT` and codes are (N+1,
    ceil(M/2)) packed bytes; each call is one ``hop_adc_fs``.

    ``m_prefix > 0`` makes a PARTIAL-LUT distance over only the first
    ``m_prefix`` subspaces: a lower bound on the full one (every LUT entry
    is ≥ 0; fs4 dequantizes with ``m_prefix · bias``, bias ≥ 0), the
    ``lb_dist_fn`` of hop pruning. ``m_prefix=0`` is the full distance.

    ``tombstones`` (a (W,) bitset over ids [0, N), as ``beam_search``
    takes it) bakes a deleted-vertex mask into the function: tombstoned ids
    return +inf. A streaming caller passes ``beam_search(tombstones=)``
    instead, which rescues a dead entry and scrubs the returned beam; a
    search ENTERED at a vertex dead in the baked mask ends empty.
    """
    if tombstones is not None:
        ts = as_bitset(tombstones, codes.device)
        inner = make_adc_dist_fn(codes, packed=packed, m_prefix=m_prefix)
        n = codes.shape[0] - 1              # codes are sentinel-padded

        def dead_fn(qdata, ids):
            d = inner(qdata, ids)
            return torch.where(_is_dead(ts, ids.long(), n), INF, d)
        return dead_fn

    if packed:
        def dist_fn(qlut, ids):
            return kops.hop_adc_fs(codes, ids, qlut.lut, qlut.scale, qlut.bias,
                                   m_prefix=m_prefix)
        return dist_fn

    def dist_fn(luts, ids):
        return kops.hop_adc(codes, ids, luts, m_prefix=m_prefix)
    return dist_fn
