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

``beam_search_trace`` also records the ranked beam after every round, the
paper's Definition 6 routing features (RPQ training's ``sample_routing``).

Tombstones, multi-entry seeding, hop pruning and deadline budgets belong to
later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.pq.pack import QuantizedLUT

INF = float("inf")


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
    """``entry`` as a (Q,) int64 tensor: a shared vertex (int or 0-d) or one
    vertex per query ((Q,) or (Q, 1)). Entry SETS (Q, S > 1) are not in this
    slice."""
    entry = torch.as_tensor(entry, device=device).long()
    if entry.dim() == 2 and entry.shape[1] == 1:
        entry = entry[:, 0]
    if entry.dim() == 0:
        return entry.expand(nq).contiguous()
    if entry.dim() != 1 or entry.shape[0] != nq:
        raise ValueError(f"entry must be shared, (Q,) or (Q, 1); got "
                         f"{tuple(entry.shape)} for Q={nq}")
    return entry


def beam_search(neighbors: torch.Tensor, entry, qdatas: torch.Tensor,
                dist_fn: Callable, *, h: int = 32, max_steps: int = 256,
                expand: int = 1) -> SearchResult:
    """Batched beam search.

    Args:
      neighbors: (N, R) padded adjacency (sentinel N), int32.
      entry:     shared entry vertex (the PG medoid) or (Q,) per query.
      qdatas:    (Q, ...) per-query data: LUTs (Q, M, K) or a QuantizedLUT
                 (fs4) for ADC routing, raw queries (Q, D) for exact
                 routing.
      dist_fn:   (qdatas, ids (Q, B)) -> (Q, B) f32; B is the frontier
                 width expand·R (1 for the entry).
      h:         beam width (the paper's global candidate set size).
      max_steps: ROUND cap per query.
      expand:    frontier batch size E — nodes expanded per round.
    """
    return _beam(neighbors, entry, qdatas, dist_fn, h=h, max_steps=max_steps,
                 expand=expand, trace_len=0)[0]


def beam_search_trace(neighbors: torch.Tensor, entry, qdatas: torch.Tensor,
                      dist_fn: Callable, *, h: int = 32, max_steps: int = 256,
                      trace_len: int = 64, expand: int = 1) -> Trace:
    """:func:`beam_search` that also records the ranked beam after every
    round. ``hop_valid[q, t]`` flags ROUNDS: a live lane records its beam at
    slot ``t = rounds so far`` while ``t < trace_len``, so the flagged prefix
    counts ``min(rounds, trace_len)``; later rounds leave the last slot
    alone, and frozen lanes record nothing. Unrecorded slots hold the
    sentinel id N at +inf."""
    if trace_len < 1:
        raise ValueError("beam_search_trace: trace_len must be at least 1")
    res, trace = _beam(neighbors, entry, qdatas, dist_fn, h=h,
                       max_steps=max_steps, expand=expand, trace_len=trace_len)
    tbi, tbd, tbv = trace
    return Trace(tbi.to(torch.int32), tbd, tbv, res)


def _beam(neighbors, entry, qdatas, dist_fn, *, h, max_steps, expand,
          trace_len):
    n, r = neighbors.shape
    dev = neighbors.device
    nq = (qdatas.lut if isinstance(qdatas, QuantizedLUT) else qdatas).shape[0]
    e = max(1, min(expand, h))
    nwords = (n + 31) // 32 + 1
    entries = _normalize_entries(entry, nq, dev)

    ids = torch.full((nq, h), n, dtype=torch.int64, device=dev)
    ids[:, 0] = entries
    dists = torch.full((nq, h), INF, dtype=torch.float32, device=dev)
    dists[:, 0] = dist_fn(qdatas, entries[:, None])[:, 0]
    exp = torch.ones((nq, h), dtype=torch.bool, device=dev)
    exp[:, 0] = False
    visited = torch.zeros((nq, nwords), dtype=torch.int32, device=dev)
    _scatter_bits_(visited, entries[:, None],
                   torch.ones((nq, 1), dtype=torch.bool, device=dev))
    hops = torch.zeros(nq, dtype=torch.int32, device=dev)
    ndist = torch.ones(nq, dtype=torch.int32, device=dev)
    step = torch.zeros(nq, dtype=torch.int32, device=dev)
    pad = torch.zeros((nq, e * r), dtype=torch.bool, device=dev)

    if trace_len:
        lanes = torch.arange(nq, device=dev)
        tbi = torch.full((nq, trace_len, h), n, dtype=torch.int64, device=dev)
        tbd = torch.full((nq, trace_len, h), INF, dtype=torch.float32, device=dev)
        tbv = torch.zeros((nq, trace_len), dtype=torch.bool, device=dev)

    def live_lanes():
        return (step < max_steps) & (~exp & (dists < INF)).any(dim=1)

    live = live_lanes()
    while bool(live.any()):
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
        # 3. ONE dist_fn call for the whole batch's frontier
        nd = dist_fn(qdatas, torch.where(fresh, flat, 0))
        nd = torch.where(fresh, nd, INF)
        ndist = ndist + fresh.sum(dim=1, dtype=torch.int32)
        # 4. merge beam ∪ frontier, keep the h best (stable: ties → lower)
        all_ids = torch.cat([ids, torch.where(fresh, flat, n)], dim=1)
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

    truncated = (~exp & (dists < INF)).any(dim=1)
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


def make_adc_dist_fn(codes: torch.Tensor, *, packed: bool = False,
                     m_prefix: int = 0) -> Callable:
    """qdatas = LUTs (Q, M, K); codes must be (N+1, M) sentinel-padded
    uint8. Each call is one fused ``hop_adc`` over the batch's frontier —
    the kernel on the card, its plain version on the CPU.

    ``packed=True`` is the fs4 layout: qdatas is a per-query
    :class:`~repro_torch.pq.pack.QuantizedLUT` and codes are (N+1,
    ceil(M/2)) packed bytes; each call is one ``hop_adc_fs``.

    ``m_prefix > 0`` makes a PARTIAL-LUT distance over only the first
    ``m_prefix`` subspaces (a lower bound on the full one; the hop-pruning
    ``lb_dist_fn`` of a later slice). ``m_prefix=0`` is the full distance.
    """
    if packed:
        def dist_fn(qlut, ids):
            return kops.hop_adc_fs(codes, ids, qlut.lut, qlut.scale, qlut.bias,
                                   m_prefix=m_prefix)
        return dist_fn

    def dist_fn(luts, ids):
        return kops.hop_adc(codes, ids, luts, m_prefix=m_prefix)
    return dist_fn
