"""DiskEngine: graph-routed ANN serving with graph + codes ALL in storage.

Port of ``repro/storage/engine.py``: the sixth serving engine (DESIGN.md
§14), speaking the same ``search()`` protocol as the resident ones. DRAM
holds only the per-query LUTs, the entry points, and the bounded hot-vertex
cache; every beam round fetches its candidate records (adjacency + codes in
one slab, ``storage/format.py``) from the segment file through the async
reader — the AiSAQ layout, where the index's DRAM footprint is O(cache),
not O(N).

Per-round host I/O cannot live inside a device loop, so the beam is the
reference's host loop, decision for decision: the same frontier selection,
stable merge, budgets, entry sets, hop pruning, tombstones and ``n_dist``
accounting (float64 fractions, rounded once). What runs on the engine's
device (``cuda`` unless the caller asks for the CPU) is the LUT build and
the scoring: each round's candidate code rows go to the device as one
staging table with a zero sentinel row, and one kernel scores them for all
queries at once — ``ops.hop_adc`` (u8, f32 LUT sums) or
``ops.hop_adc_fs_acc`` (fs4, exact int32 sums) followed by the affine
dequant with the FULL ``M · bias`` even for a prefix, as the reference's
``_score`` does. The (Q, cmax) distances come back to the host once a
round for the merge. On the CPU the same calls run the plain versions.

Two things differ from the reference in form, not in outcome: the records
a search has read live in arrays indexed by vertex id (the reference keeps
a dict), and the visited set is a bitset over (query, vertex) (the
reference keeps a (Q, N) bool array, 1 GB at 1000 × 1M). The loop has two
modes:

* **serial** (``overlap=False``) — each round fetches, then scores:
  wall ≈ rounds × (io + compute). The honest baseline.
* **pipelined** (``overlap=True``, default) — double-buffered: each
  iteration first issues the NEXT round's reads — the frontier selected
  from the beam as it stands BEFORE this round's scores merge (one round
  stale) — then waits on this round's in-flight records and scores them.
  Whether a round goes stale depends on whether its reads have already
  landed (``pf.future.done()``), so the outcome of this mode depends on
  thread timing; serial mode is deterministic.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.segment import Tombstones
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.pq import base as pqbase
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.search.beam import SearchResult
from repro_torch.storage import format as segfmt
from repro_torch.storage.cache import HotVertexCache
from repro_torch.storage.prefetch import FrontierPrefetcher
from repro_torch.storage.reader import AsyncSegmentReader

_INF = np.float32(np.inf)


def _pair_lanes(cand_q: np.ndarray, nq: int) -> tuple[np.ndarray, int]:
    """Column of each (query, candidate) pair in a (Q, cmax) layout that
    keeps each query's pairs in their given order, and cmax."""
    counts = np.bincount(cand_q, minlength=nq)
    order = np.argsort(cand_q, kind="stable")
    col = np.empty(cand_q.size, np.int64)
    col[order] = (np.arange(cand_q.size)
                  - np.repeat(np.cumsum(counts) - counts, counts))
    return col, int(counts.max()) if counts.size else 0


def _merge_beam(beam_ids, beam_d, beam_exp, cand_q, cand_ids, cand_d):
    """Fold scored candidates into the (sorted) beam, keeping width h."""
    q, h = beam_ids.shape
    col, cmax = _pair_lanes(cand_q, q)
    if cmax == 0:
        return beam_ids, beam_d, beam_exp
    pad_ids = np.full((q, cmax), -1, np.int64)
    pad_d = np.full((q, cmax), _INF, np.float32)
    pad_ids[cand_q, col] = cand_ids
    pad_d[cand_q, col] = cand_d
    all_ids = np.concatenate([beam_ids, pad_ids], axis=1)
    all_d = np.concatenate([beam_d, pad_d], axis=1)
    all_exp = np.concatenate([beam_exp, np.zeros((q, cmax), bool)], axis=1)
    keep = np.argsort(all_d, axis=1, kind="stable")[:, :h]
    return (np.take_along_axis(all_ids, keep, 1),
            np.take_along_axis(all_d, keep, 1),
            np.take_along_axis(all_exp, keep, 1))


def _score(luts, stage: torch.Tensor, cand_q: np.ndarray, rows: np.ndarray,
           nq: int, m_prefix: int = 0) -> np.ndarray:
    """ADC distances of flattened (query, candidate) pairs.

    Args:
      luts:   (Q, M, K) f32 tables, or a :class:`QuantizedLUT` (fs4).
      stage:  (U + 1, code_width) uint8 code rows on the LUTs' device, the
              last one the zero sentinel.
      cand_q: (T,) query of each pair; ``rows``: (T,) its row of ``stage``.
      m_prefix: score only the first P subspaces (hop-pruning lower
        bound); 0 = all M.

    One kernel scores every pair at (Q, cmax) ids, padded lanes pointing at
    the sentinel row. u8 sums f32 LUT entries in subspace order; fs4 sums
    uint8 entries exactly in int32 and undoes the quantization with one
    affine ``scale · acc + M · bias`` — the FULL M even for a prefix (bias
    is per query, not per subspace: the reference disk tier's convention).
    """
    col, cmax = _pair_lanes(cand_q, nq)
    local = np.full((nq, cmax), stage.shape[0] - 1, np.int32)
    local[cand_q, col] = rows
    ids = torch.from_numpy(local).to(stage.device)
    if isinstance(luts, QuantizedLUT):
        acc = ops.hop_adc_fs_acc(stage, ids, luts.lut, m_prefix=m_prefix)
        out = kref.dequant(acc, luts.scale, luts.bias, luts.lut.shape[1])
    else:
        out = ops.hop_adc(stage, ids, luts, m_prefix=m_prefix)
    return out.cpu().numpy()[cand_q, col]


class _Records:
    """The records one search has read: vertex id → row of growing
    adjacency and code arrays (the reference's ``known`` dict)."""

    def __init__(self, n: int, r: int, code_width: int):
        self.slot = np.full((n,), -1, np.int64)
        self.adj = np.empty((1024, r), np.int32)
        self.codes = np.empty((1024, code_width), np.uint8)
        self.size = 0

    def has(self, ids: np.ndarray) -> np.ndarray:
        return self.slot[ids] >= 0

    def absorb(self, ids, adj, codes) -> None:
        """Keep freshly read records (``ids`` distinct); a record already
        held is the same bytes and stays where it is."""
        ids = np.asarray(ids, np.int64)
        new = ~self.has(ids)
        ids, adj, codes = ids[new], adj[new], codes[new]
        end = self.size + ids.size
        if end > self.adj.shape[0]:
            cap = max(end, 2 * self.adj.shape[0])
            self.adj = np.concatenate(
                [self.adj[:self.size],
                 np.empty((cap - self.size, self.adj.shape[1]), np.int32)])
            self.codes = np.concatenate(
                [self.codes[:self.size],
                 np.empty((cap - self.size, self.codes.shape[1]), np.uint8)])
        self.adj[self.size:end] = adj
        self.codes[self.size:end] = codes
        self.slot[ids] = np.arange(self.size, end)
        self.size = end


class _VisitedBits:
    """Visited set over (query, vertex) pairs as one bitset: key q·n + v."""

    def __init__(self, nq: int, n: int):
        self.bits = np.zeros(((nq * n + 7) // 8,), np.uint8)

    def seen(self, key: np.ndarray) -> np.ndarray:
        return ((self.bits[key >> 3] >> (key & 7).astype(np.uint8)) & 1
                ).astype(bool)

    def mark(self, key: np.ndarray) -> None:
        """Set the bits of SORTED keys (one OR per touched byte)."""
        if key.size == 0:
            return
        byte = key >> 3
        bit = (np.uint8(1) << (key & 7).astype(np.uint8)).astype(np.uint8)
        starts = np.flatnonzero(np.r_[True, byte[1:] != byte[:-1]])
        self.bits[byte[starts]] |= np.bitwise_or.reduceat(bit, starts)


class DiskEngine:
    """All-in-storage serving over one generation's segment file.

    Build via :meth:`open` (newest intact generation + quantizer sidecar)
    or directly from a path/header when the caller manages those.

    Attributes:
      header:     the verified :class:`~repro_torch.storage.format.SegmentHeader`.
      lut_fn:     (Q, D) queries → LUTs in the segment's layout.
      device:     where LUTs live and rounds are scored (default ``cuda``).
      prefetcher: cache-fronted async record fetch.
      tombstones: optional deleted-id bitset (:meth:`delete` creates one).
      overlap:    default pipelining mode for :meth:`search`.
      last_io:    per-search I/O accounting (wall/io_wait/bytes/cache/...).
    """

    def __init__(self, path: str, header: segfmt.SegmentHeader,
                 lut_fn: Callable, *,
                 cache_records: int = 2048, io_threads: int = 4,
                 retry=None, fault_hook=None, slow_read_ms: float = 0.0,
                 seed_cache: bool = True, overlap: bool = True,
                 tombstones: Optional[Tombstones] = None, device=None):
        self.path = path
        self.header = header
        self.lut_fn = lut_fn
        self.device = resolve_device(device)
        self.overlap = bool(overlap)
        self.tombstones = tombstones
        self.reader = AsyncSegmentReader(
            path, header, io_threads=io_threads, retry=retry,
            fault_hook=fault_hook, slow_read_ms=slow_read_ms)
        self.cache = HotVertexCache(cache_records)
        self.prefetcher = FrontierPrefetcher(self.reader, self.cache)
        self._seed_order = np.asarray([header.medoid], np.int64)
        if seed_cache and cache_records > 0:
            self._seed_order = self.cache.seed_bfs(
                self.reader, header.medoid)
        self.last_io: dict = {}

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def open(cls, directory: str, generation: Optional[int] = None, *,
             lut_fn: Optional[Callable] = None,
             cache_mb: Optional[float] = None, cache_records: int = 2048,
             io_threads: int = 4, retry=None, fault_hook=None,
             slow_read_ms: float = 0.0, seed_cache: bool = True,
             overlap: bool = True, on_fallback=None,
             device=None) -> "DiskEngine":
        """Open the newest INTACT (or a given) generation under
        ``directory`` — a corrupt header falls back generation-by-
        generation exactly like ``index.segment.load_segment``
        (``on_fallback(generation, error)`` observes each skip).

        ``lut_fn=None`` rebuilds it from the ``gen_*.model.npz`` sidecar
        that ``write_segment(..., model=)`` wrote (quantized LUTs for fs4
        segments), built on ``device`` through ``pq_pairwise`` — a fully
        self-contained, vector-free restore. ``cache_mb`` sizes the
        hot-vertex cache by DRAM budget and overrides ``cache_records``.
        """
        dev = resolve_device(device)
        path, header = segfmt.open_segment(directory, generation,
                                           on_fallback=on_fallback)
        if lut_fn is None:
            mpath = segfmt.model_path(directory, header.generation)
            if not os.path.exists(mpath):
                raise ValueError(
                    f"no quantizer sidecar at {mpath} — pass lut_fn= or "
                    f"write the segment with write_segment(..., model=)")
            with np.load(mpath) as z:
                model = pqbase.QuantizerModel(
                    r=torch.from_numpy(np.asarray(z["r"], np.float32)).to(dev),
                    codebooks=torch.from_numpy(
                        np.asarray(z["codebooks"], np.float32)).to(dev))
            quantize = header.layout == "fs4"

            def lut_fn(q, _model=model, _quant=quantize):
                return pqbase.build_lut(_model, q, quantize=_quant)
        if cache_mb is not None:
            cache_records = int(cache_mb * 1e6) // max(1,
                                                       header.record_bytes)
        return cls(path, header, lut_fn, cache_records=cache_records,
                   io_threads=io_threads, retry=retry,
                   fault_hook=fault_hook, slow_read_ms=slow_read_ms,
                   seed_cache=seed_cache, overlap=overlap, device=dev)

    def close(self) -> None:
        self.reader.close()

    def __enter__(self) -> "DiskEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def generation(self) -> int:
        return self.header.generation

    @property
    def n(self) -> int:
        return self.header.n

    def delete(self, ids) -> int:
        """Tombstone ids (lazy bitset over the segment's rows)."""
        if self.tombstones is None:
            self.tombstones = Tombstones(self.header.n, device=self.device)
        return self.tombstones.add(ids)

    def memory_bytes(self) -> int:
        # DRAM-resident serving state: the hot-vertex cache (+ tombstone
        # words); adjacency, codes, and vectors all live in storage
        resident = len(self.cache) * self.header.record_bytes
        if self.tombstones is not None:
            resident += self.tombstones._words.nbytes
        return resident

    # -- search ------------------------------------------------------------

    def _entries(self, entries: int) -> np.ndarray:
        """Entry vertices: the medoid, then the next S−1 BFS cache seeds
        (the graph's top layer — already resident, zero extra I/O).
        Tombstoned seeds are skipped over, not merely dropped: a deleted
        medoid must not sever routing while any other seed survives, so
        the first S ALIVE vertices of the BFS order serve as entries."""
        order = self._seed_order
        if order.size == 0:
            order = np.asarray([self.header.medoid], np.int64)
        if self.tombstones is not None:
            alive = ~self.tombstones.contains(order)
            if alive.any():
                order = order[alive]
        return np.unique(order[:max(1, int(entries))])

    def search(self, queries, *, k: int = 10, h: int = 32,
               max_steps: int = 512, expand: int = 1, entries: int = 1,
               prune_eps: float = 0.0, m_prefix: int = 0,
               max_rounds=None, max_n_dist=None,
               overlap: Optional[bool] = None) -> SearchResult:
        """Batched storage-backed beam search (engine protocol).

        ``max_rounds``/``max_n_dist`` are per-call budgets: an exhausted
        query freezes its frontier and reports ``truncated=True`` with
        its best-so-far answer — the jitted beam's honesty contract.
        ``overlap`` overrides the engine's default pipelining mode (the
        serial baseline the overlap benchmark compares against). Unfilled
        result slots hold id ``-1`` and distance ``inf``. The result's
        tensors lie on the engine's device.
        """
        t_start = time.perf_counter()
        stats0 = self.prefetcher.stats()
        dev = self.device
        queries = torch.atleast_2d(
            torch.as_tensor(queries, dtype=torch.float32).to(dev))
        luts = self.lut_fn(queries).to(dev)
        tables = luts.lut if isinstance(luts, QuantizedLUT) else luts
        nq, n, r = int(queries.shape[0]), self.header.n, self.header.r
        mt = int(tables.shape[1])
        mp = 0
        if prune_eps > 0.0 and mt >= 2:
            mp = m_prefix if m_prefix > 0 else max(1, mt // 4)
            mp = max(1, min(mp, mt - 1))
        use_overlap = self.overlap if overlap is None else bool(overlap)
        budget_rounds = max_steps if max_rounds is None else min(
            int(max_rounds), int(max_steps))

        beam_ids = np.full((nq, h), -1, np.int64)
        beam_d = np.full((nq, h), _INF, np.float32)
        beam_exp = np.zeros((nq, h), bool)
        visited = _VisitedBits(nq, n)
        known = _Records(n, r, self.header.code_width)
        hops = np.zeros((nq,), np.int64)
        n_dist = np.zeros((nq,), np.float64)
        rounds = np.zeros((nq,), np.int64)
        truncated = np.zeros((nq,), bool)
        exhausted = np.zeros((nq,), bool)   # budget-frozen queries

        def score_and_merge(cand_q, cand_ids):
            """Score scheduled (query, vid) pairs (prefix-gated when
            pruning) and fold the survivors into the beam."""
            nonlocal beam_ids, beam_d, beam_exp
            if cand_q.size == 0:
                return
            if self.tombstones is not None:
                dead = self.tombstones.contains(cand_ids)
                if dead.any():      # dead rows are never scored or kept
                    cand_q, cand_ids = cand_q[~dead], cand_ids[~dead]
                    if cand_q.size == 0:
                        return
            # the round's code rows, each once, as one staging table
            uniq = np.unique(cand_ids)
            rows = np.searchsorted(uniq, cand_ids)
            stage = ops.pad_sentinel_row(
                torch.from_numpy(known.codes[known.slot[uniq]]).to(dev))
            if mp:
                part = _score(luts, stage, cand_q, rows, nq, m_prefix=mp)
                est = part * (mt / mp)
                thresh = beam_d[cand_q, h - 1]
                keep = ~np.isfinite(thresh) | (
                    est <= (1.0 + prune_eps) * thresh)
                np.add.at(n_dist, cand_q, mp / mt)
                cand_q, cand_ids, rows = cand_q[keep], cand_ids[keep], rows[keep]
                if cand_q.size == 0:
                    return
                np.add.at(n_dist, cand_q, 1.0 - mp / mt)
            else:
                np.add.at(n_dist, cand_q, 1.0)
            d = _score(luts, stage, cand_q, rows, nq)
            beam_ids, beam_d, beam_exp = _merge_beam(
                beam_ids, beam_d, beam_exp, cand_q, cand_ids, d)

        def select_frontier():
            """Pick each query's best ≤``expand`` unexpanded beam entries
            (budget-frozen queries excluded), mark them expanded, and
            return ``((cand_q, cand_v), fetch_ids, active)`` — the
            scheduled pairs (by query, then vertex id), the ids whose
            records we still need, and which queries expanded anything
            this round."""
            mask = ~beam_exp & np.isfinite(beam_d) & ~exhausted[:, None]
            if max_n_dist is not None:
                over = n_dist >= max_n_dist
                cut = over & ~exhausted & mask.any(axis=1)
                truncated[cut] = True
                exhausted[:] |= over
                mask &= ~exhausted[:, None]
            empty = (np.zeros((0,), np.int64), np.zeros((0,), np.int64))
            if not mask.any():
                return empty, empty[0], np.zeros((nq,), bool)
            # beam rows are dist-sorted, so a stable sort of ~mask keeps
            # the first `expand` True positions in best-first order
            sel = np.argsort(~mask, axis=1, kind="stable")[:, :expand]
            rows_ = np.arange(nq)[:, None]
            valid = mask[rows_, sel]
            beam_exp[rows_, sel] |= valid
            active = valid.any(axis=1)
            hops[:] += valid.sum(axis=1)
            qq, jj = np.nonzero(valid)
            nbr = known.adj[known.slot[beam_ids[qq, sel[qq, jj]]]].astype(
                np.int64)
            qn = np.repeat(qq.astype(np.int64), r)
            nbr = nbr.ravel()
            ok = (nbr >= 0) & (nbr < n)
            key = np.unique(qn[ok] * n + nbr[ok])
            key = key[~visited.seen(key)]
            visited.mark(key)
            cand_q, cand_v = key // n, key % n
            fetch = np.unique(cand_v)
            fetch = fetch[~known.has(fetch)]
            return (cand_q, cand_v), fetch, active

        # seed the beam: entry records come through the prefetcher (cache
        # hits for BFS-seeded vertices), scored like any candidate
        entry = self._entries(entries)
        known.absorb(*self.prefetcher.fetch(entry))
        visited.mark(np.sort((np.arange(nq, dtype=np.int64)[:, None] * n
                              + entry[None, :]).ravel()))
        score_and_merge(np.repeat(np.arange(nq), entry.size),
                        np.tile(entry, nq))

        pending = None      # (PendingFetch | None, cand_q, cand_v, active)
        round_i = 0
        while round_i < budget_rounds:
            if pending is None:
                (cand_q, cand_v), fetch, active = select_frontier()
                if not active.any():
                    break
                pending = (self.prefetcher.prefetch(fetch)
                           if fetch.size else None, cand_q, cand_v, active)
            pf, cand_q, cand_v, active = pending
            pending = None
            if use_overlap and pf is not None and (
                    pf.future is None or pf.future.done()):
                # the reads already landed (fast storage / big compute):
                # merge first and select FRESH — staleness is only worth
                # paying when there is actual I/O latency left to hide
                known.absorb(*self.prefetcher.collect(pf))
                score_and_merge(cand_q, cand_v)
                rounds[:] += active
                round_i += 1
                continue
            if use_overlap:
                # double-buffer: issue round N+1's reads (stale, pre-merge
                # frontier) BEFORE waiting on / scoring round N
                npairs, nfetch, nactive = select_frontier()
                if nactive.any():
                    next_pf = (self.prefetcher.prefetch(nfetch)
                               if nfetch.size else None)
                    pending = (next_pf, npairs[0], npairs[1], nactive)
            if pf is not None:
                known.absorb(*self.prefetcher.collect(pf))
            score_and_merge(cand_q, cand_v)
            rounds[:] += active
            round_i += 1
        else:
            # round budget exhausted with frontier work still pending
            left = ~beam_exp & np.isfinite(beam_d) & ~exhausted[:, None]
            truncated[:] |= left.any(axis=1)
        if pending is not None:     # drain an in-flight fetch cleanly
            if pending[0] is not None:
                known.absorb(*self.prefetcher.collect(pending[0]))
            truncated[:] |= pending[3]

        out_ids = beam_ids[:, :k].astype(np.int32)
        out_d = beam_d[:, :k]
        out_ids = np.where(np.isfinite(out_d), out_ids, -1)
        wall = time.perf_counter() - t_start
        s1 = self.prefetcher.stats()
        hits = s1["cache_hits"] - stats0["cache_hits"]
        miss = s1["cache_misses"] - stats0["cache_misses"]
        self.last_io = {
            "wall_s": wall,
            "io_wait_s": s1["io_wait_s"] - stats0["io_wait_s"],
            "bytes_read": s1["bytes_read"] - stats0["bytes_read"],
            "n_reads": s1["n_reads"] - stats0["n_reads"],
            "n_batches": s1["n_batches"] - stats0["n_batches"],
            "n_retries": s1["n_retries"] - stats0["n_retries"],
            "cache_hits": hits, "cache_misses": miss,
            "cache_hit_rate": hits / (hits + miss) if hits + miss else 0.0,
            "rounds_total": int(round_i), "overlap": use_overlap,
        }
        as_t = lambda a, dtype: torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, dtype)
        return SearchResult(
            as_t(out_ids, torch.int32), as_t(out_d, torch.float32),
            hops=as_t(hops, torch.int32),
            n_dist=as_t(np.rint(n_dist), torch.int32),
            rounds=as_t(rounds, torch.int32),
            truncated=as_t(truncated, torch.bool),
            degraded=False)
