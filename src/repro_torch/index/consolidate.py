"""Consolidation: fold delta + tombstones into the next base generation.

Port of ``repro/index/consolidate.py``. The invariants:

* **compaction** — tombstoned rows are dropped and survivors renumber
  densely (base survivors first, in order; live delta rows after), so the
  new segment has no dead slots and the tombstone bitset restarts empty.
* **graph repair** — a surviving base row that lost an edge to a dropped
  neighbor re-prunes over that neighbor's own surviving out-edges (the
  FreshDiskANN delete-repair rule), so connectivity does not decay.
* **delta fold-in** — each live delta vertex is alpha-pruned (RobustPrune)
  into the base neighborhoods from an exact candidate set plus its greedy
  delta links, and its chosen neighbors re-prune with the new vertex as a
  candidate (reverse edges).
* **atomicity** — the new segment snapshots (write-then-rename) before the
  engine swaps generations, so a crash mid-consolidation leaves the previous
  generation restorable. With a codebook refresh the snapshot carries the
  NEW quantizer and the engine's model swaps together with the segment,
  strictly after the snapshot.
* **codebook refresh** (``refresh=``) — :func:`repro_torch.index.refresh.
  refresh_quantizer` retrains the quantizer on the LIVE base graph and every
  surviving row re-encodes with the new model.

All of it is deterministic (exact candidate sets, no sampling). It runs on
the engine's device in row blocks of ``ROW_BLOCK``: at a 1M-row, R=64 base
with a few percent deleted, nearly every row loses an edge, and the
reference's host (B, R, R) 2-hop gather would be ~15 GB; the prunes here use
the Gram form of the pairwise table (``prune_from_vectors(gram=True)``), and
the reverse-edge grouping is one stable sort instead of a loop over every
destination.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.graphs.adjacency import Graph, find_medoid
from repro_torch.graphs.knn import knn_ids
from repro_torch.graphs.prune import prune_from_vectors
from repro_torch.index.segment import BaseSegment, encode_codes, save_segment
from repro_torch.kernels import ops as kops

# Rows per block of the repair, fold-in and reverse-edge prunes: a block of
# C = 4R = 256 candidates at D = 128 holds (B, C, D) vectors and the
# (B, C, C) table, 3 GB at 8192 rows.
ROW_BLOCK = 8192


def _compact_valid_first(cand: torch.Tensor, width: int,
                         sentinel: int) -> torch.Tensor:
    """(B, C) candidates with -1 invalids → (B, width): valid entries moved
    to the front (stable), truncated, invalids as ``sentinel``."""
    order = torch.sort((cand < 0).to(torch.uint8), dim=1, stable=True).indices
    packed = cand.gather(1, order)[:, :width]
    return torch.where(packed >= 0, packed, sentinel)


def _prune_rows(xp: torch.Tensor, nbrs: torch.Tensor, rows: torch.Tensor,
                cand_fn, alpha: float, r: int, sentinel: int) -> None:
    """``nbrs[rows] = RobustPrune(cand_fn(block))`` over blocks of rows.
    ``cand_fn`` reads no row of ``nbrs`` outside its block, so pruning
    block by block equals the reference's prune of every row at once."""
    for s in range(0, rows.shape[0], ROW_BLOCK):
        blk = rows[s:s + ROW_BLOCK]
        cand = cand_fn(blk)
        cand = torch.where(cand == blk[:, None], sentinel, cand)   # no self-edges
        nbrs[blk] = prune_from_vectors(xp, blk, cand, alpha, r, sentinel,
                                       gram=True).long()


def consolidate(engine, *, alpha: float = 1.2, l: int = 48,
                ckpt_dir: Optional[str] = None, keep: Optional[int] = None,
                refresh=None, chaos=None) -> dict:
    """Compact ``engine`` (a :class:`repro_torch.index.engine.StreamingEngine`)
    into a fresh base generation and swap it in.

    ``refresh``: ``True`` for the default
    :class:`repro_torch.index.refresh.RefreshConfig`, or a config — the
    quantizer retrains on the live base graph, every surviving row
    re-encodes with the new model, and model + segment swap in together,
    after the snapshot.

    Returns a stats dict with ``old2new`` — the (n_base + delta_capacity,)
    global-id remap (-1 = dropped) — plus ``refresh`` (the retrain report)
    when the refresh arm ran. ``chaos`` is the fault-drill hook, called
    with ``"pre_snapshot"`` just before the save and ``"post_snapshot"``
    just after it (before the swap)."""
    base, delta, tombs = engine.base, engine.delta, engine.tombstones
    dev = engine.device
    n_base, c_occ = base.n, delta.count
    r = base.graph.degree

    model_new, refresh_report = engine.model, None
    if refresh:
        from repro_torch.index.refresh import RefreshConfig, refresh_quantizer
        rcfg = refresh if isinstance(refresh, RefreshConfig) else None
        model_new, refresh_report = refresh_quantizer(
            base, engine.model, tombstones=tombs._words, cfg=rcfg, device=dev)

    live_b = ~tombs.contains(np.arange(n_base))
    live_d = ~tombs.contains(n_base + np.arange(c_occ))
    nb = int(live_b.sum())
    nd = int(live_d.sum())
    n_new = nb + nd
    if n_new == 0:
        raise ValueError("consolidate: every row is tombstoned — an empty "
                         "segment cannot serve; rebuild from new data")

    # ---- compaction: dense renumbering, gathered vectors + codes ---------
    old2new = np.full((n_base + delta.capacity,), -1, np.int64)
    old2new[np.flatnonzero(live_b)] = np.arange(nb)
    old2new[n_base + np.flatnonzero(live_d)] = nb + np.arange(nd)
    rows = torch.from_numpy(np.flatnonzero(live_b)).to(dev)   # old id of new row i
    dsel = np.flatnonzero(live_d)
    vec_new = torch.cat([base.vectors[rows],
                         torch.from_numpy(delta.vectors[dsel]).to(dev)])
    if refresh_report is not None:
        # refreshed codebooks: EVERY surviving row re-encodes (one
        # quantizer per generation, never mixed codes)
        codes_new = encode_codes(model_new, vec_new, base.layout)
    else:
        codes_new = torch.cat([base.codes[rows],
                               torch.from_numpy(delta.codes[dsel]).to(dev)])
    xp = kops.pad_sentinel_row(vec_new)
    o2n = torch.from_numpy(old2new).to(dev)

    # ---- surviving base adjacency, dead edges repaired -------------------
    nbrs = torch.full((n_new, r), n_new, dtype=torch.int64, device=dev)
    onb = base.graph.neighbors
    if nb:
        onbr = onb[rows].long()                      # (nb, R), sentinel n_base
        valid = onbr < n_base
        safe = torch.where(valid, onbr, 0)
        mapped = torch.where(valid, o2n[safe], -1)   # -1: dead or sentinel
        nbrs[:nb] = torch.where(mapped >= 0, mapped, n_new)
        lost = valid & (o2n[safe] < 0)               # edges into dead rows
        repair = torch.nonzero(lost.any(dim=1)).flatten()   # new ids, ascending

        def two_hop(blk):
            # 2-hop through each dead neighbor: its surviving out-edges
            lb = lost[blk]
            two = onb[torch.where(lb, safe[blk], 0)].long()      # (b, R, R)
            tv = (two < n_base) & lb[:, :, None]
            tmapped = torch.where(tv, o2n[torch.where(tv, two, 0)], -1)
            cand2 = _compact_valid_first(tmapped.reshape(blk.shape[0], -1),
                                         3 * r, n_new)
            return torch.cat([nbrs[blk], cand2], dim=1)

        _prune_rows(xp, nbrs, repair, two_hop, alpha, r, n_new)

    # ---- fold live delta vertices into the base neighborhoods ------------
    if nd:
        own = torch.arange(nb, n_new, device=dev)
        lc = min(max(l, r + 1), n_new)
        dnbr = torch.from_numpy(delta.neighbors[dsel].astype(np.int64)).to(dev)
        dvalid = dnbr < delta.capacity
        dmapped = torch.where(dvalid, o2n[n_base + torch.where(dvalid, dnbr, 0)], -1)

        def fold_in(blk):
            i = blk - nb
            cand_knn, _ = knn_ids(vec_new, vec_new[blk], lc)    # includes self
            cand = torch.cat([cand_knn.long(), dmapped[i]], dim=1)
            cand = torch.where(cand == blk[:, None], -1, cand)
            return _compact_valid_first(cand, cand.shape[1], n_new)

        _prune_rows(xp, nbrs, own, fold_in, alpha, r, n_new)

        # reverse edges: chosen neighbors re-prune with the new vertex. The
        # first r sources of each destination, in (source, slot) order.
        src = own.repeat_interleave(r)
        dst = nbrs[own].reshape(-1)
        m = dst < n_new
        src, dst = src[m], dst[m]
        if dst.numel():
            dst_s, order = torch.sort(dst, stable=True)
            src_s = src[order]
            uniq, counts = torch.unique_consecutive(dst_s, return_counts=True)
            group = torch.repeat_interleave(torch.arange(uniq.shape[0], device=dev),
                                            counts)
            rank = (torch.arange(dst_s.shape[0], device=dev)
                    - (torch.cumsum(counts, 0) - counts)[group])
            keep_r = rank < r
            rev = torch.full((uniq.shape[0], r), n_new, dtype=torch.int64, device=dev)
            rev[group[keep_r], rank[keep_r]] = src_s[keep_r]
            pos = torch.full((n_new,), -1, dtype=torch.int64, device=dev)
            pos[uniq] = torch.arange(uniq.shape[0], device=dev)
            _prune_rows(xp, nbrs, uniq,
                        lambda blk: torch.cat([nbrs[blk], rev[pos[blk]]], dim=1),
                        alpha, r, n_new)

    # ---- new generation: medoid, snapshot, swap --------------------------
    seg = BaseSegment(
        graph=Graph(neighbors=nbrs.to(torch.int32), medoid=find_medoid(vec_new)),
        codes=codes_new, vectors=vec_new, layout=base.layout,
        generation=base.generation + 1)
    if chaos is not None:
        chaos("pre_snapshot")
    if ckpt_dir:
        # the snapshot carries the (possibly refreshed) quantizer, so a
        # restore is self-contained across codebook changes
        save_segment(ckpt_dir, seg, keep=keep, model=model_new)
    if chaos is not None:
        chaos("post_snapshot")
    # swap model + segment together, strictly AFTER the snapshot
    engine.model = model_new
    engine._install(seg)
    stats = {"generation": seg.generation, "n": n_new,
             "dropped": int(tombs.count), "folded": nd, "old2new": old2new,
             "refreshed": refresh_report is not None}
    if refresh_report is not None:
        stats["refresh"] = refresh_report
    return stats
