"""StreamingEngine — live serving over a mutable (base + delta) index.

Port of ``repro/index/engine.py``. The query path is two arms merged by one
top-k:

* **base arm** — the lockstep beam over the frozen base graph, with the
  tombstone bitset threaded through ``beam_search(tombstones=)``: deleted
  vertices rank +inf, are never expanded and are scrubbed from the returned
  beam. Entry sets, hop pruning and budgets ride along as in the other
  graph engines.
* **delta arm** — one bulk ADC scan (``adc_scan_batch``, fs4
  ``adc_scan_fs``) over the fixed-capacity delta codes; unoccupied slots and
  tombstoned delta rows mask to +inf. No graph is consulted.

``insert`` encodes through the base segment's quantizer and ``delete`` flips
tombstone bits over base and delta alike. The device copies of the delta
codes, its live mask and the bitset are refreshed once per mutation, not per
search. ``search`` takes the other engines' arguments, so ``launch/serve.py``
and ``search/degrade.py`` drive it unchanged (``skip_delta`` is the ladder's
L5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.delta import DeltaSegment
from repro_torch.index.segment import BaseSegment, Tombstones, encode_codes
from repro_torch.kernels import ops as kops
from repro_torch.pq import base as pqbase
from repro_torch.pq.pack import unpack_codes
from repro_torch.search import beam
from repro_torch.search import seed as sseed
from repro_torch.search.beam import INF, SearchResult
from repro_torch.search.engine import _bulk_adc, _prune_cfg, topk_lower


def _merge_delta(beam_ids: torch.Tensor, beam_dists: torch.Tensor,
                 delta_codes: torch.Tensor, luts, live: torch.Tensor, *,
                 k: int, n_base: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse the two arms: the (Q, h) beam over the base graph + one bulk
    ADC scan of the (C, W) delta codes → global (Q, k) ids and distances.

    Beam sentinel slots (id ``n_base``, which in the global id space is
    delta slot 0) become -1 before the concat, and so does any candidate at
    +inf (a masked delta slot, a scrubbed tombstone). The delta arm comes
    FIRST: ties go to the lower lane (``topk_lower``, the order of
    ``lax.top_k``), so a fresh insert outranks a base row with identical
    codes — read-your-writes for a query at the inserted vector."""
    ddist = torch.where(live[None, :], _bulk_adc(delta_codes, luts), INF)
    q, c = ddist.shape
    dgids = (n_base + torch.arange(c, dtype=torch.int32, device=ddist.device)
             ).expand(q, c)
    base = beam_ids < n_base
    all_ids = torch.cat([dgids, torch.where(base, beam_ids, -1)], dim=1)
    all_d = torch.cat([ddist, torch.where(base, beam_dists, INF)], dim=1)
    all_ids = torch.where(torch.isfinite(all_d), all_ids, -1)
    vals, order = topk_lower(all_d, k)
    return all_ids.gather(1, order), vals


def _base_only_topk(beam_ids: torch.Tensor, beam_dists: torch.Tensor, *,
                    k: int, n_base: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Degraded merge (``skip_delta``): the base arm only, with
    :func:`_merge_delta`'s sentinel rules — beam sentinels and non-finite
    candidates report id -1."""
    base = beam_ids < n_base
    bdists = torch.where(base, beam_dists, INF)
    bids = torch.where(base & torch.isfinite(bdists), beam_ids, -1)
    vals, order = topk_lower(bdists, k)
    return bids.gather(1, order), vals


@dataclasses.dataclass
class StreamingEngine:
    """Mutable index serving live queries under insert/delete churn.

    Global id space: ``[0, n_base)`` are base rows of the current
    generation, ``[n_base, n_base + delta_capacity)`` are delta slots.
    Consolidation REMAPS ids (compaction drops tombstoned rows); callers
    holding ids across a consolidate() translate them through the returned
    ``old2new`` map. State lives on ``device`` (default ``cuda``).
    """

    base: BaseSegment
    model: pqbase.QuantizerModel
    delta_capacity: int = 1024
    delta_degree: int = 8
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device)
        self._install(self.base)

    def _install(self, seg: BaseSegment) -> None:
        """(Re)point serving state at a base segment — used by __init__ and
        by consolidate() when it swaps in the next generation."""
        dev = self.device
        seg = dataclasses.replace(
            seg, graph=seg.graph.to(dev), codes=seg.codes.to(dev).contiguous(),
            vectors=None if seg.vectors is None else seg.vectors.to(dev))
        self.base = seg
        self.delta = DeltaSegment(
            self.delta_capacity, seg.dim, seg.code_width,
            degree=self.delta_degree,
            code_dtype=torch.empty(0, dtype=seg.codes.dtype).numpy().dtype)
        self.tombstones = Tombstones(seg.n + self.delta_capacity, device=dev)
        self._codes_p = kops.pad_sentinel_row(seg.codes)
        self._entry = int(seg.graph.medoid)
        self._seedix = None       # coarse seeding index (built lazily)
        self._dirty = True        # delta device caches stale

    # -- mutation ----------------------------------------------------------

    def insert(self, vectors) -> np.ndarray:
        """Encode + append a batch of new rows. Returns their GLOBAL ids.

        Raises :class:`repro_torch.index.delta.DeltaFullError` when the
        delta is out of slots — consolidate() and retry."""
        vectors = np.atleast_2d(np.asarray(
            vectors.cpu() if isinstance(vectors, torch.Tensor) else vectors,
            np.float32))
        codes = encode_codes(self.model, torch.from_numpy(vectors).to(self.device),
                             self.base.layout)
        slots = self.delta.append(vectors, codes.cpu().numpy())
        self._dirty = True
        return self.base.n + slots

    def delete(self, ids) -> int:
        """Tombstone ids (base or delta). Idempotent; returns how many were
        newly deleted. Deleting the current entry point (e.g. the medoid)
        re-anchors routing on a live vertex."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        occupied = self.base.n + self.delta.count
        if ids.size and ((ids < 0) | (ids >= occupied)).any():
            bad = ids[(ids < 0) | (ids >= occupied)]
            raise ValueError(
                f"delete: ids out of the occupied range [0, {occupied}): "
                f"{bad} (base rows {self.base.n}, delta count "
                f"{self.delta.count})")
        fresh = self.tombstones.add(ids)
        if fresh:
            self._dirty = True
        if self.tombstones.contains([self._entry])[0]:
            self._reselect_entry()
        return fresh

    def _reselect_entry(self) -> None:
        """Move the beam entry off a tombstoned vertex: a live base neighbor
        of the old entry, else the first live base row. All base rows dead
        keeps the old entry (the beam starts there at a large finite
        distance and scrubs it, so queries still answer from the delta)."""
        n = self.base.n
        nbrs = self.base.graph.neighbors[self._entry].cpu().numpy()
        nbrs = nbrs[nbrs < n]
        live_nbrs = nbrs[~self.tombstones.contains(nbrs)]
        if live_nbrs.size:
            self._entry = int(live_nbrs[0])
            return
        live = np.flatnonzero(~self.tombstones.contains(np.arange(n)))
        if live.size:
            self._entry = int(live[0])

    def consolidate(self, *, alpha: float = 1.2, l: int = 48,
                    ckpt_dir: Optional[str] = None, keep: Optional[int] = None,
                    refresh=None, chaos=None) -> dict:
        """Fold delta + tombstones into the next base generation (see
        :func:`repro_torch.index.consolidate.consolidate`). ``refresh``
        (True or a :class:`repro_torch.index.refresh.RefreshConfig`)
        retrains the quantizer on the live graph and re-encodes the new
        generation. ``chaos`` is the fault-drill phase hook."""
        from repro_torch.index.consolidate import consolidate

        return consolidate(self, alpha=alpha, l=l, ckpt_dir=ckpt_dir,
                           keep=keep, refresh=refresh, chaos=chaos)

    @classmethod
    def restore(cls, ckpt_dir: str,
                model: Optional[pqbase.QuantizerModel] = None, *,
                generation: Optional[int] = None, delta_capacity: int = 1024,
                delta_degree: int = 8, retry=None, on_fallback=None,
                device=None) -> "StreamingEngine":
        """Resume from the last (or a given) consolidated generation's
        snapshot — delta and tombstones restart empty, the state the
        snapshot froze. ``model=None`` takes the quantizer stored in the
        snapshot (required after a refreshed consolidation); an explicit
        ``model`` overrides it and must match the snapshot's code width and
        layout. A corrupt or unreadable newest snapshot falls back to the
        newest intact one (``on_fallback(generation, error)`` sees each
        skip); ``retry`` re-reads transient I/O failures."""
        from repro_torch.index.segment import load_segment
        from repro_torch.pq.pack import FS_K, packed_width

        seg, stored = load_segment(ckpt_dir, generation, with_model=True,
                                   retry=retry, on_fallback=on_fallback,
                                   device=device)
        if model is None:
            if stored is None:
                raise ValueError(
                    "restore: snapshot has no stored quantizer (pre-refresh "
                    "format) — pass the model the segment was encoded with")
            model = stored
        want = packed_width(model.m) if seg.layout == "fs4" else model.m
        if seg.code_width != want or (seg.layout == "fs4" and model.k > FS_K):
            raise ValueError(
                f"restore: quantizer (M={model.m}, K={model.k}) does not "
                f"match the {seg.layout} snapshot's code width "
                f"{seg.code_width} — pass the model the segment was "
                f"encoded with")
        return cls(seg, model, delta_capacity=delta_capacity,
                   delta_degree=delta_degree, device=device)

    # -- query -------------------------------------------------------------

    def lut_fn(self, queries: torch.Tensor):
        """Per-query LUTs in the base segment's layout (u8 → f32 tables,
        fs4 → QuantizedLUT)."""
        return pqbase.build_lut(self.model, queries,
                                quantize=self.base.layout == "fs4")

    def _seed_index(self) -> sseed.SeedIndex:
        """Coarse seeding index over the BASE codes (the delta is scanned
        whole anyway), rebuilt per generation; tombstones apply at query
        time, so churn never rebuilds it. fs4 codes unpack once to build
        the table and are scored packed."""
        if self._seedix is None:
            codes = self.base.codes
            if self.base.layout == "fs4":
                codes = unpack_codes(codes, self.model.m)
            ix = sseed.build_seed_index(codes, device=self.device)
            self._seedix = dataclasses.replace(ix, codes=self.base.codes)
        return self._seedix

    def _sync_delta(self) -> None:
        """One upload per mutation: the delta codes, the (C,) live mask of
        occupied, untombstoned slots, and the bitset's device view."""
        if self._dirty:
            slot = np.arange(self.delta.capacity)
            live = ((slot < self.delta.count)
                    & ~self.tombstones.contains(self.base.n + slot))
            self._live_dev = torch.from_numpy(live).to(self.device)
            self._delta_codes_dev = torch.from_numpy(self.delta.codes).to(self.device)
            self._dirty = False

    def search(self, queries, *, k: int = 10, h: int = 32,
               max_steps: int = 512, expand: int = 1, entries: int = 1,
               prune_eps: float = 0.0, m_prefix: int = 0, max_rounds=None,
               max_n_dist=None, skip_delta: bool = False) -> SearchResult:
        """Serve a query batch over base ∪ delta minus tombstones.

        Guarantee: a tombstoned id is NEVER returned, at any beam width, in
        either code layout — the beam scrubs dead base ids, the delta mask
        kills dead and unoccupied slots, and the merge turns every
        non-finite candidate into id -1. ``entries > 1`` seeds from the
        base coarse index tombstone-aware, ``prune_eps > 0`` gates full-LUT
        scoring behind the partial-LUT lower bound, ``max_rounds`` /
        ``max_n_dist`` cap the base beam. ``skip_delta=True`` (the last
        degradation rung) answers base-only: fresh inserts go invisible
        until the next consolidation; the tombstone guarantee holds."""
        queries = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32)
                                   .to(self.device))
        luts = self.lut_fn(queries)
        self._sync_delta()
        ts = self.tombstones.words
        packed = self.base.layout == "fs4"
        mp, mt = _prune_cfg(luts, prune_eps, m_prefix)
        lb_fn = (beam.make_adc_dist_fn(self._codes_p, packed=packed, m_prefix=mp)
                 if mp else None)
        cal_fn = beam.make_lb_scale_fn(packed=packed, m_prefix=mp) if mp else None
        seed_cost = 0
        if entries > 1:
            ix = self._seed_index()
            entry = ix.seed_entries(luts, entries, tombstones=ts)
            seed_cost = ix.n_candidates
        else:
            entry = self._entry
        res = beam.beam_search(
            self.base.graph.neighbors, entry, luts,
            beam.make_adc_dist_fn(self._codes_p, packed=packed), h=h,
            max_steps=max_steps, expand=expand, tombstones=ts,
            lb_dist_fn=lb_fn, m_prefix=mp, m_total=mt,
            prune_eps=prune_eps if mp else 0.0, lb_scale_fn=cal_fn,
            max_rounds=max_rounds, max_n_dist=max_n_dist)
        if skip_delta:
            ids, dists = _base_only_topk(res.ids, res.dists, k=min(k, h),
                                         n_base=self.base.n)
            delta_cost = 0
        else:
            ids, dists = _merge_delta(
                res.ids, res.dists, self._delta_codes_dev, luts, self._live_dev,
                k=min(k, h + self.delta.capacity), n_base=self.base.n)
            delta_cost = self.delta.count
        # occupied delta slots count as distance work (the unoccupied tail
        # is masked padding), as do the seed probe's candidates
        n_dist = res.n_dist + (delta_cost + seed_cost)
        return SearchResult(ids, dists, res.hops, n_dist, res.rounds,
                            truncated=res.truncated)

    # -- accounting --------------------------------------------------------

    @property
    def generation(self) -> int:
        return self.base.generation

    @property
    def n_live(self) -> int:
        """Rows a query can currently return."""
        return self.base.n + self.delta.count - self.tombstones.count

    def memory_bytes(self) -> int:
        return (self.base.memory_bytes() + self.delta.memory_bytes()
                + self.tombstones._words.nbytes)
