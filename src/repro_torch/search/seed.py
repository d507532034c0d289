"""PQ-hash multi-entry seeding — the coarse half of adaptive routing
(DESIGN.md §11; PQTable, PAPERS.md arxiv 1704.06556).

Port of ``repro/search/seed.py``. A PQTable-style coarse index over the
RESIDENT PQ codes turns a query's own LUT into S near-query entry points:

* **Hash buckets** keyed on the first ``m_hash`` sub-codes (base-K fold
  ``sum_j code_j · K^j``); the query's key is the argmin of each of its
  first ``m_hash`` LUT rows — the sub-code the quantizer would assign it.
* **Pivot fallback**: ``n_pivots`` rows strided across the corpus are
  always appended, so an empty bucket still yields candidates.

:func:`build_seed_index` is host numpy, copied from the reference, so the
bucket table and pivots equal its own exactly. :func:`seed_entries_from`
scores bucket ∪ pivots (C = bucket_cap + n_pivots per query) in ONE call
of the beam's distance kernel — ``hop_adc`` on u8 codes, ``hop_adc_fs``
on fs4 packed codes, with the candidate ids as its (Q, C) frontier — and
returns the (Q, S) top-S ids, ties to the lower lane, -1 for lanes with
no candidate: ``beam_search``'s multi-entry ``entry``. Tombstoned
candidates score ``DEAD_ENTRY_DIST``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.search.beam import (DEAD_ENTRY_DIST, INF, _first_occurrence,
                                     _is_dead, as_bitset)

# Bucket-count ceiling for auto_m_hash: K^m_hash buckets ≤ this. 4096
# int32×bucket_cap rows is ≤ 512 KiB at the default cap — resident
# everywhere — while K=64 still gets 2 hashed subspaces and K=16 gets 3.
MAX_BUCKETS = 4096


def auto_m_hash(m: int, k: int, max_buckets: int = MAX_BUCKETS) -> int:
    """Largest prefix length t ∈ [1, min(m, 4)] with K^t ≤ max_buckets."""
    t = 1
    while t < min(m, 4) and k ** (t + 1) <= max_buckets:
        t += 1
    return t


@dataclasses.dataclass(frozen=True)
class SeedIndex:
    """Coarse index over one corpus.

    Attributes:
      table:  (K^m_hash, bucket_cap) int32 bucket members, -1 padded.
      pivots: (P,) int32 strided sample rows (always-valid fallback).
      codes:  the resident codes that score the candidates, in the layout
              of the LUTs they meet: (N, M) uint8 for f32 LUTs, fs4 packed
              (N, ceil(M/2)) uint8 for a ``QuantizedLUT`` (the reference
              keeps an unpacked int32 copy; the port scores on the
              engine's own codes, so the index adds only table + pivots).
      k:      codebook size the keys are folded in.
      m_hash: hashed prefix length.
    """
    table: torch.Tensor
    pivots: torch.Tensor
    codes: torch.Tensor
    k: int
    m_hash: int

    @property
    def n_candidates(self) -> int:
        """Candidates scored per query (bucket_cap + n_pivots)."""
        return int(self.table.shape[1] + self.pivots.shape[0])

    def seed_entries(self, luts, s: int, tombstones=None) -> torch.Tensor:
        """(Q, S) int32 entry sets for this query batch (-1 = no seed)."""
        return seed_entries_from(self.table, self.pivots, self.codes, luts,
                                 tombstones, k=self.k, m_hash=self.m_hash, s=s)


def build_seed_index(codes, *, k: Optional[int] = None,
                     m_hash: Optional[int] = None, bucket_cap: int = 16,
                     n_pivots: int = 32, max_buckets: int = MAX_BUCKETS,
                     device=None) -> SeedIndex:
    """Build the coarse index from UNPACKED (N, M) codes (host, numpy); its
    tensors land on ``device`` (default: the codes' device for a tensor,
    else ``cuda``). ``k=None`` derives the codebook size from the codes
    (max + 1): the query side argmins only the first k LUT columns, since
    fs4 tables are zero-padded to 16. Bucket overflow keeps the FIRST
    bucket_cap members in row order."""
    if device is None and isinstance(codes, torch.Tensor):
        device = codes.device
    dev = resolve_device(device)
    codes_np = (codes.cpu().numpy() if isinstance(codes, torch.Tensor)
                else np.asarray(codes))
    n, m = codes_np.shape
    if n == 0:
        raise ValueError("build_seed_index: empty corpus")
    if k is None:
        k = int(codes_np.max()) + 1
    if m_hash is None:
        m_hash = auto_m_hash(m, k, max_buckets)
    m_hash = max(1, min(m_hash, m))
    nb = k ** m_hash
    radix = k ** np.arange(m_hash, dtype=np.int64)
    key = (codes_np[:, :m_hash].astype(np.int64) * radix).sum(axis=1)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    # rank of each row within its (sorted) bucket run, fully vectorized
    rank = np.arange(n) - np.searchsorted(sk, sk, side="left")
    table = np.full((nb, bucket_cap), -1, np.int32)
    keep = rank < bucket_cap
    table[sk[keep], rank[keep]] = order[keep].astype(np.int32)
    n_pivots = max(1, min(n_pivots, n))
    stride = max(1, n // n_pivots)
    pivots = np.arange(0, n, stride, dtype=np.int32)[:n_pivots]
    return SeedIndex(torch.from_numpy(table).to(dev),
                     torch.from_numpy(pivots).to(dev),
                     torch.from_numpy(codes_np.astype(
                         np.uint8 if codes_np.dtype == np.uint8 else np.int32)).to(dev),
                     k, m_hash)


def _query_keys(luts, k: int, m_hash: int) -> torch.Tensor:
    """(Q,) bucket keys: per hashed subspace, the argmin LUT column (the
    first minimum, as ``jnp.argmin``), over the first k columns only."""
    lut = luts.lut if isinstance(luts, QuantizedLUT) else luts
    head = lut[:, :m_hash, :k]
    if head.dtype == torch.uint8:
        head = head.to(torch.int32)
    sub = torch.argmin(head, dim=-1)                          # (Q, m_hash)
    radix = k ** torch.arange(m_hash, dtype=torch.int64, device=lut.device)
    return (sub * radix).sum(dim=1)


def _candidate_dists(codes: torch.Tensor, cand: torch.Tensor, luts) -> torch.Tensor:
    """Full-LUT ADC of each query's (Q, C) candidate rows, (Q, C) f32:
    the beam's distance kernel with the candidates as its frontier. cand
    must already be masked to valid rows."""
    if isinstance(luts, QuantizedLUT):
        return kops.hop_adc_fs(codes, cand, luts.lut, luts.scale, luts.bias)
    return kops.hop_adc(codes, cand, luts)


def seed_entries_from(table, pivots, codes, luts, tombstones=None, *,
                      k: int, m_hash: int, s: int) -> torch.Tensor:
    """Functional core of :meth:`SeedIndex.seed_entries`: per query, bucket
    members ∪ pivots → dedupe → one full-LUT ADC call → tombstone-aware
    top-S (ties to the lower lane). Lanes that found no candidate return
    -1. Returns (Q, S) int32."""
    lut = luts.lut if isinstance(luts, QuantizedLUT) else luts
    nq = lut.shape[0]
    n = codes.shape[0]
    bucket = table[_query_keys(luts, k, m_hash)]              # (Q, cap)
    cand = torch.cat([bucket, pivots[None].expand(nq, -1)], dim=1).long()
    ok = (cand >= 0) & (cand < n)
    uniq = _first_occurrence(cand, ok)
    d = torch.where(uniq, _candidate_dists(codes, torch.where(uniq, cand, 0), luts),
                    INF)
    if tombstones is not None:
        dead = _is_dead(as_bitset(tombstones, cand.device), cand, n)
        d = torch.where(uniq & dead, DEAD_ENTRY_DIST, d)
    sd, order = torch.sort(d, dim=1, stable=True)
    sd, order = sd[:, :s], order[:, :s]
    return torch.where(sd < INF, cand.gather(1, order), -1).to(torch.int32)
