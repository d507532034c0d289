"""Plain PyTorch versions of the port's kernels.

Each is the semantics contract of one CUDA kernel (``kernels/csrc/``) and a
port of the JAX oracle of the same name in ``repro/kernels/ref.py``. The
CPU path of ``kernels/ops.py`` runs them; ``chip_smoke.py`` holds each
kernel against its plain version on the card. Inputs arrive in the
canonical dtypes fixed by ``ops``: uint8 codes (plain or fs4-packed), int32
ids, f32 LUTs (uint8 for fs4).

The beam round's plain versions (:func:`beam_expand_ref`,
:func:`beam_merge_ref`) have no JAX oracle of their own: they are the op
chain of ``search/beam.py``'s classic round, and the JAX side's round is
the same ops inside its while loop.
"""

from __future__ import annotations

import torch


def hop_gather_ref(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Per-hop ADC on pre-gathered rows: (Q, R, M) codes × (Q, M, K) LUTs →
    (Q, R) f32, ``out[q, r] = sum_j luts[q, j, codes[q, r, j]]``,
    accumulated one subspace at a time in j order, as ``adc_scan_ref`` and
    ``adc_scan_batch_ref`` sum: a row scored here and the same codes scored
    by a scan come out as the same float."""
    luts = luts.float()
    idx = codes.long()
    out = torch.zeros(codes.shape[:2], dtype=torch.float32, device=luts.device)
    for j in range(codes.shape[2]):
        out += luts[:, j, :].gather(1, idx[:, :, j])
    return out


def hop_adc_ref(codes: torch.Tensor, ids: torch.Tensor,
                luts: torch.Tensor) -> torch.Tensor:
    """Fused per-hop ADC: (N, M) codes, (Q, R′) ids in [0, N), (Q, M, K)
    LUTs → (Q, R′) f32, ``out[q, i] = sum_j luts[q, j, codes[ids[q, i], j]]``.
    """
    return hop_gather_ref(codes[ids.long()], luts)


def adc_scan_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """One-query ADC scan: (N, M) codes × (M, K) LUT → (N,) f32
    ``sum_j lut[j, codes[n, j]]``, accumulated one subspace at a time in j
    order (the kernel's order) without the (N, M) gather."""
    lut = lut.float()
    idx = codes.long()
    out = torch.zeros(codes.shape[0], dtype=torch.float32, device=lut.device)
    for j in range(codes.shape[1]):
        out += lut[j][idx[:, j]]
    return out


def adc_scan_batch_ref(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Batched ADC scan: (N, M) codes × (Q, M, K) LUTs → (Q, N) f32.

    Accumulates one subspace at a time, so the working set is the (Q, N)
    output and not the (Q, N, M) gather (64 GB at 1000 × 1M × 16)."""
    q, m, _ = luts.shape
    luts = luts.float()
    idx = codes.long()
    out = torch.zeros((q, codes.shape[0]), dtype=torch.float32,
                      device=luts.device)
    for j in range(m):
        out += luts[:, j, :][:, idx[:, j]]
    return out


# --------------------------------------------------------------------------
# Fast-scan (fs4): two 4-bit codes per byte, uint8 LUTs, exact int32
# accumulation. The ``*_acc`` functions are the contract of the fs4 CUDA
# kernels (int32 out); the f32 oracles add the one affine dequant.
# --------------------------------------------------------------------------

def _pair_lut(luts_u8: torch.Tensor) -> torch.Tensor:
    """(..., M, 16) u8 LUT → (..., ceil(M/2), 256) int32 PAIRED table,
    ``pair[..., b, byte] = lut[..., 2b, byte & 15] + lut[..., 2b+1, byte >> 4]``
    so one gather with the raw packed byte scores two sub-codes (nibble
    convention of :mod:`repro_torch.pq.pack`). Odd M pads a zero row."""
    li = luts_u8.to(torch.int32)
    if li.shape[-2] % 2:
        li = torch.nn.functional.pad(li, (0, 0, 0, 1))
    byte = torch.arange(256, device=li.device)
    return li[..., 0::2, :][..., byte & 0xF] + li[..., 1::2, :][..., byte >> 4]


def adc_scan_fs_acc(packed: torch.Tensor, luts_u8: torch.Tensor) -> torch.Tensor:
    """(N, ceil(M/2)) packed codes × (Q, M, 16) u8 LUTs → (Q, N) int32
    ``sum_j luts_u8[q, j, code_j]``, exact.

    Accumulates one packed byte column at a time, so the working set is the
    (Q, N) output and not the (Q, N, ceil(M/2)) gather (32 GB at 1000 × 1M
    × 8); integer sums are associative, so the order changes nothing."""
    pair = _pair_lut(luts_u8)                              # (Q, Mb, 256)
    idx = packed.long()
    out = torch.zeros((pair.shape[0], packed.shape[0]), dtype=torch.int32,
                      device=pair.device)
    for b in range(pair.shape[1]):
        out += pair[:, b, :][:, idx[:, b]]
    return out


def hop_adc_fs_acc(packed: torch.Tensor, ids: torch.Tensor,
                   luts_u8: torch.Tensor) -> torch.Tensor:
    """(N, ceil(M/2)) packed codes, (Q, R′) ids in [0, N), (Q, M, 16) u8
    LUTs → (Q, R′) int32 ``sum_j luts_u8[q, j, code_j(ids[q, i])]``."""
    pair = _pair_lut(luts_u8)                              # (Q, Mb, 256)
    rows = packed[ids.long()].long().transpose(1, 2)       # (Q, Mb, R′)
    return pair.gather(2, rows).sum(dim=1, dtype=torch.int32)


def dequant(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            m: int) -> torch.Tensor:
    """Per-query affine undo of fs4 int32 sums: (Q, X) int32 + (Q,)
    scale/bias → (Q, X) f32 ``scale * acc + m * bias``, in the JAX
    oracles' op order (two roundings, no fused multiply-add)."""
    return scale.float()[:, None] * acc.float() + m * bias.float()[:, None]


def adc_scan_fs_ref(packed: torch.Tensor, luts_u8: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Batched fast-scan ADC: (Q, N) f32 ``scale[q] * acc + M * bias[q]``
    with the inner sum in exact int32."""
    return dequant(adc_scan_fs_acc(packed, luts_u8), scale, bias, luts_u8.shape[1])


def hop_adc_fs_ref(packed: torch.Tensor, ids: torch.Tensor, luts_u8: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused per-hop fast-scan ADC: (Q, R′) f32 dequantized distances."""
    return dequant(hop_adc_fs_acc(packed, ids, luts_u8), scale, bias, luts_u8.shape[1])


def pq_pairwise_ref(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, M, dsub) sub-vectors × (M, K, dsub) codewords → (N, M, K) f32
    ``||x[n, j] - codebook[j, k]||^2`` as ``x² − 2·x·c + c²``."""
    x = x.float()
    c = codebook.float()
    x2 = (x * x).sum(dim=-1)[:, :, None]               # (N, M, 1)
    c2 = (c * c).sum(dim=-1)[None, :, :]               # (1, M, K)
    xc = torch.einsum("nmd,mkd->nmk", x, c)            # (N, M, K)
    return x2 - 2.0 * xc + c2


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment (flat, single space): (N, D) × (K, D) →
    (assign (N,) int32, sqdist (N,) f32), ties to the lowest centroid."""
    d = pq_pairwise_ref(x[:, None, :], centroids[None, :, :])[:, 0, :]   # (N, K)
    best, idx = torch.min(d, dim=1)
    return idx.to(torch.int32), best


# --------------------------------------------------------------------------
# The classic beam round (expand=1, no hop pruning): the op chain that the
# two kernels of ``csrc/beam_round.cu`` replace, with the bitset helpers it
# shares with ``search/beam.py``'s other rounds.
# --------------------------------------------------------------------------

INF = float("inf")


def bit_get(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(Q, W) int32 bitset, (Q, B) int64 ids → (Q, B) bool membership."""
    words = bits.gather(1, idx >> 5)
    return ((words >> (idx & 31).to(torch.int32)) & 1).bool()


def bit_masks(idx: torch.Tensor) -> torch.Tensor:
    """(Q, B) int64 ids → int32 words with the id's one bit set (bit 31
    wraps to the int32 sign bit, the same 32 bits as the JAX uint32)."""
    return (torch.ones_like(idx) << (idx & 31)).to(torch.int32)


def first_occurrence(idx: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
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


def scatter_bits_(bits: torch.Tensor, idx: torch.Tensor, on: torch.Tensor) -> None:
    """Set bit ``idx`` of each row's bitset, in place, for every ``on`` lane.

    Precondition: the ``on`` lanes of a row hold DISTINCT ids whose bits are
    still clear. Then every (word, bit) contribution is unique and the
    scatter-ADD equals the missing scatter-OR."""
    word = torch.where(on, idx >> 5, 0)
    mask = torch.where(on, bit_masks(idx), 0)
    bits.scatter_add_(1, word, mask)


def is_dead(tombstones: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(Q, B) ids → bool, True where the id is a tombstoned vertex; lookups
    are guarded to [0, n) (sentinels and padding lanes are never dead)."""
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, 0)
    words = tombstones[safe >> 5]
    return (((words >> (safe & 31).to(torch.int32)) & 1) != 0) & ok


def beam_expand_ref(neighbors: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
                    exp: torch.Tensor, live: torch.Tensor, visited: torch.Tensor,
                    hops: torch.Tensor, ndist: torch.Tensor, count: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The classic round's pick and expansion, in place on the beam's state:
    each live lane expands its best unexpanded finite entry (ties → lower
    slot); its neighbors that are not padding and not visited are fresh,
    an id twice in the row fresh twice (scored twice), its bit set once.
    Returns the (Q, R) int32 frontier ids (0 where not fresh) and the fresh
    mask; clears ``count``."""
    n, r = neighbors.shape
    nq = ids.shape[0]
    cand = torch.where(~exp & (dists < INF), dists, INF)
    sel_d, sel = torch.sort(cand, dim=1, stable=True)
    sel_d, sel = sel_d[:, :1], sel[:, :1]
    sel_ok = (sel_d < INF) & live[:, None]
    exp.scatter_(1, sel, exp.gather(1, sel) | sel_ok)
    hops += sel_ok.sum(dim=1, dtype=torch.int32)
    src = torch.where(sel_ok, ids.gather(1, sel), 0)
    nbr = neighbors[src].long()                               # (Q, 1, R)
    flat = nbr.reshape(nq, r)
    valid = (sel_ok[:, :, None] & (nbr < n)).reshape(nq, r)
    fresh = valid & ~bit_get(visited, torch.where(valid, flat, 0))
    scatter_bits_(visited, flat, first_occurrence(flat, fresh))
    ndist += fresh.sum(dim=1, dtype=torch.int32)
    count.zero_()
    return torch.where(fresh, flat, 0).to(torch.int32), fresh


def beam_merge_ref(ids: torch.Tensor, dists: torch.Tensor, exp: torch.Tensor,
                   front: torch.Tensor, fresh: torch.Tensor, front_d: torch.Tensor,
                   live: torch.Tensor, step: torch.Tensor, ndist: torch.Tensor,
                   count: torch.Tensor, *, n: int, tombstones=None, max_steps: int,
                   max_rounds=None, max_n_dist=None) -> torch.Tensor:
    """The classic round's merge, in place: each live lane keeps the h best
    of beam ++ frontier by a stable sort (ties → the beam, then the lower
    slot); a frontier slot ranks +inf where not fresh or tombstoned and
    carries id ``n`` where not fresh. Then ``step`` counts the round and
    ``live`` is the loop condition again (rounds below ``max_steps`` and
    ``max_rounds``, n_dist below ``max_n_dist``, an unexpanded finite entry
    left). Returns ``count`` holding the number of live lanes."""
    h = ids.shape[1]
    nd = torch.where(fresh, front_d, INF)
    flat = front.long()
    if tombstones is not None:
        # dead neighbors were scored (and counted) but rank +inf
        nd = torch.where(is_dead(tombstones, flat, n), INF, nd)
    all_ids = torch.cat([ids, torch.where(fresh, flat, n)], dim=1)
    all_d = torch.cat([dists, nd], dim=1)
    all_e = torch.cat([exp, torch.zeros_like(fresh)], dim=1)
    new_d, order = torch.sort(all_d, dim=1, stable=True)
    new_d, order = new_d[:, :h], order[:, :h]
    keep = live[:, None]
    ids.copy_(torch.where(keep, all_ids.gather(1, order), ids))
    exp.copy_(torch.where(keep, all_e.gather(1, order) | (new_d == INF), exp))
    dists.copy_(torch.where(keep, new_d, dists))
    step += live.to(torch.int32)
    nxt = (step < max_steps) & (~exp & (dists < INF)).any(dim=1)
    if max_rounds is not None:
        nxt &= step < int(max_rounds)
    if max_n_dist is not None:
        nxt &= ndist < int(max_n_dist)
    live.copy_(nxt)
    return count.copy_(live.sum(dtype=torch.int32))
