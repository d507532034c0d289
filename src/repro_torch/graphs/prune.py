"""Batched RobustPrune (DiskANN Alg. 2 / MRNG edge selection).

Given per-node candidate sets, iteratively keep the closest candidate p and
discard every candidate c with α·δ(p, c) ≤ δ(v, c) (p "occludes" c). α=1
gives the MRNG/NSG rule; α>1 (DiskANN default 1.2) keeps long-range edges.
Vectorized across a node batch with a loop over the R slots.
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul

INF = float("inf")

# Elements of the (rows, C, C, D) squared-difference intermediate that
# prune_from_vectors materializes at once (512 MB of f32): at C = 192,
# D = 128 the whole (B, C, C, D) tensor would be 19 GB at B = 1024.
PAIR_CHUNK_ELEMS = 1 << 27


def robust_prune(cand_ids: torch.Tensor, cand_dv: torch.Tensor,
                 cand_pair: torch.Tensor, alpha: float, r: int,
                 sentinel: int) -> torch.Tensor:
    """Prune candidate sets to degree ≤ r.

    Args:
      cand_ids:  (B, C) int candidate ids (sentinel = invalid / padding).
      cand_dv:   (B, C) f32 distance candidate → node v.
      cand_pair: (B, C, C) f32 pairwise candidate distances.
      alpha:     occlusion factor (≥ 1).
      r:         max out-degree.
      sentinel:  id used for padding (== N).

    Returns: (B, r) int32 pruned neighbor ids (sentinel-padded).
    """
    b, c = cand_ids.shape
    cand_ids = cand_ids.long()
    dev = cand_ids.device
    valid0 = cand_ids != sentinel
    # mask duplicate ids (keep the first occurrence of each id per row)
    sorted_ids, sort_idx = torch.sort(cand_ids, dim=1, stable=True)
    dup_sorted = torch.zeros_like(valid0)
    dup_sorted[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    dup = torch.zeros_like(valid0).scatter_(1, sort_idx, dup_sorted)
    alive = valid0 & ~dup
    dv = torch.where(alive, cand_dv, INF)

    rows = torch.arange(b, device=dev)
    out = torch.full((b, r), c, dtype=torch.int64, device=dev)  # c == "none"
    for slot in range(r):
        has = alive.any(dim=1)
        pos = torch.argmin(torch.where(alive, dv, INF), dim=1)   # (B,)
        out[:, slot] = torch.where(has, pos, c)
        occluded = alpha * cand_pair[rows, pos] <= cand_dv
        alive = alive & ~occluded & has[:, None]
        # the selected candidate occludes itself (d_pp = 0)
        alive[rows, pos] = False
    padded = torch.cat([cand_ids, torch.full((b, 1), sentinel,
                                             dtype=torch.int64, device=dev)],
                       dim=1)
    return padded.gather(1, out).to(torch.int32)


def prune_from_vectors(x: torch.Tensor, node_ids: torch.Tensor,
                       cand_ids: torch.Tensor, alpha: float, r: int,
                       sentinel: int, *, gram: bool = False) -> torch.Tensor:
    """Convenience: gathers vectors and computes both distance tables.

    x must be sentinel-padded: x[(N+1), D] with x[N] finite (distances to the
    pad row are masked via the id check inside robust_prune). The pairwise
    table uses the squared-difference formula of the JAX function, over row
    chunks of PAIR_CHUNK_ELEMS elements; ``gram=True`` computes it as
    ‖a‖² + ‖b‖² − 2a·b with one batched full-f32 product instead (the same
    distances up to rounding, at a fraction of the memory traffic: the
    streaming index's consolidation prunes up to every row of a segment).
    """
    cand_ids = cand_ids.long()
    node_ids = node_ids.long()
    xv = x[node_ids]                                         # (B, D)
    xc = x[torch.where(cand_ids == sentinel, 0, cand_ids)]   # (B, C, D)
    dv = ((xc - xv[:, None, :]) ** 2).sum(dim=-1)
    dv = torch.where(cand_ids == sentinel, INF, dv)
    b, c, d = xc.shape
    if gram:
        full_f32_matmul()
        sq = (xc * xc).sum(dim=-1)
        pair = (sq[:, :, None] + sq[:, None, :]
                - 2.0 * torch.bmm(xc, xc.transpose(1, 2))).clamp_(min=0.0)
        return robust_prune(cand_ids, dv, pair, alpha, r, sentinel)
    pair = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    step = max(1, PAIR_CHUNK_ELEMS // (c * c * d))
    for s in range(0, b, step):
        blk = xc[s:s + step]
        pair[s:s + step] = ((blk[:, :, None, :] - blk[:, None, :, :]) ** 2
                            ).sum(dim=-1)
    return robust_prune(cand_ids, dv, pair, alpha, r, sentinel)
