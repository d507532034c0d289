"""Blocked exact k-nearest neighbors (the ground-truth engine).

Distances in the ‖a‖² − 2abᵀ + ‖b‖² form of the JAX package, one
``torch.matmul`` per query block. The product is a plain matrix product
outside any kernel of the port; it runs in full f32 (TF32 off, see
:func:`repro_torch.device.full_f32_matmul`). Each block's k nearest are
selected by :func:`topk_lower`, the order of ``lax.top_k``.
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul


def topk_lower(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of (Q, N) ``d``, ascending, ties to the
    LOWER index — the order of ``lax.top_k(-d, k)``, which ``torch.topk``
    does not promise (and fs4 distances tie often).

    ``torch.topk`` finds each row's k-th value, then only the entries at or
    below it (≥ k per row, a few more on ties) are stably sorted by (row,
    value); their column order is ascending already. Returns (values
    (Q, k), indices (Q, k) int64)."""
    q = d.shape[0]
    if d.device.type == "meta":   # shapes only: the selection syncs the host
        return (d.new_empty((q, k)),
                torch.empty((q, k), dtype=torch.int64, device=d.device))
    thr = torch.topk(d, k, dim=1, largest=False).values[:, -1:]   # sorted
    rows, cols = torch.nonzero(d <= thr, as_tuple=True)   # row-major order
    vals = d[rows, cols]
    order = torch.sort(vals, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    vals, cols = vals[order], cols[order]
    counts = torch.bincount(rows, minlength=q)
    start = torch.cumsum(counts, 0) - counts
    pos = start[:, None] + torch.arange(k, device=d.device)[None, :]
    return vals[pos], cols[pos]


def knn_prefix(knn: torch.Tensor, k: int) -> torch.Tensor:
    """The k-NN ids from a precomputed :func:`knn_ids` table of k or more
    columns: its first k (the table is ascending by distance, ties to the
    lower id, so they are what ``knn_ids`` at k returns)."""
    if knn.shape[1] < k:
        raise ValueError(f"a kNN table of {knn.shape[1]} columns; {k} needed")
    return knn[:, :k].contiguous()


def knn_ids(x: torch.Tensor, q: torch.Tensor, k: int, *, block: int = 1024,
            exclude_self: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """For each row of q (Q, D), the k nearest rows of x (N, D).

    Returns (ids (Q, k) int32, sqdists (Q, k) f32), ascending by distance,
    ties to the lower id. ``exclude_self`` masks exact index matches (for
    q == x graph builds). The working set is one (block, N) distance tile;
    the tile is built in place, in the reference's order of operations.
    """
    full_f32_matmul()
    x = x.float()
    q = q.float()
    x2 = (x * x).sum(dim=1)
    ids, dists = [], []
    for s in range(0, q.shape[0], block):
        qi = q[s:s + block]
        d2 = (qi @ x.T).mul_(-2.0)
        d2.add_((qi * qi).sum(dim=1)[:, None]).add_(x2[None, :])
        if exclude_self:
            rows = torch.arange(min(qi.shape[0], x.shape[0] - s), device=x.device)
            d2[rows, s + rows] = float("inf")
        vals, order = topk_lower(d2, k)
        ids.append(order.to(torch.int32))
        dists.append(vals)
    return torch.cat(ids), torch.cat(dists)
