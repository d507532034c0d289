"""Blocked exact k-nearest neighbors (the ground-truth engine).

Distances in the ‖a‖² − 2abᵀ + ‖b‖² form of the JAX package, one
``torch.matmul`` per query block. The product is a plain matrix product
outside any kernel of the port; it runs in full f32 (TF32 off, see
:func:`repro_torch.device.full_f32_matmul`).
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul


def knn_ids(x: torch.Tensor, q: torch.Tensor, k: int, *, block: int = 1024,
            exclude_self: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """For each row of q (Q, D), the k nearest rows of x (N, D).

    Returns (ids (Q, k) int32, sqdists (Q, k) f32), ascending by distance,
    ties to the lower id. ``exclude_self`` masks exact index matches (for
    q == x graph builds). The working set is a (block, N) distance tile and
    its sort.
    """
    full_f32_matmul()
    n = x.shape[0]
    x = x.float()
    q = q.float()
    x2 = (x * x).sum(dim=1)
    cols = torch.arange(n, device=x.device)
    ids, dists = [], []
    for s in range(0, q.shape[0], block):
        qi = q[s:s + block]
        d2 = (qi * qi).sum(dim=1)[:, None] - 2.0 * qi @ x.T + x2[None, :]
        if exclude_self:
            rows = s + torch.arange(qi.shape[0], device=x.device)
            d2 = torch.where(cols[None, :] == rows[:, None], float("inf"), d2)
        vals, order = torch.sort(d2, dim=1, stable=True)
        ids.append(order[:, :k].to(torch.int32))
        dists.append(vals[:, :k])
    return torch.cat(ids), torch.cat(dists)
