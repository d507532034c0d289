"""Straggler-tolerant merge of per-shard top-k shortlists.

Port of ``MergedTopK`` and ``partial_merge`` from ``repro/dist/fault.py``;
the rest of that module (retry, quorum, chaos, supervision) belongs to a
later slice. The merge runs on the shortlists' device (the JAX function
merges on the host in numpy).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class MergedTopK(NamedTuple):
    ids: torch.Tensor     # (Q, k) int32 global ids, -1 padding
    dists: torch.Tensor   # (Q, k) float32 ascending, +inf padding
    # True whenever any shard was dead/dropped — the answer may be missing
    # rows it would have had. All-dead yields full sentinel rows, NOT an
    # exception: under a deadline the serving layer must always answer.
    degraded: bool = False


def partial_merge(ids: Sequence, dists: Sequence, alive: Sequence[bool],
                  k: int) -> MergedTopK:
    """Merge per-shard (Q, k_s) GLOBAL ids and ascending distances into the
    (Q, k) best by ascending distance, ties to the earlier shard and slot
    (a stable sort). Dead shards are skipped; rows are padded with
    (-1, +inf) when the live shards give fewer than ``k`` candidates, and
    no live shard at all answers all-sentinel rows with ``degraded=True``.
    """
    alive = list(alive)
    live = [(torch.as_tensor(i), torch.as_tensor(d))
            for i, d, a in zip(ids, dists, alive) if a]
    degraded = len(live) < len(alive)
    if not live:
        first = torch.as_tensor(ids[0]) if len(ids) else torch.empty((0, 0))
        q, dev = first.shape[0], first.device
        return MergedTopK(torch.full((q, k), -1, dtype=torch.int32, device=dev),
                          torch.full((q, k), float("inf"), device=dev), True)
    cat_i = torch.cat([i for i, _ in live], dim=1)
    cat_d = torch.cat([d for _, d in live], dim=1).float()
    if cat_i.shape[1] < k:  # pad so the top-k below is well-defined
        pad = k - cat_i.shape[1]
        cat_i = torch.nn.functional.pad(cat_i, (0, pad), value=-1)
        cat_d = torch.nn.functional.pad(cat_d, (0, pad), value=float("inf"))
    order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
    return MergedTopK(cat_i.gather(1, order).to(torch.int32),
                      cat_d.gather(1, order), degraded)
