"""Evaluation metrics: recall@k and QPS timing (paper §8.1)."""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def recall_at_k(pred_ids, gt_ids, k: int) -> float:
    """Paper Eq. 1: |R ∩ R̃| / k, averaged over queries.

    Args:
      pred_ids: (Q, ≥k) predicted ids; only the first k columns count and
        order within them is irrelevant (set intersection). Sentinel ids
        (N from the beam) never match real ground-truth ids.
      gt_ids:   (Q, k) exact nearest-neighbor ids (graphs.knn.knn_ids).
      k:        cutoff; must be ≤ gt_ids.shape[1].

    Returns:
      Mean recall in [0, 1] as a python float.
    """
    pred = _numpy(pred_ids)[:, :k]
    gt = _numpy(gt_ids)[:, :k]
    hits = 0
    for p, g in zip(pred, gt):
        hits += len(set(p.tolist()) & set(g.tolist()))
    return hits / (k * len(gt))


def live_ground_truth(vectors, live_gids, queries, k: int) -> np.ndarray:
    """Exact top-k over the LIVE subset of a churned corpus, in GLOBAL ids.

    Restrict ``vectors`` (row = vector of global id) to ``live_gids``,
    brute-force the ground truth there with ``graphs.knn.knn_ids`` (on the
    vectors' device for a tensor, else the CPU), and translate the subset
    indices back to global ids, so the result compares directly against
    an engine's returned ids with :func:`recall_at_k`.

    Returns:
      (Q, k) int64 numpy global ids of the exact nearest live rows.
    """
    from repro_torch.graphs.knn import knn_ids

    gids = _numpy(live_gids).astype(np.int64)
    if isinstance(vectors, torch.Tensor):
        vecs = vectors[torch.from_numpy(gids).to(vectors.device)]
    else:
        vecs = torch.from_numpy(np.asarray(vectors, np.float32)[gids])
    qs = torch.as_tensor(queries, dtype=torch.float32, device=vecs.device)
    gt, _ = knn_ids(vecs, qs, k)
    return gids[_numpy(gt)]


def _sync(queries: torch.Tensor) -> None:
    if queries.is_cuda:
        torch.cuda.synchronize(queries.device)


def measure_qps(search_fn: Callable, queries: torch.Tensor, *,
                repeats: int = 3, warmup: int = 1) -> tuple[float, object]:
    """Throughput of a batched search callable, warm-up excluded.

    Runs ``search_fn(queries)`` ``warmup`` times untimed (kernel builds,
    allocator caches), then ``repeats`` timed runs, each ended by
    ``torch.cuda.synchronize()`` on the queries' device so asynchronous
    launches can't fake speed. QPS = n_queries / mean wall time of one
    batch — batch throughput, not single-query latency.

    Returns:
      (qps, last_result) — the result is returned so callers can score
      recall on exactly what was timed.
    """
    nq = queries.shape[0]
    out = None
    for _ in range(warmup):
        out = search_fn(queries)
        _sync(queries)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = search_fn(queries)
        _sync(queries)
    dt = (time.perf_counter() - t0) / repeats
    return nq / dt, out
