"""Blocked Lloyd k-means (the PQ codebook initializer).

Port of ``repro/pq/kmeans.py``. The JAX side vmaps one k-means per PQ
subspace; here the M subspaces are one batch: each N-block is ONE
``pq_pairwise`` call of shape (block, M, dsub) × (M, K, dsub) — the
kernel's own shape — followed by an argmin over K. The update is an
``index_add_`` over M·K segments, and empty clusters are re-seeded at the
currently worst-quantized points, by the same rule as the JAX function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def _assign(xt: torch.Tensor, cent: torch.Tensor, block: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, M, d) points × (M, K, d) centroids → (assign (N, M) int64,
    sqdist (N, M) f32), ties to the lowest centroid."""
    n, m, _ = xt.shape
    idx = torch.empty((n, m), dtype=torch.int64, device=xt.device)
    dist = torch.empty((n, m), dtype=torch.float32, device=xt.device)
    for s in range(0, n, block):
        best, arg = kops.pq_pairwise(xt[s:s + block], cent).min(dim=-1)
        idx[s:s + block] = arg
        dist[s:s + block] = best
    return idx, dist


def kmeans_multi(x: torch.Tensor, k: int, *,
                 generator: torch.Generator | None = None, iters: int = 20,
                 block: int = 8192, init: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Independent k-means per leading axis: x (M, N, d) → centroids
    (M, K, d) — "train the M PQ sub-codebooks". Runs on x's device.

    ``init`` (M, K, d) warm-starts every subspace; without it, subspace j
    starts from the first K rows of one ``torch.randperm`` drawn from the
    CPU ``generator`` (required then).
    """
    return _kmeans(x, k, generator=generator, iters=iters, block=block,
                   init=init)[0]


def kmeans(x: torch.Tensor, k: int, *, generator: torch.Generator | None = None,
           iters: int = 20, block: int = 8192,
           init: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm on x (N, D). Returns (centroids (K, D),
    assignments (N,) int32). ``init`` (K, D) warm-starts the centroids."""
    cent, idx = _kmeans(x[None], k, generator=generator, iters=iters,
                        block=block, init=None if init is None else init[None])
    return cent[0], idx[:, 0].to(torch.int32)


def _kmeans(x: torch.Tensor, k: int, *, generator, iters: int, block: int,
            init) -> tuple[torch.Tensor, torch.Tensor]:
    m, n, d = x.shape
    if k > n:
        raise ValueError(f"kmeans needs K <= N, got K={k} > N={n}")
    dev = x.device
    xt = x.float().transpose(0, 1).contiguous()               # (N, M, d)
    if init is None:
        if generator is None:
            raise ValueError("kmeans needs a generator when init is None")
        cent = torch.stack([
            xt[torch.randperm(n, generator=generator)[:k].to(dev), j]
            for j in range(m)])                                # (M, K, d)
    else:
        if tuple(init.shape) != (m, k, d):
            raise ValueError(f"init {tuple(init.shape)} != {(m, k, d)}")
        cent = init.to(dev, torch.float32).contiguous()

    sub = torch.arange(m, device=dev)
    flat_x = xt.reshape(n * m, d)
    ones = torch.ones(n * m, dtype=torch.float32, device=dev)
    for _ in range(iters):
        idx, dist = _assign(xt, cent, block)
        seg = (idx + sub[None, :] * k).reshape(-1)            # (N·M,)
        sums = torch.zeros((m * k, d), dtype=torch.float32,
                           device=dev).index_add_(0, seg, flat_x)
        counts = torch.zeros(m * k, dtype=torch.float32,
                             device=dev).index_add_(0, seg, ones)
        new = (sums / counts.clamp(min=1.0)[:, None]).reshape(m, k, d)
        # Re-seed empty cluster c of subspace j at the c-th worst-quantized
        # point of j (farthest first, ties to the lower point id).
        far = torch.sort(dist.T, dim=1, descending=True, stable=True)[1][:, :k]
        empty = (counts == 0).reshape(m, k)
        new = torch.where(empty[:, :, None], xt[far, sub[:, None]], new)
        cent = new
    idx, _ = _assign(xt, cent, block)
    return cent, idx
