"""Classic Product Quantization (Jégou et al., TPAMI'11) — the DiskANN default.

Vertical split into M chunks, independent K-means per chunk, Lloyd quantizer.
This is both the paper's main baseline and the initializer for OPQ and RPQ.
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.pq import base
from repro_torch.pq.kmeans import kmeans_multi


def train_pq(x: torch.Tensor, m: int, k: int, *, generator: torch.Generator,
             iters: int = 20, device=None) -> base.QuantizerModel:
    """Train a PQ codebook on x (N, D) on ``device`` (default ``cuda``)
    with the identity rotation. ``generator`` (CPU) draws the k-means
    initial centroids."""
    dev = resolve_device(device)
    x = x.to(dev, torch.float32)
    n, d = x.shape
    if d % m:
        raise ValueError(f"D={d} % M={m} != 0")
    r = base.identity_rotation(d, device=dev)
    full_f32_matmul()
    xr = (x @ r.T).reshape(n, m, d // m).transpose(0, 1)    # (M, N, dsub)
    codebooks = kmeans_multi(xr, k, generator=generator, iters=iters)
    return base.QuantizerModel(r=r, codebooks=codebooks)
