"""Optimized Product Quantization (Ge et al., CVPR'13), non-parametric variant.

Port of ``repro/pq/opq.py``. Alternating optimization:
  (1) fix R, retrain codebooks with Lloyd on the rotated data;
  (2) fix codebooks, solve the orthogonal Procrustes problem
      min_R ||R X − X'||_F  →  R = U Vᵀ from SVD(X'ᵀ X)
(row vectors rotate as x @ Rᵀ, so that is the R solved for).
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.pq import base
from repro_torch.pq.pq import train_pq


def train_opq(x: torch.Tensor, m: int, k: int, *, generator: torch.Generator,
              outer_iters: int = 8, kmeans_iters: int = 8,
              device=None) -> base.QuantizerModel:
    """OPQ on x (N, D) on ``device`` (default ``cuda``); every k-means run
    draws its initial centroids from the CPU ``generator``."""
    dev = resolve_device(device)
    x = x.to(dev, torch.float32)
    n, d = x.shape
    model = train_pq(x, m, k, generator=generator, iters=kmeans_iters,
                     device=dev)                                # R = I start
    for _ in range(outer_iters):
        # (2) Procrustes: reconstruction targets in the rotated space
        codes = base.encode(model, x).long()
        sub_rec = model.codebooks[torch.arange(m, device=dev)[None, :],
                                  codes].reshape(n, d)
        full_f32_matmul()
        u, _, vt = torch.linalg.svd(sub_rec.T @ x, full_matrices=False)
        # (1) Lloyd under the new rotation
        model = train_pq(x, m, k, generator=generator, iters=kmeans_iters,
                         rotation=u @ vt, device=dev)
    return model
