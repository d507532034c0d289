"""Classic Product Quantization (Jégou et al., TPAMI'11) — the DiskANN default.

Vertical split into M chunks, independent K-means per chunk, Lloyd quantizer.
This is both the paper's main baseline and the initializer for OPQ and RPQ.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.pq import base
from repro_torch.pq.kmeans import kmeans_multi
from repro_torch.pq.pack import FS_K


def train_pq(x: torch.Tensor, m: int, k: int, *, generator: torch.Generator,
             iters: int = 20, rotation: Optional[torch.Tensor] = None,
             device=None) -> base.QuantizerModel:
    """Train a PQ codebook on x (N, D) on ``device`` (default ``cuda``)
    under a fixed ``rotation`` (default the identity; OPQ passes its
    own). ``generator`` (CPU) draws the k-means initial centroids."""
    dev = resolve_device(device)
    x = x.to(dev, torch.float32)
    n, d = x.shape
    if d % m:
        raise ValueError(f"D={d} % M={m} != 0")
    r = (base.identity_rotation(d, device=dev) if rotation is None
         else rotation.to(dev, torch.float32))
    full_f32_matmul()
    xr = (x @ r.T).reshape(n, m, d // m).transpose(0, 1)    # (M, N, dsub)
    codebooks = kmeans_multi(xr, k, generator=generator, iters=iters)
    return base.QuantizerModel(r=r, codebooks=codebooks)


def train_pq_fs4(x: torch.Tensor, m: int, *, generator: torch.Generator,
                 iters: int = 20, rotation: Optional[torch.Tensor] = None,
                 device=None) -> base.QuantizerModel:
    """K=16 PQ for the fast-scan layout: codes from ``encode`` then
    ``pack.pack_codes`` take M/2 bytes per vector, and
    ``build_lut(..., quantize=True)`` emits the matching uint8 tables."""
    return train_pq(x, m, FS_K, generator=generator, iters=iters,
                    rotation=rotation, device=device)
