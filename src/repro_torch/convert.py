"""Carry state from the JAX package into the port.

The functions take the JAX objects' arrays as numpy (the caller does the
``np.asarray``) and return the port's objects on ``device``; nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.adjacency import Graph
from repro_torch.pq.base import QuantizerModel


def quantizer_from_numpy(r, codebooks, *, device=None) -> QuantizerModel:
    """(D, D) rotation + (M, K, dsub) codebooks → QuantizerModel (f32)."""
    dev = resolve_device(device)
    as_f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return QuantizerModel(r=as_f32(r), codebooks=as_f32(codebooks))


def graph_from_numpy(neighbors, medoid, *, device=None) -> Graph:
    """(N, R) sentinel-padded adjacency + medoid id → Graph."""
    dev = resolve_device(device)
    nbrs = torch.from_numpy(np.array(neighbors, dtype=np.int32)).to(dev)
    return Graph(neighbors=nbrs,
                 medoid=torch.tensor(int(np.asarray(medoid)), device=dev))


def codes_from_numpy(codes, *, device=None) -> torch.Tensor:
    """(N, M) plain codes with values < 256 → uint8 tensor."""
    codes = np.asarray(codes)
    if codes.size and (codes.min() < 0 or codes.max() > 255):
        raise ValueError("codes_from_numpy: plain codes must lie in [0, 256)")
    dev = resolve_device(device)
    return torch.from_numpy(codes.astype(np.uint8)).to(dev)
