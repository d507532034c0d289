"""Carry state from the JAX package into the port.

The functions take the JAX objects' arrays as numpy (the caller does the
``np.asarray``) and return the port's objects on ``device``; nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.optim import OptState
from repro_torch.core.quantizer import RPQParams
from repro_torch.device import resolve_device
from repro_torch.graphs.adjacency import Graph
from repro_torch.pq.base import QuantizerModel
from repro_torch.pq.pack import QuantizedLUT


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
    """(N, M) plain codes with values < 256, or fs4 (N, ceil(M/2)) packed
    bytes (``repro.pq.pack.pack_codes``) → uint8 tensor."""
    codes = np.asarray(codes)
    if codes.size and (codes.min() < 0 or codes.max() > 255):
        raise ValueError("codes_from_numpy: plain codes must lie in [0, 256)")
    dev = resolve_device(device)
    return torch.from_numpy(codes.astype(np.uint8)).to(dev)


def quantized_lut_from_numpy(lut, scale, bias, *, device=None) -> QuantizedLUT:
    """A ``repro.pq.pack.QuantizedLUT``'s arrays — (Q, M, 16) uint8 tables,
    (Q,) scale and bias — → the port's QuantizedLUT."""
    dev = resolve_device(device)
    return QuantizedLUT(
        lut=torch.from_numpy(np.array(lut, dtype=np.uint8)).to(dev),
        scale=torch.from_numpy(np.array(scale, dtype=np.float32)).to(dev),
        bias=torch.from_numpy(np.array(bias, dtype=np.float32)).to(dev))


def rpq_params_from_numpy(theta, codebooks, log_alpha, *, device=None) -> RPQParams:
    """A ``repro.core.quantizer.RPQParams``'s arrays → the port's (f32)."""
    dev = resolve_device(device)
    as_f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return RPQParams(theta=as_f32(theta), codebooks=as_f32(codebooks),
                     log_alpha=as_f32(log_alpha))


def opt_state_from_numpy(step, m, v, *, device=None) -> OptState:
    """An Adam ``OptState``: its step and its moment trees (``RPQParams``
    of arrays each, as ``(m, v)`` of the reference) → the port's."""
    dev = resolve_device(device)
    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                      device=dev),
                    inner=(rpq_params_from_numpy(*m, device=dev),
                           rpq_params_from_numpy(*v, device=dev)))
