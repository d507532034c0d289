"""Carry state from the JAX package into the port.

The functions take the JAX objects' arrays as numpy (the caller does the
``np.asarray``) and return the port's objects on ``device``; nothing here
imports JAX. The model zoo's converters take a whole param tree (nested
dicts and lists of numpy arrays, as ``jax.tree.map(np.asarray, params)``
gives it) and check it against the port's own init for the config, path
by path, in shape and dtype. A bf16 leaf (``ml_dtypes.bfloat16`` in numpy)
is carried by its raw bits, never through f32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.optim import OptState
from repro_torch.core.quantizer import RPQParams
from repro_torch.device import resolve_device
from repro_torch.graphs.adjacency import Graph
from repro_torch.graphs.hnsw import HNSW
from repro_torch.models import gnn, recsys, transformer
from repro_torch.pq.base import QuantizerModel
from repro_torch.pq.catalyst import CatalystModel, CatalystParams
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


def hnsw_from_numpy(base_nbrs, base_medoid, layer_nbrs, layer_medoids,
                    members, top_entry, *, device=None) -> HNSW:
    """A ``repro.graphs.hnsw.HNSW``'s arrays — layer 0's adjacency and
    medoid, each upper layer's adjacency and medoid (lists, bottom up),
    each upper layer's sorted global member ids, the top layer's entry — →
    the port's HNSW."""
    dev = resolve_device(device)
    layers = tuple(graph_from_numpy(nb, md, device=dev)
                   for nb, md in zip(layer_nbrs, layer_medoids))
    memb = tuple(torch.from_numpy(np.array(mb, dtype=np.int64)).to(dev)
                 for mb in members)
    return HNSW(base=graph_from_numpy(base_nbrs, base_medoid, device=dev),
                layers=layers, members=memb,
                top_entry=torch.tensor(int(np.asarray(top_entry)), device=dev))


def catalyst_from_numpy(w1, b1, w2, b2, r, codebooks, *,
                        device=None) -> CatalystModel:
    """A ``repro.pq.catalyst.CatalystModel``'s arrays — the MLP's weights
    and biases, then its PQ's rotation and codebooks — → the port's (f32)."""
    dev = resolve_device(device)
    as_f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    net = CatalystParams(w1=as_f32(w1), b1=as_f32(b1), w2=as_f32(w2),
                         b2=as_f32(b2))
    return CatalystModel(net=net, pq=quantizer_from_numpy(r, codebooks,
                                                          device=dev))


def _leaf_from_numpy(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _tree_from_numpy(like, tree, dev, path: str = ""):
    """``tree`` as tensors on ``dev``, refusing any path, shape or dtype
    that differs from ``like`` (the port's init on the meta device)."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(like):
            raise ValueError(f"param tree at {path or '/'}: keys "
                             f"{sorted(tree) if isinstance(tree, dict) else type(tree)} "
                             f"!= {sorted(like)}")
        return {k: _tree_from_numpy(like[k], tree[k], dev, f"{path}/{k}") for k in like}
    if isinstance(like, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"param tree at {path}: expected a list of {len(like)}")
        return [_tree_from_numpy(a, b, dev, f"{path}/{i}")
                for i, (a, b) in enumerate(zip(like, tree))]
    t = _leaf_from_numpy(tree, dev)
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
        raise ValueError(f"param {path}: {tuple(t.shape)} {t.dtype}, the config "
                         f"wants {tuple(like.shape)} {like.dtype}")
    return t


def _convert(init, cfg, tree, device):
    shapes = init(torch.Generator(), cfg, device="meta")
    return _tree_from_numpy(shapes, tree, resolve_device(device))


def lm_from_numpy(cfg: transformer.LMConfig, tree, *, device=None) -> dict:
    """A ``repro.models.transformer.init_lm`` tree (dense or MoE) → the
    port's."""
    return _convert(transformer.init_lm, cfg, tree, device)


def gat_from_numpy(cfg: gnn.GATConfig, tree, *, device=None) -> dict:
    """A ``repro.models.gnn.init_gat`` tree → the port's."""
    return _convert(gnn.init_gat, cfg, tree, device)


def dlrm_from_numpy(cfg: recsys.DLRMConfig, tree, *, device=None) -> dict:
    return _convert(recsys.init_dlrm, cfg, tree, device)


def deepfm_from_numpy(cfg: recsys.DeepFMConfig, tree, *, device=None) -> dict:
    return _convert(recsys.init_deepfm, cfg, tree, device)


def din_from_numpy(cfg: recsys.DINConfig, tree, *, device=None) -> dict:
    return _convert(recsys.init_din, cfg, tree, device)


def bert4rec_from_numpy(cfg: recsys.Bert4RecConfig, tree, *, device=None) -> dict:
    return _convert(recsys.init_bert4rec, cfg, tree, device)

