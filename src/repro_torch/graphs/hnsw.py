"""HNSW (Malkov & Yashunin 2018) — hierarchical PG, batched construction.

Port of ``repro/graphs/hnsw.py``, with its construction deviation: each
layer's adjacency is an exact kNN graph over the layer's members pruned by
RobustPrune with α = 1 (the "select-neighbors heuristic" is the MRNG
rule), and layer ℓ holds about n / scale^ℓ members drawn by one
permutation. Search descends greedily (h = 1, exact distances) through the
upper layers to a layer-0 entry per query (:func:`descend`, the engines'
``entry_fn``), then runs the ADC beam at layer 0.

The one random draw (the permutation) comes from :func:`hnsw_draws`;
:func:`build_hnsw_from_draws` takes it, so a test can inject the JAX
builder's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.adjacency import Graph, find_medoid
from repro_torch.graphs.knn import knn_ids, knn_prefix
from repro_torch.graphs.prune import prune_from_vectors
from repro_torch.kernels.ops import pad_sentinel_row
from repro_torch.search.beam import beam_search, make_exact_dist_fn

# Nodes per batched prune of a layer (the reference prunes 2048 at a time;
# each node's prune is independent of the others, so the batch does not
# change the graph).
PRUNE_BATCH = 16384


@dataclasses.dataclass
class HNSW:
    base: Graph                      # layer 0 over ALL points
    layers: tuple[Graph, ...]        # upper layers, in local ids
    members: tuple[torch.Tensor, ...]  # (n_ℓ,) int64 sorted global ids
    top_entry: torch.Tensor          # () entry in the TOP layer's local ids

    def to(self, device) -> "HNSW":
        return HNSW(self.base.to(device),
                    tuple(g.to(device) for g in self.layers),
                    tuple(m.to(device) for m in self.members),
                    self.top_entry.to(device))


def _layer_graph(x_layer: torch.Tensor, m: int, knn: Optional[torch.Tensor] = None) -> Graph:
    """Exact kNN at k = min(max(2m, 8), n − 1), pruned to degree m (α = 1).
    ``knn``: the layer's exact self-excluded kNN ids at k or more columns,
    already computed (its first k columns are the k-NN: ascending distance,
    ties to the lower id)."""
    n = x_layer.shape[0]
    k = min(max(2 * m, 8), n - 1)
    if knn is None:
        ids, _ = knn_ids(x_layer, x_layer, k, exclude_self=True)
    else:
        ids = knn_prefix(knn, k)
    xp = pad_sentinel_row(x_layer)
    out = torch.empty((n, m), dtype=torch.int32, device=x_layer.device)
    for s in range(0, n, PRUNE_BATCH):
        node = torch.arange(s, min(s + PRUNE_BATCH, n), device=x_layer.device)
        out[s:s + PRUNE_BATCH] = prune_from_vectors(
            xp, node, ids[s:s + PRUNE_BATCH], 1.0, m, n)
    return Graph(neighbors=out, medoid=find_medoid(x_layer))


def hnsw_draws(generator: torch.Generator, n: int) -> np.ndarray:
    """The permutation of n whose prefixes are the upper layers' members,
    drawn from a CPU ``generator``."""
    return torch.randperm(n, generator=generator).numpy()


def build_hnsw(x: torch.Tensor, *, generator: torch.Generator, m: int = 16,
               scale: int = 8, max_layers: int = 4, device=None,
               knn0: Optional[torch.Tensor] = None) -> HNSW:
    """Build layered HNSW over x (N, D) on ``device`` (default ``cuda``).
    Layer 0 has degree 2m, layer ℓ > 0 degree m and ~n / scale^ℓ members.
    ``knn0``: the base's exact self-excluded kNN ids (``knn_ids(x, x, k,
    exclude_self=True)``, k ≥ 4m), computed once and shared with NSG's build."""
    dev = resolve_device(device)
    perm = hnsw_draws(generator, x.shape[0])
    return build_hnsw_from_draws(x.to(dev), perm, m=m, scale=scale,
                                 max_layers=max_layers, knn0=knn0)


def build_hnsw_from_draws(x: torch.Tensor, perm, *, m: int = 16,
                          scale: int = 8, max_layers: int = 4,
                          knn0: Optional[torch.Tensor] = None) -> HNSW:
    """The build itself, on x's device, from a given permutation (see
    module doc): layer ℓ's members are the first n // scale^ℓ of ``perm``,
    sorted, while there are at least max(2m + 2, 16) of them."""
    n = x.shape[0]
    x = x.float().contiguous()
    perm = torch.tensor(np.asarray(perm), dtype=torch.int64, device=x.device)
    base = _layer_graph(x, 2 * m, knn0)   # layer 0 uses 2M (HNSW convention)
    layers, members = [], []
    sz = n
    while len(layers) < max_layers - 1:
        sz = sz // scale
        if sz < max(2 * m + 2, 16):
            break
        memb = torch.sort(perm[:sz]).values
        layers.append(_layer_graph(x[memb], m))
        members.append(memb)
    top = layers[-1].medoid if layers else base.medoid
    return HNSW(base=base, layers=tuple(layers), members=tuple(members),
                top_entry=top)


def descend(h: HNSW, queries: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Greedy h = 1 descent through the upper layers → (Q,) int32 layer-0
    entry ids, on the queries' device.

    Each layer is one lockstep beam (``max_steps=64``) over the layer's
    exact vectors; its best local id maps to a global id and, by
    ``searchsorted`` into the next layer's sorted members, to that layer's
    local id. With no upper layer every query starts at the base medoid.
    """
    nq = queries.shape[0]
    if not h.layers:
        return h.base.medoid.to(torch.int32).expand(nq).contiguous()
    queries = queries.float()
    entry = h.top_entry.long().expand(nq)
    for li in range(len(h.layers) - 1, -1, -1):
        g, memb = h.layers[li], h.members[li]
        xlp = pad_sentinel_row(x[memb].float())
        res = beam_search(g.neighbors, entry, queries, make_exact_dist_fn(xlp),
                          h=1, max_steps=64)
        glob = memb[res.ids[:, 0].long().clamp(0, memb.shape[0] - 1)]
        if li == 0:
            break
        lower = h.members[li - 1]
        entry = torch.searchsorted(lower, glob).clamp(0, lower.shape[0] - 1)
    return glob.to(torch.int32)
