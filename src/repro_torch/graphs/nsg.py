"""NSG (Fu et al. 2017) — monotonic-path PG from a kNN graph, batched.

Port of ``repro/graphs/nsg.py``: each node's candidates are its exact kNN
and the nodes a medoid-rooted exact beam over the kNN graph visits, pruned
by the MRNG rule (RobustPrune with α = 1); then the spanning-tree step, a
BFS from the medoid whose unreachable nodes are adopted by their nearest
reachable node. The kNN graph does not change during the pass, so each
node's row is independent of the batch it is built in. The repair keeps
the reference's BFS, its draw (``default_rng(0)``) and its slot rule on
the host; the nearest parents come from the device (on clustered data
nearly every node outside the medoid's cluster needs one), and the pass
repeats until the BFS reaches every node.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.graphs.adjacency import Graph, find_medoid
from repro_torch.graphs.knn import knn_ids, knn_prefix
from repro_torch.graphs.prune import prune_from_vectors
from repro_torch.kernels.ops import pad_sentinel_row
from repro_torch.search.beam import beam_search, make_exact_dist_fn

# Unreachable nodes whose nearest reachable parent one product finds.
REPAIR_BLOCK = 16384
# Adoption passes at most (the reference makes one; see _repair_connectivity).
REPAIR_PASSES = 8


def build_nsg(x: torch.Tensor, *, r: int = 32, k: int = 64, search_l: int = 32,
              batch: int = 1024, device=None, knn: Optional[torch.Tensor] = None) -> Graph:
    """Build an NSG of degree ≤ ``r`` over x (N, D) on ``device`` (default
    ``cuda``) from its exact ``k``-NN graph, ``batch`` nodes a round.
    ``knn``: that kNN's ids at k or more columns (``knn_ids(x, x, k′,
    exclude_self=True)``), computed once and shared with HNSW's build;
    its first k columns are used."""
    dev = resolve_device(device)
    x = x.to(dev).float().contiguous()
    n = x.shape[0]
    xp = pad_sentinel_row(x)
    medoid = find_medoid(x)
    if knn is None:
        knn, _ = knn_ids(x, x, min(k, n - 1), exclude_self=True)
    else:
        knn = knn_prefix(knn.to(dev), min(k, n - 1))
    dist_fn = make_exact_dist_fn(xp)

    nbrs = torch.empty((n, r), dtype=torch.int32, device=dev)
    for s in range(0, n, batch):
        ids = torch.arange(s, min(s + batch, n), device=dev)
        res = beam_search(knn, medoid, x[ids], dist_fn, h=search_l,
                          max_steps=4 * search_l)
        cand = torch.cat([knn[ids].long(), res.ids.long()], dim=1)
        cand = torch.where(cand == ids[:, None], n, cand)
        nbrs[ids] = prune_from_vectors(xp, ids, cand, 1.0, r, n)

    fixed = _repair_connectivity(x, nbrs.cpu().numpy(), int(medoid), r)
    return Graph(neighbors=torch.from_numpy(fixed).to(dev), medoid=medoid)


def unreachable(nbrs: np.ndarray, medoid: int) -> np.ndarray:
    """Ids that a BFS from ``medoid`` over the (N, R) sentinel-padded
    adjacency does not reach, ascending."""
    n = nbrs.shape[0]
    seen = np.zeros(n, bool)
    frontier = [medoid]
    seen[medoid] = True
    while frontier:
        nxt = nbrs[frontier].reshape(-1)
        nxt = nxt[nxt < n]
        nxt = nxt[~seen[nxt]]
        nxt = np.unique(nxt)
        seen[nxt] = True
        frontier = list(nxt)
    return np.nonzero(~seen)[0]


def _repair_connectivity(x: torch.Tensor, nbrs: np.ndarray, medoid: int,
                         r: int) -> np.ndarray:
    """BFS from medoid; attach unreachable nodes (NSG spanning tree). Edits
    and returns the host table ``nbrs``.

    The reference makes one adoption pass (:func:`_adopt`). When a parent's
    row is full, its last slot takes each new adoptee and drops the one
    before, so that pass can leave nodes unreachable (about 6% of the 1M
    ``sift`` base). The port repeats the pass on what the BFS still misses,
    up to ``REPAIR_PASSES`` times; where one pass reaches every node, the
    table is the reference's.
    """
    missing = unreachable(nbrs, medoid)
    for _ in range(REPAIR_PASSES):
        if len(missing) == 0:
            break
        _adopt(x, nbrs, missing, r)
        missing = unreachable(nbrs, medoid)
    return nbrs


def _adopt(x: torch.Tensor, nbrs: np.ndarray, missing: np.ndarray,
           r: int) -> None:
    """The reference's adoption pass: each ``missing`` node, in ascending
    id order, is adopted by its nearest node among (up to) 20,000 of the
    others drawn by ``default_rng(0)``: the parent's first sentinel slot,
    else its last slot, gets the node.

    The nearest parents of all the missing nodes are found at once on x's
    device, in blocks (the Gram form ‖s‖² − 2x·s, the ranking of the
    reference's ‖s − x‖² up to rounding); the slot assignment is the
    reference's loop.
    """
    n = nbrs.shape[0]
    seen = np.ones(n, bool)
    seen[missing] = False
    reach = np.nonzero(seen)[0]
    sub = reach[np.random.default_rng(0).permutation(len(reach))[:20000]]
    full_f32_matmul()
    x = x.float()
    xs = x[torch.from_numpy(sub).to(x.device)]
    xs2 = (xs * xs).sum(dim=1)
    miss = torch.from_numpy(missing).to(x.device)
    parents = np.empty(len(missing), np.int64)
    for s in range(0, len(missing), REPAIR_BLOCK):
        d = (x[miss[s:s + REPAIR_BLOCK]] @ xs.T).mul_(-2.0).add_(xs2)
        parents[s:s + REPAIR_BLOCK] = sub[d.argmin(dim=1).cpu().numpy()]
    for i, parent in zip(missing, parents):
        slot = np.nonzero(nbrs[parent] == n)[0]
        nbrs[parent, slot[0] if len(slot) else r - 1] = i
