"""Vamana graph construction (DiskANN, Jayaram Subramanya et al. 2019).

Batched adaptation, as in the JAX package: the sequential insert loop
becomes rounds of (a) batched beam searches from the medoid to collect
candidate sets, (b) batched RobustPrune, (c) a reverse-edge pass with
re-prune. Stale reads within a batch are benign (the C++ multi-threaded
builder has the same property).

The random draws (initial neighbor table, one visiting order per pass) come
from :func:`vamana_draws`; :func:`build_vamana_from_draws` takes them, so
a test can inject the draws of the JAX builder instead. The adjacency lives
on the device and is updated in place after each batch; the reverse-edge
grouping runs in numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.adjacency import Graph, find_medoid
from repro_torch.graphs.prune import prune_from_vectors
from repro_torch.kernels.ops import pad_sentinel_row
from repro_torch.search.beam import beam_search, make_exact_dist_fn


def vamana_draws(generator: torch.Generator, n: int, r: int, passes: int
                 ) -> tuple[np.ndarray, list[np.ndarray]]:
    """(initial (n, r) int32 neighbor table, one permutation of n per pass)
    drawn from a CPU ``generator``."""
    init = torch.randint(0, n, (n, r), generator=generator).numpy()
    orders = [torch.randperm(n, generator=generator).numpy()
              for _ in range(passes)]
    return init.astype(np.int32), orders


def build_vamana(x: torch.Tensor, *, generator: torch.Generator, r: int = 32,
                 l: int = 64, alpha: float = 1.2, passes: int = 2,
                 batch: int = 1024, verbose: bool = False,
                 device=None) -> Graph:
    """Build a Vamana PG over x (N, D) on ``device`` (default ``cuda``).
    Returns a padded-adjacency Graph. ``verbose`` prints each pass's mean
    degree, as the reference does."""
    dev = resolve_device(device)
    init, orders = vamana_draws(generator, x.shape[0], r, passes)
    return build_vamana_from_draws(x.to(dev), init, orders, r=r, l=l,
                                   alpha=alpha, batch=batch, verbose=verbose)


def build_vamana_from_draws(x: torch.Tensor, init_neighbors: np.ndarray,
                            orders, *, r: int = 32, l: int = 64,
                            alpha: float = 1.2, batch: int = 1024,
                            verbose: bool = False) -> Graph:
    """The build itself, on x's device, from given draws (see module doc):
    pass p visits ``orders[p]`` with α = 1 on the first pass and ``alpha``
    after it."""
    n = x.shape[0]
    dev = x.device
    x = x.float().contiguous()
    xp = pad_sentinel_row(x)
    dist_fn = make_exact_dist_fn(xp)
    medoid = find_medoid(x)

    nbrs = np.array(init_neighbors, dtype=np.int32)          # writable copy
    self_loop = nbrs == np.arange(n)[:, None]
    nbrs[self_loop] = (nbrs[self_loop] + 1) % n
    g = torch.from_numpy(nbrs).to(dev)

    n_pad = (-n) % batch
    for p, order in enumerate(orders):
        a = 1.0 if p == 0 else alpha
        order = np.asarray(order)
        order = np.concatenate([order, order[:n_pad]])
        for s in range(0, len(order), batch):
            ids = torch.from_numpy(order[s:s + batch]).to(dev).long()
            res = beam_search(g, medoid, x[ids], dist_fn, h=l, max_steps=4 * l)
            cand = torch.cat([res.ids.long(), g[ids].long()], dim=1)  # (B, L+R)
            cand = torch.where(cand == ids[:, None], n, cand)
            g[ids] = prune_from_vectors(xp, ids, cand, a, r, n)
        # reverse-edge pass: j gains candidate i for every edge i→j
        g = _reverse_pass(xp, g, a, r, batch)
        if verbose:
            deg = (g < n).sum(dim=1).float().mean()
            print(f"[vamana] pass {p}: mean degree {float(deg):.1f}")

    return Graph(neighbors=g, medoid=medoid)


def _reverse_pass(xp: torch.Tensor, g: torch.Tensor, alpha: float, r: int,
                  batch: int) -> torch.Tensor:
    nbrs = g.cpu().numpy()
    n = nbrs.shape[0]
    src = np.repeat(np.arange(n, dtype=np.int32), r)
    dst = nbrs.reshape(-1)
    keep = dst < n
    src, dst = src[keep], dst[keep]
    # group reverse candidates by destination, cap r per node
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    starts = np.searchsorted(dst_s, np.arange(n))
    ends = np.searchsorted(dst_s, np.arange(n) + 1)
    cnt = np.minimum(ends - starts, r)
    rank = np.arange(len(dst_s)) - starts[dst_s]  # position within its group
    first_r = rank < r
    rev = np.full((n, r), n, np.int32)
    rev[dst_s[first_r], rank[first_r]] = src_s[first_r]
    # re-prune nodes whose candidate set grew
    grew = np.nonzero(cnt > 0)[0].astype(np.int32)
    n_pad = (-len(grew)) % batch
    grew_p = np.concatenate([grew, grew[:n_pad]]) if len(grew) else grew
    rev_d = torch.from_numpy(rev).to(g.device)
    for s in range(0, len(grew_p), batch):
        ids = torch.from_numpy(grew_p[s:s + batch]).to(g.device).long()
        cand = torch.cat([g[ids].long(), rev_d[ids].long()], dim=1)
        cand = torch.where(cand == ids[:, None], n, cand)
        g[ids] = prune_from_vectors(xp, ids, cand, alpha, r, n)
    return g
