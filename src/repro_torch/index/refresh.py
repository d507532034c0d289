"""Routing-guided codebook refresh for the streaming index.

Port of ``repro/index/refresh.py``. The serving stack runs on PQ codes, but
the paper's contribution is the LEARNED quantizer, trained on neighborhood
and routing features of the live proximity graph. This module closes that
loop at consolidation time: :func:`refresh_quantizer` takes the CURRENT
base segment and its tombstone bitset and returns a quantizer for the next
generation, which :func:`repro_torch.index.consolidate.consolidate` uses to
re-encode every surviving row, snapshot the new generation WITH its
codebooks and swap model + segment together.

Two refinement stages, both warm-started from the serving codebooks:

1. **Lloyd warm start** (``kmeans_iters``): k-means over the LIVE rotated
   sub-vectors, initialized at the current codebooks (``kmeans_multi(init=)``
   draws nothing), absorbing distribution drift.
2. **Routing-guided gradient steps** (``steps`` Adam steps on the paper's
   joint loss): ``core.trainer.fit`` with ``tombstones=`` — triplet anchors
   and routing queries come from live vertices of the live graph only.

The rotation stays frozen: training runs on pre-rotated vectors ``x @ R.T``
with ``learn_rotation=False`` (squared distance is rotation-invariant, so
the graph over the original vectors is as valid in the rotated space), and
the refreshed model keeps the original R.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import quantizer as Q
from repro_torch.core import trainer as T
from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.index.segment import BaseSegment
from repro_torch.pq import base as pqbase
from repro_torch.pq.kmeans import kmeans_multi


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """Knobs for one codebook refresh (sized for a consolidation pause, not
    a from-scratch training run — tens of steps, small batches)."""

    steps: int = 40                 # routing-guided Adam steps (0 = Lloyd only)
    kmeans_iters: int = 5           # warm-started Lloyd iterations (0 = skip)
    lr: float = 1e-3
    triplet_batch: int = 256
    routing_batch: int = 256
    routing_pool_queries: int = 64
    routing_refresh_every: int = 20  # re-extract routing features this often
    beam_h: int = 8
    n_hops: int = 2
    k_pos: int = 10
    k_neg: int = 30
    use_routing: bool = True
    use_neighborhood: bool = True
    data_parallel: bool = False     # fit's data-parallel step (replicas =
                                    # the visible CUDA devices)
    max_sample: int = 20_000        # live-row cap for the Lloyd stage
    seed: int = 0
    verbose: bool = False


def _live_mask(tombstones: Optional[np.ndarray], n: int) -> np.ndarray:
    """(n,) bool live mask from uint32 bitset words (all-live when None)."""
    live = np.zeros((n,), bool)
    live[T.live_ids_of(tombstones, n)] = True
    return live


def refresh_quantizer(base: BaseSegment, model: pqbase.QuantizerModel, *,
                      tombstones: Optional[np.ndarray] = None,
                      cfg: Optional[RefreshConfig] = None,
                      draws: Optional[Callable] = None, device=None,
                      ) -> tuple[pqbase.QuantizerModel, dict]:
    """Retrain the quantizer against the LIVE rows of ``base`` on ``device``
    (default ``cuda``).

    Args:
      base:       the current (pre-compaction) base segment — its graph is
                  the live routing structure the features are sampled from.
      model:      the serving quantizer to warm-start from (its rotation is
                  kept; its codebooks are the starting point).
      tombstones: optional uint32 bitset words over the GLOBAL id space
                  (only bits < base.n matter): dead vertices never appear as
                  anchors, positives, negatives or routing waypoints, and
                  never reach the Lloyd stage.
      cfg:        :class:`RefreshConfig` (default: a consolidation-sized
                  refresh); ``cfg.seed`` seeds the subsample and ``fit``.
      draws:      ``fit(draws=)`` — every draw of the gradient stage.

    Returns:
      (new_model, report) — ``new_model`` shares ``model.r`` with fresh
      codebooks; ``report`` carries live counts and the mean squared
      reconstruction error over live rows before and after.
    """
    cfg = cfg if cfg is not None else RefreshConfig()
    dev = resolve_device(device)
    model = model.to(dev)
    n, d = base.n, base.dim
    m, k = model.m, model.k
    live = _live_mask(tombstones, n)
    n_live = int(live.sum())
    if n_live < k:
        raise ValueError(
            f"refresh_quantizer: only {n_live} live rows but K={k} codewords "
            f"per subspace — consolidate without refresh or add data")

    full_f32_matmul()
    x = base.vectors.to(dev, torch.float32)
    xr = x @ model.r.T                       # train in the rotated space

    live_idx = np.flatnonzero(live)
    if live_idx.size > cfg.max_sample:
        sel = np.random.default_rng(cfg.seed).choice(
            live_idx, cfg.max_sample, replace=False)
        live_idx = np.sort(sel)
    sel_t = torch.from_numpy(live_idx).to(dev)
    x_live = x[sel_t]
    report = {"n_live": n_live, "steps": cfg.steps,
              "kmeans_iters": cfg.kmeans_iters,
              "distortion_before": float(pqbase.distortion(model, x_live))}

    # ---- stage 1: warm-started Lloyd on live rotated sub-vectors ---------
    codebooks = model.codebooks.float()
    if cfg.kmeans_iters > 0:
        sub = xr[sel_t].reshape(live_idx.size, m, d // m).transpose(0, 1)
        codebooks = kmeans_multi(sub, k, iters=cfg.kmeans_iters, init=codebooks)

    # ---- stage 2: routing-guided gradient steps on the live graph --------
    history: list = []
    if cfg.steps > 0:
        qcfg = Q.RPQConfig(dim=d, m=m, k=k, learn_rotation=False)
        tcfg = T.TrainConfig(
            steps=cfg.steps, lr=cfg.lr, triplet_batch=cfg.triplet_batch,
            routing_batch=cfg.routing_batch,
            routing_pool_queries=cfg.routing_pool_queries,
            refresh_every=cfg.routing_refresh_every, beam_h=cfg.beam_h,
            n_hops=cfg.n_hops, k_pos=cfg.k_pos, k_neg=cfg.k_neg,
            use_routing=cfg.use_routing,
            use_neighborhood=cfg.use_neighborhood,
            data_parallel=cfg.data_parallel,
            log_every=max(cfg.steps // 4, 1))
        state = T.fit(qcfg, tcfg, xr, base.graph, seed=cfg.seed,
                      params=Q.init_params(qcfg, codebooks),
                      tombstones=tombstones, draws=draws, verbose=cfg.verbose,
                      device=dev)
        codebooks = state.params.codebooks.detach()
        history = state.history

    new_model = pqbase.QuantizerModel(r=model.r, codebooks=codebooks)
    report["distortion_after"] = float(pqbase.distortion(new_model, x_live))
    report["history"] = history
    return new_model, report
