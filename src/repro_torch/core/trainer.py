"""Multi-feature joint training module (paper §6 + Fig. 2 pipeline).

Port of ``repro/core/trainer.py`` on one device. The training loop
alternates:
  (1) feature extraction with the CURRENT quantizer — triplets are
      re-sampled every step; routing features need fresh codes and beam
      searches, so they are re-extracted every ``refresh_every`` steps;
  (2) joint-loss Adam steps (one-cycle LR, lr=1e-3 — paper §6), with the
      reference's own Adam (``common.optim``), not ``torch.optim``.

Every random draw of step ``s`` comes from generators seeded by
(seed, s, purpose), the counterpart of JAX's ``fold_in(key, step)``: a run
resumed at step s re-derives the draws of the uninterrupted run.
``data_parallel``, ``compress_grads`` and ``tombstones`` of the reference
wait for later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common import OptState, adam, clip_by_global_norm, one_cycle
from repro_torch.core import features as F
from repro_torch.core import losses as L
from repro_torch.core import quantizer as Q
from repro_torch.device import resolve_device
from repro_torch.graphs.adjacency import Graph
from repro_torch.pq import base as pqbase
from repro_torch.pq.pq import train_pq


@dataclasses.dataclass
class TrainConfig:
    steps: int = 1000
    lr: float = 1e-3                 # paper §6
    triplet_batch: int = 512
    routing_batch: int = 512
    routing_pool_queries: int = 256  # queries per routing-feature refresh
    refresh_every: int = 100
    beam_h: int = 16                 # h candidates per decision (Def. 6)
    n_hops: int = 2                  # Alg. 1 propagation depth
    k_pos: int = 10
    k_neg: int = 30
    margin: float = 1.0
    fixed_alpha: Optional[float] = None
    grad_clip: float = 1.0
    use_routing: bool = True         # ablations: RPQ w/ N only
    use_neighborhood: bool = True    # ablations: RPQ w/ R only
    log_every: int = 50


@dataclasses.dataclass
class TrainState:
    params: Q.RPQParams
    opt_state: OptState
    step: int
    history: list


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``
    (numpy's SeedSequence mixes them, so nearby tuples give unrelated
    streams)."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed >> 1)


# purposes of a step's generators, as the reference's five key splits
POOL, ANCHORS, TRIPLETS, SUBSAMPLE, NOISE = range(5)


def init_rpq(cfg: Q.RPQConfig, x: torch.Tensor, *, generator: torch.Generator,
             kmeans_iters: int = 15) -> Q.RPQParams:
    """K-means-initialized RPQ (R = I: classic PQ is the origin)."""
    model = train_pq(x, cfg.m, cfg.k, generator=generator, iters=kmeans_iters,
                     device=x.device)
    return Q.init_params(cfg, model.codebooks)


def _make_loss_fn(cfg: Q.RPQConfig, tcfg: TrainConfig):
    def loss_fn(params, x, trip, route, generator=None, noise=None):
        nt, nr = noise if noise is not None else (None, None)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        ln = (L.neighborhood_loss(cfg, params, x, trip, margin=tcfg.margin,
                                  generator=generator, noise=nt)
              if tcfg.use_neighborhood else zero)
        lr_ = (L.routing_loss(cfg, params, x, route, generator=generator, noise=nr)
               if tcfg.use_routing else zero)
        if tcfg.fixed_alpha is not None or not (tcfg.use_routing
                                                and tcfg.use_neighborhood):
            alpha = torch.tensor(1.0 if tcfg.fixed_alpha is None else tcfg.fixed_alpha,
                                 dtype=torch.float32, device=x.device)
            total = lr_ + alpha * ln
        else:
            s = params.log_alpha
            alpha = torch.exp(-s)
            total = lr_ + alpha * ln + s
        return total, L.LossReport(total, lr_, ln, alpha)

    return loss_fn


def make_train_step(cfg: Q.RPQConfig, tcfg: TrainConfig, optimizer):
    """Returns step(params, opt_state, x, trip, route, *, generator=None,
    noise=None) → (params, opt_state, report, gnorm). ``noise`` is the
    (neighborhood triple, routing tensor) of Gumbel draws; without it they
    come from ``generator``."""
    loss_fn = _make_loss_fn(cfg, tcfg)

    def step(params, opt_state, x, trip, route, *, generator=None, noise=None):
        p = Q.RPQParams(*(t.detach().requires_grad_() for t in params))
        total, report = loss_fn(p, x, trip, route, generator, noise)
        grads = torch.autograd.grad(total, p, allow_unused=True)
        grads = Q.RPQParams(*(torch.zeros_like(t) if g is None else g
                              for g, t in zip(grads, p)))
        if not cfg.learn_rotation:
            grads = grads._replace(theta=torch.zeros_like(grads.theta))
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, opt_state, params)
        report = L.LossReport(*(t.detach() for t in report))
        return params, opt_state, report, gnorm

    return step


def fit(cfg: Q.RPQConfig, tcfg: TrainConfig, x: torch.Tensor, graph: Graph, *,
        seed: int = 0, params: Optional[Q.RPQParams] = None,
        opt_state: Optional[OptState] = None, start_step: int = 0,
        checkpoint_cb: Optional[Callable] = None, verbose: bool = True,
        device=None) -> TrainState:
    """End-to-end RPQ training (paper Fig. 2) on ``device`` (default
    ``cuda``). Returns the final TrainState.

    ``graph`` must index the rows of ``x`` (graph.n == N): the features
    gather rows by graph id. ``params=`` warm-starts (default: k-means PQ at
    R = I); ``opt_state=`` and ``start_step=`` resume.
    ``checkpoint_cb(step, params, opt_state)`` runs after every step."""
    dev = resolve_device(device)
    x = x.to(dev, torch.float32)
    n = x.shape[0]
    if graph.n != n:
        raise ValueError(f"fit: the graph indexes {graph.n} vertices but x has "
                         f"{n} rows; build the graph over the training rows")
    graph = graph.to(dev)
    if params is None:
        params = init_rpq(cfg, x, generator=seeded_generator("cpu", seed))
    params = Q.RPQParams(*(t.to(dev) for t in params))
    optimizer = adam(one_cycle(tcfg.lr, tcfg.steps))
    if opt_state is None:
        opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, tcfg, optimizer)

    routing_pool: Optional[F.RoutingBatch] = None
    history = []
    t0 = time.time()
    for step in range(start_step, tcfg.steps):
        gens = [seeded_generator(dev, seed, step, purpose) for purpose in range(5)]
        # ---- feature extraction (paper Fig. 2 outer loop) ----
        if tcfg.use_routing and (routing_pool is None
                                 or step % tcfg.refresh_every == 0):
            model = to_model(cfg, params)
            qidx = torch.randperm(n, generator=gens[POOL], device=dev)[
                :tcfg.routing_pool_queries]
            routing_pool = F.sample_routing(
                graph, x, x[qidx], pqbase.encode(model, x),
                lut_fn=lambda q: pqbase.build_lut(model, q), h=tcfg.beam_h)
        anchors = torch.randint(0, n, (tcfg.triplet_batch,),
                                generator=gens[ANCHORS], device=dev)
        trip = F.sample_triplets(graph, x, anchors, n_hops=tcfg.n_hops,
                                 k_pos=tcfg.k_pos, k_neg=tcfg.k_neg,
                                 generator=gens[TRIPLETS])
        if tcfg.use_routing:
            route = F.subsample_routing(routing_pool, tcfg.routing_batch,
                                        generator=gens[SUBSAMPLE])
        else:  # placeholder batch, masked out by use_routing=False
            route = F.RoutingBatch(
                q=torch.zeros((1, x.shape[1]), device=dev),
                cand=torch.zeros((1, tcfg.beam_h), dtype=torch.int64, device=dev),
                label=torch.zeros((1,), dtype=torch.int64, device=dev),
                valid=torch.zeros((1,), dtype=torch.bool, device=dev))
        # ---- joint step ----
        params, opt_state, report, gnorm = step_fn(
            params, opt_state, x, trip, route, generator=gens[NOISE])
        if step % tcfg.log_every == 0:
            rec = {k: float(v) for k, v in report._asdict().items()}
            rec.update(step=step, gnorm=float(gnorm), wall=time.time() - t0)
            history.append(rec)
            if verbose:
                print(f"[rpq] step {step:5d} total {rec['total']:.4f} "
                      f"routing {rec['routing']:.4f} "
                      f"nbr {rec['neighborhood']:.4f} α {rec['alpha']:.3f}")
        if checkpoint_cb is not None:
            checkpoint_cb(step, params, opt_state)
    return TrainState(params=params, opt_state=opt_state, step=tcfg.steps,
                      history=history)


def to_model(cfg: Q.RPQConfig, params: Q.RPQParams) -> pqbase.QuantizerModel:
    """Export the learned quantizer for the serving engines."""
    with torch.no_grad():
        r = Q.rotation_matrix(cfg, params)
    return pqbase.QuantizerModel(r=r, codebooks=params.codebooks.detach())
