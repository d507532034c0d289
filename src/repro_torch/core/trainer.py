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
resumed at step s re-derives the draws of the uninterrupted run; a test can
hand in every draw of a step instead (``fit(draws=)``, :class:`StepDraws`).
``fit(tombstones=)`` is the streaming index's codebook-refresh path: anchors
and routing queries come from live vertices only, and the bitset threads
into both samplers.

``TrainConfig(data_parallel=True)`` is the reference's ``shard_map`` step
on one device: the triplet and routing batches split into ``dp_replicas``
row slices, each with its own Gumbel noise and its own backward, each
slice's gradient optionally int8-compressed with its own error-feedback
residual (``compress_grads``, ``dist/compression.py``), then the slices
averaged, clipped and stepped (:func:`make_dp_train_step`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common import OptState, adam, clip_by_global_norm, one_cycle
from repro_torch.common.treeutil import tree_map
from repro_torch.core import features as F
from repro_torch.core import losses as L
from repro_torch.core import quantizer as Q
from repro_torch.device import resolve_device, visible_cuda_devices
from repro_torch.dist import compression as comp
from repro_torch.graphs.adjacency import Graph
from repro_torch.pq import base as pqbase
from repro_torch.pq.pq import train_pq
from repro_torch.search import beam


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
    # distribution: the reference's data-parallel step on one device
    data_parallel: bool = False      # S replicas = S row slices of each batch
    compress_grads: bool = False     # int8 + error feedback before the mean
    dp_replicas: Optional[int] = None  # S; default: the visible CUDA devices


@dataclasses.dataclass
class TrainState:
    params: Q.RPQParams
    opt_state: OptState
    step: int
    history: list
    # data_parallel + compress_grads: each replica's error-feedback residual
    # (leaves (S, ...)) and the last step's per-replica scales (leaves (S,))
    comp_state: Optional[Q.RPQParams] = None
    comp_scales: Optional[Q.RPQParams] = None


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``
    (numpy's SeedSequence mixes them, so nearby tuples give unrelated
    streams)."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed >> 1)


# purposes of a step's generators, as the reference's five key splits
POOL, ANCHORS, TRIPLETS, SUBSAMPLE, NOISE = range(5)


class StepDraws(NamedTuple):
    """Every random draw of one ``fit`` step, for ``fit(draws=)``."""
    pool: Callable          # () → (routing_pool_queries,) positions among the live ids
    anchors: torch.Tensor   # (triplet_batch,) positions among the live ids
    triplets: Callable      # sample_triplets' ``draws``
    subsample: Callable     # n_valid (0-d tensor) → (routing_batch,) indices
    noise: object           # the joint loss's (neighborhood, routing) Gumbel
                            # noise (data_parallel: a sequence of one per
                            # replica), or a torch.Generator to draw it from


def live_ids_of(tombstones, n: int) -> np.ndarray:
    """Ids in [0, n) whose bit is clear in ``tombstones`` (uint32 words, as
    ``index.segment.Tombstones`` keeps them), ascending; all of them when
    there is no bitset."""
    ids = np.arange(n, dtype=np.int64)
    if tombstones is None:
        return ids
    words = np.asarray(tombstones.cpu() if isinstance(tombstones, torch.Tensor)
                       else tombstones).astype(np.uint32)
    dead = ((words[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1).astype(bool)
    return ids[~dead]


def _generator_draws(dev, seed: int, step: int, n_live: int,
                     tcfg: "TrainConfig", sample_pool: bool) -> StepDraws:
    """A step's draws from the generators of (seed, step, purpose): a pool
    permutation (with replacement when fewer live ids than pool queries
    under churn) and uniform anchors, triplets and subsample indices."""
    gens = [seeded_generator(dev, seed, step, purpose) for purpose in range(5)]
    p = tcfg.routing_pool_queries
    if sample_pool and n_live < p:
        pool = lambda: torch.randint(0, n_live, (p,), generator=gens[POOL], device=dev)
    else:
        pool = lambda: torch.randperm(n_live, generator=gens[POOL], device=dev)[:p]
    anchors = torch.randint(0, n_live, (tcfg.triplet_batch,),
                            generator=gens[ANCHORS], device=dev)
    return StepDraws(
        pool=pool, anchors=anchors, triplets=F.uniform_draws(gens[TRIPLETS]),
        subsample=lambda nvalid: F.uniform_draws(gens[SUBSAMPLE])(
            nvalid.expand(tcfg.routing_batch))[0],
        noise=gens[NOISE])


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


def _grads(loss_fn, cfg: Q.RPQConfig, params, x, trip, route, generator, noise):
    """One backward: (gradient tree, detached report); θ's gradient is zero
    when the rotation is frozen."""
    p = Q.RPQParams(*(t.detach().requires_grad_() for t in params))
    total, report = loss_fn(p, x, trip, route, generator, noise)
    grads = torch.autograd.grad(total, p, allow_unused=True)
    grads = Q.RPQParams(*(torch.zeros_like(t) if g is None else g
                          for g, t in zip(grads, p)))
    if not cfg.learn_rotation:
        grads = grads._replace(theta=torch.zeros_like(grads.theta))
    return grads, L.LossReport(*(t.detach() for t in report))


def _update(tcfg: TrainConfig, optimizer, grads, opt_state, params):
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    with torch.no_grad():
        params, opt_state = optimizer.update(grads, opt_state, params)
    return params, opt_state, gnorm


def make_train_step(cfg: Q.RPQConfig, tcfg: TrainConfig, optimizer):
    """Returns step(params, opt_state, x, trip, route, *, generator=None,
    noise=None) → (params, opt_state, report, gnorm). ``noise`` is the
    (neighborhood triple, routing tensor) of Gumbel draws; without it they
    come from ``generator``."""
    loss_fn = _make_loss_fn(cfg, tcfg)

    def step(params, opt_state, x, trip, route, *, generator=None, noise=None):
        grads, report = _grads(loss_fn, cfg, params, x, trip, route, generator,
                               noise)
        params, opt_state, gnorm = _update(tcfg, optimizer, grads, opt_state,
                                           params)
        return params, opt_state, report, gnorm

    return step


def init_dp_comp_state(params, n_dp: int):
    """Per-replica error-feedback residuals: a leading (n_dp,) axis on every
    leaf (each replica keeps its OWN residual — error feedback is local by
    construction)."""
    return tree_map(lambda p: torch.zeros((n_dp,) + tuple(p.shape),
                                          dtype=torch.float32, device=p.device),
                    params)


def _row_slice(batch, r: int, n_dp: int):
    """Replica r's contiguous row slice of every field of a batch."""
    return type(batch)(*(t.reshape((n_dp, -1) + tuple(t.shape[1:]))[r]
                         for t in batch))


def _mean(trees: list):
    """The leafwise mean of same-shaped trees (the reference's ``pmean``)."""
    return tree_map(lambda *ts: torch.stack(ts).mean(dim=0), *trees)


def make_dp_train_step(cfg: Q.RPQConfig, tcfg: TrainConfig, optimizer,
                       n_dp: int, compress: bool = False):
    """The reference's data-parallel step with its ``n_dp`` replicas as row
    slices on one device: replica r takes rows [r·B/n_dp, (r+1)·B/n_dp) of
    the triplet and routing batches, its own Gumbel noise and its own
    backward; with ``compress`` its gradient is int8-quantized with its own
    error-feedback residual; then the replicas' gradients and reports are
    averaged, clipped and stepped, in the reference's order.

    Returns step(params, opt_state, comp_state, x, trip, route, *,
    generator=None, noise=None) → (params, opt_state, comp_state, report,
    gnorm, scales). ``noise`` is a sequence of one (neighborhood triple,
    routing tensor) per replica, else each replica draws from
    ``generator`` in replica order; ``comp_state`` comes from
    :func:`init_dp_comp_state` (``None`` without ``compress``), and
    ``scales`` is the step's per-replica scale tree (``None`` without)."""
    loss_fn = _make_loss_fn(cfg, tcfg)

    def step(params, opt_state, comp_state, x, trip, route, *, generator=None,
             noise=None):
        grads, reports, resid, scales = [], [], [], []
        for r in range(n_dp):
            g, rep = _grads(loss_fn, cfg, params, x, _row_slice(trip, r, n_dp),
                            _row_slice(route, r, n_dp), generator,
                            None if noise is None else noise[r])
            if compress:
                (q, sc), err = comp.compress_tree(
                    g, tree_map(lambda e: e[r], comp_state))
                g = comp.decompress_tree((q, sc))   # ≙ the int8 + scale wire format
                resid.append(err)
                scales.append(sc)
            grads.append(g)
            reports.append(rep)
        if compress:
            comp_state = tree_map(lambda *es: torch.stack(es), *resid)
            scales = tree_map(lambda *ss: torch.stack(ss), *scales)
        params, opt_state, gnorm = _update(tcfg, optimizer, _mean(grads),
                                           opt_state, params)
        return (params, opt_state, comp_state, _mean(reports), gnorm,
                scales if compress else None)

    return step


def fit(cfg: Q.RPQConfig, tcfg: TrainConfig, x: torch.Tensor, graph: Graph, *,
        seed: int = 0, params: Optional[Q.RPQParams] = None,
        opt_state: Optional[OptState] = None, start_step: int = 0,
        checkpoint_cb: Optional[Callable] = None, verbose: bool = True,
        tombstones=None, draws: Optional[Callable] = None,
        device=None) -> TrainState:
    """End-to-end RPQ training (paper Fig. 2) on ``device`` (default
    ``cuda``). Returns the final TrainState.

    ``graph`` must index the rows of ``x`` (graph.n == N): the features
    gather rows by graph id. ``params=`` warm-starts (default: k-means PQ at
    R = I); ``opt_state=`` and ``start_step=`` resume.
    ``checkpoint_cb(step, params, opt_state)`` runs after every step.

    ``tombstones`` (uint32 deleted-id words over [0, N), the streaming
    index's layout) makes the feature loop churn-aware: triplet anchors and
    routing queries are drawn from live vertices only, and the bitset
    threads into both samplers, so no dead id reaches a loss term; every
    vertex dead raises. ``draws(step, n_live) → StepDraws`` replaces the
    step's generator draws (the pool and anchor positions index the live
    ids).

    ``tcfg.data_parallel`` runs :func:`make_dp_train_step` over
    ``tcfg.dp_replicas`` replicas, whose count must divide both batches
    (else ``ValueError``); the final error-feedback residuals and scales
    come back in the TrainState."""
    dev = resolve_device(device)
    x = x.to(dev, torch.float32)
    n = x.shape[0]
    if graph.n != n:
        raise ValueError(f"fit: the graph indexes {graph.n} vertices but x has "
                         f"{n} rows; build the graph over the training rows")
    graph = graph.to(dev)
    live = live_ids_of(tombstones, n)
    if live.size == 0:
        raise ValueError("fit: every vertex is tombstoned — nothing live to "
                         "sample features from")
    live_ids = torch.from_numpy(live).to(dev)
    ts = None if tombstones is None else beam.as_bitset(tombstones, dev)
    if params is None:
        params = init_rpq(cfg, x, generator=seeded_generator("cpu", seed))
    params = Q.RPQParams(*(t.to(dev) for t in params))
    optimizer = adam(one_cycle(tcfg.lr, tcfg.steps))
    if opt_state is None:
        opt_state = optimizer.init(params)
    n_dp, comp_state, comp_scales = 1, None, None
    if tcfg.data_parallel:
        n_dp = tcfg.dp_replicas or visible_cuda_devices()
        if tcfg.triplet_batch % n_dp or tcfg.routing_batch % n_dp:
            raise ValueError(
                f"data_parallel: triplet_batch={tcfg.triplet_batch} and "
                f"routing_batch={tcfg.routing_batch} must divide the "
                f"{n_dp}-way data axis")
        step_fn = make_dp_train_step(cfg, tcfg, optimizer, n_dp,
                                     compress=tcfg.compress_grads)
        if tcfg.compress_grads:
            comp_state = init_dp_comp_state(params, n_dp)
    else:
        step_fn = make_train_step(cfg, tcfg, optimizer)

    routing_pool: Optional[F.RoutingBatch] = None
    history = []
    t0 = time.time()
    for step in range(start_step, tcfg.steps):
        dr = (draws(step, live.size) if draws is not None
              else _generator_draws(dev, seed, step, live.size, tcfg,
                                    tombstones is not None))
        # ---- feature extraction (paper Fig. 2 outer loop) ----
        if tcfg.use_routing and (routing_pool is None
                                 or step % tcfg.refresh_every == 0):
            model = to_model(cfg, params)
            qidx = live_ids[dr.pool().to(dev).long()]
            routing_pool = F.sample_routing(
                graph, x, x[qidx], pqbase.encode(model, x),
                lut_fn=lambda q: pqbase.build_lut(model, q), h=tcfg.beam_h,
                tombstones=ts)
        anchors = live_ids[dr.anchors.to(dev).long()]
        trip = F.sample_triplets(graph, x, anchors, n_hops=tcfg.n_hops,
                                 k_pos=tcfg.k_pos, k_neg=tcfg.k_neg,
                                 draws=dr.triplets, tombstones=ts)
        if tcfg.use_routing:
            idx = dr.subsample(routing_pool.valid.sum())
            route = F.subsample_routing(routing_pool, tcfg.routing_batch,
                                        idx=idx.to(dev))
        else:  # placeholder batch, masked out by use_routing=False; one
            #    row per replica so it slices under data_parallel
            route = F.RoutingBatch(
                q=torch.zeros((n_dp, x.shape[1]), device=dev),
                cand=torch.zeros((n_dp, tcfg.beam_h), dtype=torch.int64, device=dev),
                label=torch.zeros((n_dp,), dtype=torch.int64, device=dev),
                valid=torch.zeros((n_dp,), dtype=torch.bool, device=dev))
        # ---- joint step ----
        gen = dr.noise if isinstance(dr.noise, torch.Generator) else None
        noise = None if gen is not None else dr.noise
        if tcfg.data_parallel:
            params, opt_state, comp_state, report, gnorm, comp_scales = step_fn(
                params, opt_state, comp_state, x, trip, route, generator=gen,
                noise=noise)
        else:
            params, opt_state, report, gnorm = step_fn(
                params, opt_state, x, trip, route, generator=gen, noise=noise)
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
                      history=history, comp_state=comp_state,
                      comp_scales=comp_scales)


def to_model(cfg: Q.RPQConfig, params: Q.RPQParams) -> pqbase.QuantizerModel:
    """Export the learned quantizer for the serving engines."""
    with torch.no_grad():
        r = Q.rotation_matrix(cfg, params)
    return pqbase.QuantizerModel(r=r, codebooks=params.codebooks.detach())
