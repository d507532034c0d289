"""Catalyst-style learned baseline (Sablayrolles et al., "Spreading vectors
for similarity search", ICLR'19) — the paper's strongest learned competitor.

Port of ``repro/pq/catalyst.py``: a small MLP f: R^D → R^dout on the unit
sphere, trained with a triplet loss on exact nearest neighbors and the
KoLeo regularizer −1/n Σ log min_j ‖f_i − f_j‖ (gradients by
``torch.autograd``; the reference's Adam, one-cycle schedule and global
norm clip), then plain PQ in the output space. It is graph-agnostic: no PG
neighborhood sampling, no routing features.

The random draws (initial weights, each step's anchor, positive-slot and
negative indices, the PQ k-means' initial rows) come from
:func:`catalyst_draws`; :func:`train_catalyst_from_draws` takes them, so a
test can inject the JAX trainer's.

Serving: a nonlinear encoder cannot export a ``QuantizerModel``, so
:func:`encode`, :func:`build_lut` and :func:`adc` give the engines the
same (codes, lut_fn) protocol as ``pq.base``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common import adam, clip_by_global_norm, one_cycle
from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.graphs.knn import topk_lower
from repro_torch.kernels import ops as kops
from repro_torch.pq import base
from repro_torch.pq.kmeans import kmeans_multi

# Rows of x whose exact kNN give the triplets' positives (and the anchors
# and negatives are drawn from).
POSITIVE_ROWS = 20000
PQ_ITERS = 10


class CatalystParams(NamedTuple):
    w1: torch.Tensor   # (D, d_hidden)
    b1: torch.Tensor   # (d_hidden,)
    w2: torch.Tensor   # (d_hidden, d_out)
    b2: torch.Tensor   # (d_out,)


class CatalystModel(NamedTuple):
    net: CatalystParams
    pq: base.QuantizerModel   # PQ trained in the output space

    def to(self, device) -> "CatalystModel":
        return CatalystModel(CatalystParams(*(t.to(device) for t in self.net)),
                             self.pq.to(device))


@dataclasses.dataclass
class CatalystDraws:
    net: CatalystParams     # initial weights (CPU)
    anchors: np.ndarray     # (steps, batch) rows of the positive set
    pos_slots: np.ndarray   # (steps, batch) which of each anchor's kNN
    negatives: np.ndarray   # (steps, batch) rows of the positive set
    pq_rows: np.ndarray     # (M, K) rows whose outputs start each k-means


def init_net(generator: torch.Generator, d_in: int, d_hidden: int,
             d_out: int) -> CatalystParams:
    """Uniform ±1/√fan_in weights, zero biases, from a CPU ``generator``."""
    def uniform(shape, bound):
        return torch.rand(shape, generator=generator) * (2 * bound) - bound
    return CatalystParams(
        w1=uniform((d_in, d_hidden), 1.0 / np.sqrt(d_in)),
        b1=torch.zeros(d_hidden),
        w2=uniform((d_hidden, d_out), 1.0 / np.sqrt(d_hidden)),
        b2=torch.zeros(d_out))


def forward(net: CatalystParams, x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, d_out) on the unit sphere (+1e-8 in the norm)."""
    h = torch.tanh(x @ net.w1 + net.b1)
    y = h @ net.w2 + net.b2
    return y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-8)


def _koleo(y: torch.Tensor) -> torch.Tensor:
    """−mean ½·log(min_{j≠i} ‖y_i − y_j‖² + 1e-10); the epsilon sits
    inside the log, so duplicate rows stay finite. ``amin`` splits a tied
    minimum's gradient evenly, as JAX's ``min`` does."""
    d2 = ((y[:, None, :] - y[None, :, :]) ** 2).sum(dim=-1)
    d2 = d2 + torch.eye(y.shape[0], device=y.device) * 1e9
    return -torch.mean(0.5 * torch.log(torch.amin(d2, dim=1) + 1e-10))


def _loss(net, anchors, pos, neg, lam, margin=0.1):
    ya, yp, yn = forward(net, anchors), forward(net, pos), forward(net, neg)
    dp = ((ya - yp) ** 2).sum(dim=-1)
    dn = ((ya - yn) ** 2).sum(dim=-1)
    trip = torch.mean(torch.clamp(margin + dp - dn, min=0.0))
    return trip + lam * _koleo(ya)


def catalyst_draws(generator: torch.Generator, n: int, d: int, *, m: int,
                   k: int, d_out: int = 40, d_hidden: int = 128,
                   steps: int = 300, batch: int = 256,
                   n_neighbors: int = 10) -> CatalystDraws:
    """Every draw of a ``train_catalyst`` run over n rows of dimension d,
    from a CPU ``generator``: the initial weights, then each step's anchor,
    positive-slot and negative indices, then per subspace the K rows that
    start its k-means (``train_pq``'s draw)."""
    n_sub = min(n, POSITIVE_ROWS)
    net = init_net(generator, d, d_hidden, d_out)
    draw = lambda hi: torch.randint(0, hi, (steps, batch), generator=generator).numpy()
    anchors, pos_slots, negatives = draw(n_sub), draw(n_neighbors), draw(n_sub)
    pq_rows = np.stack([torch.randperm(n, generator=generator)[:k].numpy()
                        for _ in range(m)])
    return CatalystDraws(net, anchors, pos_slots, negatives, pq_rows)


def _check_width(d_out: int, m: int) -> None:
    if d_out % m:
        raise ValueError(f"d_out={d_out} % M={m} != 0: PQ needs M to divide "
                         f"the output width")


def train_catalyst(x: torch.Tensor, m: int, k: int, *,
                   generator: torch.Generator, d_out: int = 40,
                   d_hidden: int = 128, lam: float = 0.005, steps: int = 300,
                   batch: int = 256, n_neighbors: int = 10,
                   device=None) -> tuple[CatalystModel, torch.Tensor]:
    """Train on x (N, D) on ``device`` (default ``cuda``); paper defaults
    d_out=40, λ=0.005 (§8.1). Returns the model and the (steps,) loss of
    every step."""
    _check_width(d_out, m)
    dev = resolve_device(device)
    draws = catalyst_draws(generator, x.shape[0], x.shape[1], m=m, k=k,
                           d_out=d_out, d_hidden=d_hidden, steps=steps,
                           batch=batch, n_neighbors=n_neighbors)
    return train_catalyst_from_draws(x.to(dev), draws, m, k, lam=lam,
                                     n_neighbors=n_neighbors)


def train_catalyst_from_draws(x: torch.Tensor, draws: CatalystDraws, m: int,
                              k: int, *, lam: float = 0.005,
                              n_neighbors: int = 10
                              ) -> tuple[CatalystModel, torch.Tensor]:
    """The training itself, on x's device, from given draws (see module
    doc); the losses stay on the device (no host sync a step)."""
    d_out = draws.net.w2.shape[1]
    _check_width(d_out, m)
    full_f32_matmul()
    dev = x.device
    x = x.float()
    net = CatalystParams(*(t.to(dev, torch.float32) for t in draws.net))
    sub = x[:min(x.shape[0], POSITIVE_ROWS)]
    sq = (sub * sub).sum(dim=1)
    d2 = (sub @ sub.T).mul_(-2.0).add_(sq[:, None]).add_(sq[None, :])
    d2.diagonal().add_(1e9)
    nbr = topk_lower(d2, n_neighbors)[1]                   # (Ns, n_neighbors)
    del d2

    steps = draws.anchors.shape[0]
    opt = adam(one_cycle(1e-3, steps))
    state = opt.init(net)
    on_dev = lambda a: torch.from_numpy(np.asarray(a)).to(dev).long()
    anchors, slots, negs = (on_dev(draws.anchors), on_dev(draws.pos_slots),
                            on_dev(draws.negatives))
    losses = torch.empty(steps, dtype=torch.float32, device=dev)
    for i in range(steps):
        ai = anchors[i]
        leaves = CatalystParams(*(p.detach().requires_grad_() for p in net))
        loss = _loss(leaves, sub[ai], sub[nbr[ai, slots[i]]], sub[negs[i]], lam)
        grads = CatalystParams(*torch.autograd.grad(loss, leaves))
        grads, _ = clip_by_global_norm(grads, 1.0)
        net, state = opt.update(grads, state, net)
        losses[i] = loss.detach()

    with torch.no_grad():
        y = forward(net, x)
    dsub = d_out // m
    yr = y.reshape(x.shape[0], m, dsub).transpose(0, 1)      # (M, N, dsub)
    rows = on_dev(draws.pq_rows)
    init = yr[torch.arange(m, device=dev)[:, None], rows]    # (M, K, dsub)
    codebooks = kmeans_multi(yr, k, iters=PQ_ITERS, init=init)
    pq = base.QuantizerModel(r=base.identity_rotation(d_out, device=dev),
                             codebooks=codebooks)
    return CatalystModel(net=net, pq=pq), losses


# ---- serving protocol (duck-typed like pq.base) ---------------------------

def encode(model: CatalystModel, x: torch.Tensor) -> torch.Tensor:
    return base.encode(model.pq, forward(model.net, x.float()))


def build_lut(model: CatalystModel, queries: torch.Tensor) -> torch.Tensor:
    return base.build_lut(model.pq,
                          forward(model.net, torch.atleast_2d(queries).float()))


def adc(model: CatalystModel, codes: torch.Tensor,
        queries: torch.Tensor) -> torch.Tensor:
    return kops.adc_scan_batch(codes, build_lut(model, queries))
