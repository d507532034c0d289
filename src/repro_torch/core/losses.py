"""Feature-aware losses + multi-feature joint loss (paper §6, Eq. 8–11).

Port of ``repro/core/losses.py``. All three legs of a triplet and all
candidates of a routing example pass through the differentiable quantizer
(Gumbel straight-through), so the gradient reaches the rotation generator
θ and the codebooks. The joint loss weighs the neighborhood term by a
learned ``α = exp(−s)`` with ``s = params.log_alpha`` and adds ``s``
(homoscedastic-uncertainty weighting): ``L = L_routing + α·L_nbr + s``.

The Gumbel noise of each ``quantize_st`` comes from ``generator``, or is
handed in (``noise=``) in the reference's key order, so a test can inject
JAX's draws: the neighborhood loss takes (anchor, positive, negative)
noise, the routing loss one tensor for its (B·h) candidate rows.

Gathers by id clamp to the last row as JAX's do; rows that carry no weight
(``valid`` False) never reach the loss or its gradient as NaN — the
reference would return NaN there, and only there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import quantizer as Q
from repro_torch.core import rotation as rot
from repro_torch.core.features import RoutingBatch, TripletBatch


class LossReport(NamedTuple):
    total: torch.Tensor
    routing: torch.Tensor
    neighborhood: torch.Tensor
    alpha: torch.Tensor


def _rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] with ids clamped into [0, N), as a JAX gather clamps."""
    return x[torch.clamp(ids.long(), 0, x.shape[0] - 1)]


def _weighted_mean(per: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of ``per`` over the valid rows; invalid rows are selected out
    (a NaN there never reaches the value or the gradient)."""
    total = torch.sum(torch.where(valid, per, torch.zeros_like(per)))
    return total / torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)


def neighborhood_loss(cfg: Q.RPQConfig, params: Q.RPQParams, x: torch.Tensor,
                      batch: TripletBatch, *, margin: float = 1.0,
                      generator: Optional[torch.Generator] = None,
                      noise=None) -> torch.Tensor:
    """Eq. 8: max(0, σ + δ(x′_v, x′_v+) − δ(x′_v, x′_v−)), σ in units of
    the batch's mean positive distance. ``noise``: (anchor, positive,
    negative) Gumbel draws, each (B, M, K)."""
    na, np_, nn = noise if noise is not None else (None, None, None)
    xq_p = Q.quantize_st(cfg, params, _rows(x, batch.vpos), generator=generator,
                         noise=np_)
    xq_n = Q.quantize_st(cfg, params, _rows(x, batch.vneg), generator=generator,
                         noise=nn)
    xq_a = Q.quantize_st(cfg, params, _rows(x, batch.v), generator=generator,
                         noise=na)
    dp = torch.sum((xq_a - xq_p) ** 2, dim=-1)
    dn = torch.sum((xq_a - xq_n) ** 2, dim=-1)
    scale = (torch.mean(dp) + 1e-9).detach()
    per = torch.clamp(margin + (dp - dn) / scale, min=0.0)
    return _weighted_mean(per, batch.valid)


def routing_loss(cfg: Q.RPQConfig, params: Q.RPQParams, x: torch.Tensor,
                 batch: RoutingBatch, *,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 9–10 (sign-fixed): −log softmax_{c ∈ b_i}(−δ(x′_c, x_q)/τ)[v*].
    ``noise``: the (B·h, M, K) Gumbel draws of the candidates."""
    n = x.shape[0]
    b, h = batch.cand.shape
    pad = batch.cand == n
    cv = x[torch.where(pad, 0, batch.cand.long())]
    xq = Q.quantize_st(cfg, params, cv.reshape(b * h, -1), generator=generator,
                       noise=noise).reshape(b, h, -1)
    qrot = rot.rotate(batch.q, Q.rotation_matrix(cfg, params))  # query exact
    d = torch.sum((xq - qrot[:, None, :]) ** 2, dim=-1)            # (B, h)
    with torch.no_grad():  # per-example scale, as the reference's stop_gradient
        dmin = torch.amin(torch.where(pad, float("inf"), d), dim=1, keepdim=True)
        spread = torch.mean(torch.where(pad, 0.0, d - dmin), dim=1,
                            keepdim=True) + 1e-9
    # a row of sentinels only has no finite logit: leave it unmasked, so its
    # (weightless) log-softmax stays finite and sends no NaN back
    pad = pad & ~pad.all(dim=1, keepdim=True)
    logits = torch.where(pad, float("-inf"), -d / (spread * cfg.routing_tau))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, batch.label.long()[:, None])[:, 0]
    return _weighted_mean(nll, batch.valid)


def joint_loss(cfg: Q.RPQConfig, params: Q.RPQParams, x: torch.Tensor,
               trip: TripletBatch, route: RoutingBatch, *, margin: float = 1.0,
               fixed_alpha: Optional[float] = None,
               generator: Optional[torch.Generator] = None,
               noise=None) -> tuple[torch.Tensor, LossReport]:
    """Eq. 11: L = L_routing + α·L_neighborhood (α learned, see module doc).
    ``noise``: (neighborhood triple, routing tensor)."""
    nt, nr = noise if noise is not None else (None, None)
    ln = neighborhood_loss(cfg, params, x, trip, margin=margin,
                           generator=generator, noise=nt)
    lr = routing_loss(cfg, params, x, route, generator=generator, noise=nr)
    if fixed_alpha is not None:
        alpha = torch.tensor(fixed_alpha, dtype=torch.float32, device=ln.device)
        total = lr + alpha * ln
    else:
        s = params.log_alpha
        alpha = torch.exp(-s)
        total = lr + alpha * ln + s
    return total, LossReport(total=total, routing=lr, neighborhood=ln, alpha=alpha)
