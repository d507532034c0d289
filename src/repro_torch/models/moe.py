"""Mixture-of-Experts FFN with GShard-style einsum dispatch. Port of
``repro/models/moe.py``.

Top-k routing with per-group expert capacity. The dispatch and combine
tensors are one-hot over (expert, capacity slot) and contract in products,
as the reference's do. Group size bounds the dispatch tensor: total one-hot
footprint = T × S_group × k × capacity_factor elements.

Priority: choice-rank major (all tokens' 1st choices beat any 2nd choice),
matching GShard; overflow tokens are dropped (their combine weight is 0).
The top-k breaks ties toward the lower expert index, as ``lax.top_k`` does.

Aux loss: Switch-style load balancing  E · Σ_e f_e · p_e.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as nn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    group_size: int = 1024
    aux_coef: float = 0.01


def init_moe(generator: torch.Generator, cfg: MoEConfig, d_model: int, n_layers: int,
             dtype=torch.bfloat16, device=None) -> dict:
    e, f = cfg.n_experts, cfg.d_ff_expert
    return {
        "router": nn.dense_init(generator, d_model, e, torch.float32, stacked=n_layers,
                                device=device),
        "w1": nn.uniform_init(generator, (n_layers, e, d_model, f), d_model ** -0.5,
                              dtype, device),
        "w3": nn.uniform_init(generator, (n_layers, e, d_model, f), d_model ** -0.5,
                              dtype, device),
        "w2": nn.uniform_init(generator, (n_layers, e, f, d_model), f ** -0.5,
                              dtype, device),
    }


def top_k_lower(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, descending, ties to
    the LOWER index: ``lax.top_k``'s order (``graphs.knn.topk_lower``'s on
    the negated values). A stable sort keeps equal values in index order,
    and needs no host sync."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def moe_ffn(x: torch.Tensor, w: dict, cfg: MoEConfig) -> MoEOut:
    """x: (T, D) token slab, w: one layer's weights (unstacked). T must be a
    multiple of the group size ``min(group_size, T)``.

    Returns mixed expert outputs (T, D) + the load-balancing aux loss.
    """
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    s = min(cfg.group_size, t)
    g = t // s
    cap = int(s * k * cfg.capacity_factor / e) + 1

    xg = x.reshape(g, s, d)
    logits = xg.float() @ w["router"]                              # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = top_k_lower(probs.detach(), k)                    # (G, S, k)
    gate_vals = torch.gather(probs, -1, expert_idx)
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)

    # position assignment, choice-rank major: (G, k, S, E) cumsum over (k, S)
    onehot = F.one_hot(expert_idx, e).float()                       # (G, S, k, E)
    oh_rank = onehot.transpose(1, 2).reshape(g, k * s, e)           # rank-major
    pos_rank = torch.cumsum(oh_rank, dim=1) - oh_rank               # excl. cumsum
    pos = (pos_rank.reshape(g, k, s, e).transpose(1, 2) * onehot).sum(-1)  # (G, S, k)
    keep = pos < cap

    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    pos_i = torch.where(keep, pos, float(cap)).long()
    pos_oh = F.one_hot(pos_i, cap + 1)[..., :cap].float()          # slot cap: dropped
    # dispatch (G, S, E, C): sum over the k choices (disjoint slots)
    dispatch = torch.einsum("gske,gskc->gsec", onehot * keep[..., None], pos_oh)
    combine = torch.einsum("gske,gskc->gsec", onehot * gate_vals[..., None], pos_oh)

    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xg)  # (E, G, C, D)
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, w["w1"]).float()).to(x.dtype) \
        * torch.einsum("egcd,edf->egcf", xin, w["w3"])
    yout = torch.einsum("egcf,efd->egcd", h, w["w2"])               # (E, G, C, D)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), yout)

    # Switch aux loss: fraction routed vs mean router prob, per expert
    frac = torch.mean(onehot.sum(2), dim=(0, 1)) / k
    pmean = torch.mean(probs, dim=(0, 1))
    aux = cfg.aux_coef * e * torch.sum(frac * pmean)
    return MoEOut(y=y.reshape(t, d), aux_loss=aux)
