"""Graph attention network (GAT, Veličković et al. 2018). Port of
``repro/models/gnn.py``.

Message passing over an edge-index list: edge scores, a softmax over each
destination's incoming edges and a scatter of the messages, through
``scatter_reduce`` (segment max) and ``index_add`` (segment sum). On the
card ``index_add`` sums in atomic order, so its sums match the CPU's to
rounding, not bit for bit.

Shapes covered:
  full_graph_sm / ogb_products  — full-batch: edge list (2, E) + feats (N, F)
  minibatch_lg                  — fanout-sampled blocks (``sample_block``)
  molecule                      — batched small graphs: graph-id pooling
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import adam, constant_schedule
from repro_torch.device import resolve_device
from repro_torch.models import layers as nn


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    d_in: int
    d_hidden: int          # per head
    n_heads: int
    n_layers: int = 2
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: Any = torch.float32


def init_gat(generator: torch.Generator, cfg: GATConfig, device=None) -> dict:
    layers = []
    d_in = cfg.d_in
    for li in range(cfg.n_layers):
        d_out = cfg.d_hidden if li < cfg.n_layers - 1 else cfg.n_classes
        heads = cfg.n_heads if li < cfg.n_layers - 1 else 1
        layers.append({
            "w": nn.dense_init(generator, d_in, heads * d_out, cfg.dtype, device=device),
            "a_src": nn.uniform_init(generator, (heads, d_out), 0.1, cfg.dtype, device),
            "a_dst": nn.uniform_init(generator, (heads, d_out), 0.1, cfg.dtype, device),
        })
        d_in = heads * d_out
    return {"layers": layers}


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``vals`` summed by segment id into (n, ...)."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add(0, seg, vals)


def gat_layer(w: dict, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              n_nodes: int, heads: int, d_out: int, slope: float, edge_mask=None
              ) -> torch.Tensor:
    """One GAT layer. x (N, F); src/dst (E,) (padded edges point at node
    n_nodes-1 with edge_mask False). Returns (N, heads*d_out)."""
    src, dst = src.long(), dst.long()
    h = (x @ w["w"]).reshape(-1, heads, d_out)                   # (N, H, D)
    e_src = torch.sum(h * w["a_src"][None], -1)                   # (N, H)
    e_dst = torch.sum(h * w["a_dst"][None], -1)
    logits = F.leaky_relu(e_src[src] + e_dst[dst], slope)         # (E, H)
    if edge_mask is not None:
        logits = torch.where(edge_mask[:, None], logits, nn.MASKED)
    # segment softmax over incoming edges of each dst; a node with none
    # keeps -inf, replaced by 0
    lmax = torch.full((n_nodes, heads), -torch.inf, dtype=logits.dtype,
                      device=logits.device)
    lmax = lmax.scatter_reduce(0, dst[:, None].expand(-1, heads), logits, "amax",
                               include_self=False)
    lmax = torch.where(torch.isfinite(lmax), lmax, 0.0)
    ex = torch.exp(logits - lmax[dst])
    if edge_mask is not None:
        ex = ex * edge_mask[:, None]
    denom = segment_sum(ex, dst, n_nodes) + 1e-9
    alpha = ex / denom[dst]                                        # (E, H)
    msg = h[src] * alpha[..., None]                                # (E, H, D)
    return segment_sum(msg, dst, n_nodes).reshape(n_nodes, heads * d_out)


def forward(cfg: GATConfig, params: dict, x: torch.Tensor, src: torch.Tensor,
            dst: torch.Tensor, edge_mask=None) -> torch.Tensor:
    n = x.shape[0]
    for li, w in enumerate(params["layers"]):
        last = li == cfg.n_layers - 1
        heads = cfg.n_heads if not last else 1
        d_out = cfg.d_hidden if not last else cfg.n_classes
        x = gat_layer(w, x, src, dst, n, heads, d_out, cfg.negative_slope, edge_mask)
        if not last:
            x = F.elu(x)
    return x                                                       # (N, n_classes)


def node_loss(cfg: GATConfig, params: dict, x, src, dst, labels, label_mask,
              edge_mask=None) -> torch.Tensor:
    logits = forward(cfg, params, x, src, dst, edge_mask)
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    w = label_mask.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def make_train_step(cfg: GATConfig, lr: float = 5e-3):
    """(init, train_step, opt_init); ``init(generator, device=None)``,
    ``train_step(params, opt_state, x, src, dst, labels, label_mask)`` →
    (params, opt_state, loss)."""
    optimizer = adam(constant_schedule(lr))

    def train_step(params, opt_state, x, src, dst, labels, label_mask):
        loss, g = nn.value_and_grad(
            lambda p: node_loss(cfg, p, x, src, dst, labels, label_mask), params)
        params, opt_state = optimizer.update(g, opt_state, params)
        return params, opt_state, loss

    return (lambda generator, device=None: init_gat(generator, cfg, device)), \
        train_step, optimizer.init


# --------------------------------------------------------------------------
# Batched small graphs (molecule shape): graph-level prediction
# --------------------------------------------------------------------------

def graph_pool_loss(cfg: GATConfig, params: dict, x, src, dst, graph_id,
                    n_graphs: int, y, edge_mask=None) -> torch.Tensor:
    """x (B·n, F) stacked node feats; graph_id (B·n,) → mean-pool logits."""
    h = forward(cfg, params, x, src, dst, edge_mask)
    graph_id = graph_id.long()
    pooled = segment_sum(h, graph_id, n_graphs)
    cnt = segment_sum(torch.ones((h.shape[0], 1), dtype=torch.float32, device=h.device),
                      graph_id, n_graphs)
    logits = (pooled / torch.clamp(cnt, min=1.0)).float()
    logp = torch.log_softmax(logits, -1)
    return -torch.mean(torch.gather(logp, 1, y[:, None].long()))


# --------------------------------------------------------------------------
# Neighbor sampler (minibatch_lg): fanout sampling over CSR
# --------------------------------------------------------------------------

class SampledBlock(NamedTuple):
    """Fixed-shape fanout-sampled computation block (2-hop)."""
    feats: torch.Tensor       # (n_all, F) features of all touched nodes
    src: torch.Tensor         # (E_pad,) int32 local ids into feats
    dst: torch.Tensor         # (E_pad,) int32
    edge_mask: torch.Tensor   # (E_pad,) bool
    seed_local: torch.Tensor  # (batch,) int32 local ids of the seed nodes
    labels: torch.Tensor      # (batch,) int32


def sample_block(rng: np.random.Generator, indptr: np.ndarray, indices: np.ndarray,
                 feats: np.ndarray, labels: np.ndarray, seeds: np.ndarray,
                 fanouts: tuple, *, device=None) -> SampledBlock:
    """GraphSAGE-style fanout sampling on the host (numpy, the reference's
    draws), returned as tensors on ``device``.

    The block has batch·f1·f2·2 node slots (more where the touched nodes
    outnumber them) and batch·(f1+f1·f2) edge slots, padded.
    Local ids are ranks in ``np.unique``'s sorted order of the touched
    nodes, as the reference's."""
    dev = resolve_device(device)
    layers = [seeds.astype(np.int64)]
    edges_src, edges_dst = [], []
    frontier = seeds.astype(np.int64)
    for f in fanouts:
        deg = indptr[frontier + 1] - indptr[frontier]
        off = (rng.random((len(frontier), f)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
        nbr = indices[indptr[frontier][:, None] + off]        # (|F|, f)
        nbr[deg == 0] = frontier[deg == 0][:, None]           # isolated: self
        edges_src.append(nbr.reshape(-1))
        edges_dst.append(np.repeat(frontier, f))
        frontier = nbr.reshape(-1)
        layers.append(frontier)
    all_nodes = np.unique(np.concatenate(layers))
    to_local = lambda ids: np.searchsorted(all_nodes, ids)
    src = to_local(np.concatenate(edges_src))
    dst = to_local(np.concatenate(edges_dst))
    # fixed-size padding
    n_slots = len(seeds) * int(np.prod([1] + list(fanouts))) * 2
    e_slots = sum(len(seeds) * int(np.prod(fanouts[:i + 1]))
                  for i in range(len(fanouts)))
    pad_n = max(n_slots - len(all_nodes), 0)
    f_out = np.concatenate([feats[all_nodes],
                            np.zeros((pad_n, feats.shape[1]), feats.dtype)])
    mask = np.ones(e_slots, bool)
    mask[len(src):] = False
    src_p = np.full(e_slots, len(all_nodes) + pad_n - 1, np.int32)
    dst_p = np.full(e_slots, len(all_nodes) + pad_n - 1, np.int32)
    src_p[: len(src)] = src
    dst_p[: len(dst)] = dst
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return SampledBlock(
        feats=t(f_out), src=t(src_p), dst=t(dst_p), edge_mask=t(mask),
        seed_local=t(to_local(seeds.astype(np.int64)).astype(np.int32)),
        labels=t(labels[seeds].astype(np.int32)))
