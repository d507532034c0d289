"""Recsys architecture family: DLRM, DeepFM, DIN, BERT4Rec, and the
retrieval scorers. Port of ``repro/models/recsys.py``.

The shared hot path is the sparse embedding lookup: a gather (one-hot
fields) or a gather plus a segment sum (multi-hot bags). All four models
store their categorical tables as ONE concatenated mega-table with
per-field row offsets (the classic DLRM layout).

``retrieval_cand`` (1 query × 1M candidates) is scored two ways: the exact
dot product (one GEMV) and the paper's ADC scan over PQ-compressed
candidate embeddings (the ``adc_scan`` kernel on the card). Both top-ks
break ties toward the lower index, as ``lax.top_k`` does
(``search.engine.topk_lower``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common import adam, constant_schedule
from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as nn
from repro_torch.models.gnn import segment_sum
from repro_torch.search.engine import topk_lower


# --------------------------------------------------------------------------
# EmbeddingBag substrate
# --------------------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One-hot fields: (rows, D) × (..., F) → (..., F, D)."""
    return table[ids]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, bag_ids: torch.Tensor,
                  n_bags: int, mode: str = "sum") -> torch.Tensor:
    """Multi-hot EmbeddingBag: gather + segment sum.

    ids (T,) row ids, bag_ids (T,) bag assignment → (n_bags, D)."""
    vals = table[ids]
    out = segment_sum(vals, bag_ids.long(), n_bags)
    if mode == "mean":
        cnt = segment_sum(torch.ones((ids.shape[0], 1), dtype=vals.dtype,
                                     device=vals.device), bag_ids.long(), n_bags)
        out = out / torch.clamp(cnt, min=1.0)
    return out


def make_mega_table(generator: torch.Generator, row_counts: Sequence[int], dim: int,
                    dtype=torch.float32, pad_rows_to: int = 512, device=None):
    """Rows padded to a multiple of ``pad_rows_to``; the padding rows are
    unreachable through the per-field offsets. Returns (table, offsets)."""
    total = int(sum(row_counts))
    total = ((total + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
    table = nn.uniform_init(generator, (total, dim), 1.0 / math.sqrt(dim), dtype, device)
    return table, field_offsets(row_counts, device=table.device)


def field_offsets(row_counts: Sequence[int], device=None) -> torch.Tensor:
    """Per-field row offsets into the mega-table, int32 (not a parameter)."""
    off = np.concatenate([[0], np.cumsum(row_counts)[:-1]]).astype(np.int64)
    return torch.from_numpy(off.astype(np.int32)).to(resolve_device(device))


def field_lookup(table: torch.Tensor, offsets: torch.Tensor, ids: torch.Tensor
                 ) -> torch.Tensor:
    """ids (B, F) per-field local ids → (B, F, D) via the mega-table."""
    return embedding_lookup(table, ids + offsets[None, :])


# --------------------------------------------------------------------------
# DLRM (Naumov et al. 2019, MLPerf config)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int
    row_counts: tuple          # 26 tables (Criteo 1TB)
    embed_dim: int
    bot_mlp: tuple
    top_mlp: tuple
    dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.row_counts)


def init_dlrm(generator: torch.Generator, cfg: DLRMConfig, device=None) -> dict:
    table, _ = make_mega_table(generator, cfg.row_counts, cfg.embed_dim, cfg.dtype,
                               device=device)
    n_f = cfg.n_sparse + 1
    n_int = n_f * (n_f - 1) // 2
    return {
        "table": table,
        "bot": nn.mlp_stack(generator, [cfg.n_dense, *cfg.bot_mlp], cfg.dtype, device),
        "top": nn.mlp_stack(generator, [n_int + cfg.bot_mlp[-1], *cfg.top_mlp],
                            cfg.dtype, device),
    }


def dlrm_forward(cfg: DLRMConfig, params: dict, dense: torch.Tensor,
                 sparse: torch.Tensor, *, lookup_fn=field_lookup) -> torch.Tensor:
    """dense (B, 13), sparse (B, 26) int → logits (B,)."""
    offsets = field_offsets(cfg.row_counts, device=sparse.device)
    d = nn.mlp_apply(params["bot"], dense, final_act=True)          # (B, D)
    emb = lookup_fn(params["table"], offsets, sparse)               # (B, 26, D)
    feats = torch.cat([d[:, None, :], emb], dim=1)                  # (B, 27, D)
    inter = torch.einsum("bfd,bgd->bfg", feats, feats)              # (B, 27, 27)
    iu = torch.triu_indices(feats.shape[1], feats.shape[1], 1, device=feats.device)
    flat = inter[:, iu[0], iu[1]]                                   # (B, 351)
    top_in = torch.cat([d, flat], dim=1)
    return nn.mlp_apply(params["top"], top_in)[:, 0]


# --------------------------------------------------------------------------
# DeepFM (Guo et al. 2017)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str
    row_counts: tuple          # 39 fields (Criteo)
    embed_dim: int
    mlp: tuple
    dtype: Any = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.row_counts)


def init_deepfm(generator: torch.Generator, cfg: DeepFMConfig, device=None) -> dict:
    table, _ = make_mega_table(generator, cfg.row_counts, cfg.embed_dim, cfg.dtype,
                               device=device)
    table_lin, _ = make_mega_table(generator, cfg.row_counts, 1, cfg.dtype, device=device)
    return {"table": table, "table_lin": table_lin,
            "deep": nn.mlp_stack(generator, [cfg.n_fields * cfg.embed_dim, *cfg.mlp, 1],
                                 cfg.dtype, device)}


def deepfm_forward(cfg: DeepFMConfig, params: dict, sparse: torch.Tensor,
                   *, lookup_fn=field_lookup) -> torch.Tensor:
    offsets = field_offsets(cfg.row_counts, device=sparse.device)
    emb = lookup_fn(params["table"], offsets, sparse)               # (B, F, D)
    lin = lookup_fn(params["table_lin"], offsets, sparse)[..., 0]
    # FM 2nd order: ½[(Σv)² − Σv²]
    s = torch.sum(emb, dim=1)
    fm2 = 0.5 * torch.sum(s * s - torch.sum(emb * emb, dim=1), dim=-1)
    deep = nn.mlp_apply(params["deep"], emb.reshape(emb.shape[0], -1))[:, 0]
    return torch.sum(lin, dim=1) + fm2 + deep


# --------------------------------------------------------------------------
# DIN (Zhou et al. 2018)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str
    n_items: int
    embed_dim: int
    seq_len: int
    attn_mlp: tuple
    mlp: tuple
    dtype: Any = torch.float32


def init_din(generator: torch.Generator, cfg: DINConfig, device=None) -> dict:
    table, _ = make_mega_table(generator, [cfg.n_items], cfg.embed_dim, cfg.dtype,
                               device=device)
    d = cfg.embed_dim
    return {"table": table,
            "attn": nn.mlp_stack(generator, [4 * d, *cfg.attn_mlp, 1], cfg.dtype, device),
            "mlp": nn.mlp_stack(generator, [3 * d, *cfg.mlp, 1], cfg.dtype, device)}


def din_forward(cfg: DINConfig, params: dict, hist: torch.Tensor, hist_mask: torch.Tensor,
                target: torch.Tensor, *, lookup_fn=None) -> torch.Tensor:
    """hist (B, S) item ids, hist_mask (B, S) bool, target (B,) → logits."""
    table = params["table"]
    he = table[hist]                                     # (B, S, D)
    te = table[target]                                   # (B, D)
    tb = te[:, None, :].expand(he.shape)
    att_in = torch.cat([he, tb, he - tb, he * tb], dim=-1)
    w = nn.mlp_apply(params["attn"], att_in)[..., 0]     # (B, S)
    w = torch.where(hist_mask, w, nn.MASKED)
    w = torch.softmax(w, dim=-1)
    interest = torch.einsum("bs,bsd->bd", w, he)
    out_in = torch.cat([interest, te, interest * te], dim=-1)
    return nn.mlp_apply(params["mlp"], out_in)[:, 0]


# --------------------------------------------------------------------------
# BERT4Rec (Sun et al. 2019)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str
    n_items: int
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    dtype: Any = torch.float32

    @property
    def mask_token(self) -> int:
        return self.n_items  # vocab = n_items + 1 (mask)

    @property
    def vocab_padded(self) -> int:
        """Item vocab (+mask) padded to 256; padded rows are masked out of
        the MLM softmax."""
        return ((self.n_items + 1 + 255) // 256) * 256


_B4R_STACKED = ("wq", "wk", "wv", "wo", "w1", "w2", "ln1", "ln1b", "ln2", "ln2b")


def init_bert4rec(generator: torch.Generator, cfg: Bert4RecConfig, device=None) -> dict:
    d, l = cfg.embed_dim, cfg.n_blocks
    dev = torch.device(device) if device is not None else generator.device
    dense = lambda a, b: nn.dense_init(generator, a, b, cfg.dtype, stacked=l, device=dev)
    const = lambda v: torch.full((l, d), v, dtype=cfg.dtype, device=dev)
    return {
        "item_emb": nn.uniform_init(generator, (cfg.vocab_padded, d), d ** -0.5,
                                    cfg.dtype, dev),
        "pos_emb": nn.uniform_init(generator, (cfg.seq_len, d), 0.02, cfg.dtype, dev),
        "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wo": dense(d, d),
        "w1": dense(d, 4 * d), "w2": dense(4 * d, d),
        "ln1": const(1.0), "ln1b": const(0.0), "ln2": const(1.0), "ln2b": const(0.0),
    }


def _bert4rec_block(cfg: Bert4RecConfig, x, w, pad_mask):
    b, s, d = x.shape
    h = cfg.n_heads
    hn = nn.layernorm(x, w["ln1"], w["ln1b"])
    q = (hn @ w["wq"]).reshape(b, s, h, d // h)
    k = (hn @ w["wk"]).reshape(b, s, h, d // h)
    v = (hn @ w["wv"]).reshape(b, s, h, d // h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d // h)
    scores = torch.where(pad_mask[:, None, None, :], scores, nn.MASKED)
    probs = torch.softmax(scores.float(), -1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
    x = x + o @ w["wo"]
    hn = nn.layernorm(x, w["ln2"], w["ln2b"])
    return x + F.gelu((hn @ w["w1"]).float(), approximate="tanh").to(x.dtype) @ w["w2"]


def bert4rec_encode(cfg: Bert4RecConfig, params: dict, items: torch.Tensor,
                    pad_mask: torch.Tensor) -> torch.Tensor:
    """items (B, S) (mask_token allowed), pad_mask (B, S) → (B, S, D). Each
    block is recomputed in the backward pass (the reference's remat)."""
    s = items.shape[1]
    x = params["item_emb"][items] + params["pos_emb"][None, :s]
    for i in range(cfg.n_blocks):
        w = {k: params[k][i] for k in _B4R_STACKED}
        x = checkpoint(_bert4rec_block, cfg, x, w, pad_mask, use_reentrant=False)
    return x


def bert4rec_mlm_loss(cfg: Bert4RecConfig, params: dict, items, pad_mask,
                      mlm_positions, mlm_labels) -> torch.Tensor:
    """Masked-item prediction: positions (B, P) into the sequence; labels
    (B, P), -1 where a position is not scored."""
    h = bert4rec_encode(cfg, params, items, pad_mask)
    pos = mlm_positions.long()[..., None].expand(-1, -1, h.shape[-1])
    sel = torch.gather(h, 1, pos)                                      # (B, P, D)
    logits = (sel @ params["item_emb"].T).float()
    vocab_iota = torch.arange(cfg.vocab_padded, device=logits.device)
    if cfg.vocab_padded != cfg.n_items + 1:
        logits = torch.where((vocab_iota > cfg.n_items)[None, None, :], nn.MASKED, logits)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.sum(torch.where(vocab_iota[None, None, :] == mlm_labels[..., None],
                                        logits, 0.0), dim=-1)
    valid = mlm_labels >= 0
    nll = torch.where(valid, lse - label_logit, 0.0)
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)


# --------------------------------------------------------------------------
# Retrieval scoring (retrieval_cand shape) — exact and PQ/ADC paths
# --------------------------------------------------------------------------

def score_candidates_exact(query_vec: torch.Tensor, cand_emb: torch.Tensor,
                           k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """(D,) × (N, D) → top-k (scores descending, int32 ids): one GEMV, the
    baseline."""
    full_f32_matmul()
    scores = cand_emb @ query_vec
    neg, ids = topk_lower(-scores[None, :], k)
    return -neg[0], ids[0].to(torch.int32)


def score_candidates_adc(lut: torch.Tensor, cand_codes: torch.Tensor,
                         k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) LUT × (N, M) codes → top-k (distances ascending, int32 ids):
    the one-query ``adc_scan`` kernel on the card."""
    d = kops.adc_scan(cand_codes, lut)
    vals, ids = topk_lower(d[None, :], k)
    return vals[0], ids[0].to(torch.int32)


# --------------------------------------------------------------------------
# Shared training-step factory (BCE point-wise ranking)
# --------------------------------------------------------------------------

def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    z = logits.float()
    return torch.mean(torch.clamp(z, min=0) - z * labels
                      + torch.log1p(torch.exp(-torch.abs(z))))


def make_bce_train_step(forward_fn, init_fn, lr: float = 1e-3):
    """(init_fn, train_step, opt_init); ``train_step(params, opt_state,
    batch)`` with ``batch["label"]`` → (params, opt_state, loss)."""
    optimizer = adam(constant_schedule(lr))

    def train_step(params, opt_state, batch):
        loss, g = nn.value_and_grad(
            lambda p: bce_loss(forward_fn(p, batch), batch["label"]), params)
        params, opt_state = optimizer.update(g, opt_state, params)
        return params, opt_state, loss

    return init_fn, train_step, optimizer.init
