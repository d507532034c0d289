"""Decoder-only LM family (dense GQA + optional MoE FFN). Port of
``repro/models/transformer.py``.

Covers granite-3-8b, llama3-405b, starcoder2-3b (dense) and
granite-moe-1b-a400m, olmoe-1b-7b (MoE). Models are plain functions of a
config, a param tree of tensors (the reference's keys; layer weights
stacked (L, ...)) and inputs:

* ``forward`` / ``lm_loss`` run the layers one after another; ``remat``
  recomputes each layer (and each block of ``layer_block`` layers) in the
  backward pass through ``torch.utils.checkpoint``, which changes no
  number;
* ``make_train_step`` accumulates gradients over ``microbatches`` in
  ``grad_dtype``, then takes one Adam step with ``opt_slot_dtype`` moments;
* logits and the vocab math run in f32; embeddings are tied unless
  ``tie_embeddings`` is off;
* ``prefill`` and ``decode_step`` share one (L, B, Smax, Hkv, dh) cache,
  written in place (the reference returns new stacked caches; at decode_32k
  widths a second copy of the cache would not fit beside the first).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import adam, constant_schedule
from repro_torch.common.treeutil import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import layers as nn
from repro_torch.models.moe import MoEConfig, init_moe, moe_ffn


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's fields, with torch dtypes.

    On one device five fields have no effect: ``gather_barrier``,
    ``act_batch_axes``, ``act_seq_axis`` and ``unroll_blocks`` place
    arrays on the reference's device mesh, and the layer loop is a Python loop whether
    ``unroll_blocks`` is set or not. ``remat`` and ``layer_block`` trade
    memory for recomputation and change no number. They are kept so that
    configs carry across the two packages unchanged.
    """
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = True
    # training-time knobs
    microbatches: int = 1
    remat: bool = True
    opt_slot_dtype: Any = torch.float32
    grad_dtype: Any = torch.float32
    # flash-style chunked attention (0 = disabled, use full-score path)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    # remat granularity: checkpoint blocks of layer_block layers (and each
    # layer inside a block)
    layer_block: int = 1
    unroll_blocks: bool = False
    gather_barrier: bool = False
    act_batch_axes: Optional[tuple] = None
    act_seq_axis: Optional[str] = None

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256; padded logit columns are masked in
        ``lm_loss``."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def param_count(self) -> int:
        d, f, l, v = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        if self.moe:
            ff = 3 * d * self.moe.d_ff_expert * self.moe.n_experts \
                + d * self.moe.n_experts
        else:
            ff = 3 * d * f
        return l * (attn + ff + 2 * d) + v * d + d

    @property
    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.param_count
        d, l = self.d_model, self.n_layers
        dense = self.param_count - l * 3 * d * self.moe.d_ff_expert * self.moe.n_experts
        return dense + l * 3 * d * self.moe.d_ff_expert * self.moe.top_k


def init_lm(generator: torch.Generator, cfg: LMConfig, device=None) -> dict:
    """The reference's tree: embed, ln_f, attn{wq,wk,wv,wo}, ln1, ln2 and
    mlp{w1,w3,w2} or moe{router,w1,w3,w2} (+ lm_head when untied)."""
    dev = torch.device(device) if device is not None else generator.device
    d, l = cfg.d_model, cfg.n_layers
    hq = cfg.n_heads * cfg.d_head
    hkv = cfg.n_kv_heads * cfg.d_head
    dense = lambda a, b: nn.dense_init(generator, a, b, cfg.dtype, stacked=l, device=dev)
    params = {
        "embed": nn.uniform_init(generator, (cfg.vocab_padded, d), d ** -0.5, cfg.dtype,
                                 dev),
        "ln_f": torch.ones((d,), dtype=cfg.dtype, device=dev),
        "attn": {"wq": dense(d, hq), "wk": dense(d, hkv), "wv": dense(d, hkv),
                 "wo": dense(hq, d)},
        "ln1": torch.ones((l, d), dtype=cfg.dtype, device=dev),
        "ln2": torch.ones((l, d), dtype=cfg.dtype, device=dev),
    }
    if cfg.moe:
        params["moe"] = init_moe(generator, cfg.moe, d, l, cfg.dtype, dev)
    else:
        params["mlp"] = {"w1": dense(d, cfg.d_ff), "w3": dense(d, cfg.d_ff),
                         "w2": dense(cfg.d_ff, d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.dense_init(generator, d, cfg.vocab_padded, cfg.dtype,
                                          device=dev)
    return params


def _layer(params: dict, cfg: LMConfig, i: int) -> dict:
    """Layer ``i``'s weights (views into the stacks)."""
    ffn = params["moe"] if cfg.moe else params["mlp"]
    return {"attn": {k: w[i] for k, w in params["attn"].items()},
            "ln1": params["ln1"][i], "ln2": params["ln2"][i],
            "ffn": {k: w[i] for k, w in ffn.items()}}


def _attend(cfg: LMConfig, q, k, v, *, causal=True, q_offset=0, kv_len=None):
    """Dispatch full-score vs chunked (flash-style) attention."""
    use_chunked = (cfg.attn_kv_chunk > 0
                   and k.shape[1] >= 2 * cfg.attn_kv_chunk
                   and q.shape[1] > 1)
    if use_chunked:
        return nn.chunked_gqa_attention(
            q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk, q_offset=q_offset, kv_len=kv_len)
    return nn.gqa_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)


def _qkv(cfg: LMConfig, h, w, positions):
    b, s, _ = h.shape
    q = (h @ w["attn"]["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (h @ w["attn"]["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (h @ w["attn"]["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return (nn.apply_rope(q, positions, cfg.rope_theta),
            nn.apply_rope(k, positions, cfg.rope_theta), v)


def _ffn(cfg: LMConfig, x, w):
    """x + FFN(rmsnorm(x)); returns (x', aux_loss)."""
    b, s, d = x.shape
    h = nn.rmsnorm(x, w["ln2"])
    if cfg.moe:
        out = moe_ffn(h.reshape(b * s, d), w["ffn"], cfg.moe)
        return x + out.y.reshape(b, s, d), out.aux_loss
    f = w["ffn"]
    return x + nn.swiglu(h, f["w1"], f["w3"], f["w2"]), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def _one_layer(cfg: LMConfig, x, w, positions):
    """x: (B, S, D). Returns (x', aux_loss)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, nn.rmsnorm(x, w["ln1"]), w, positions)
    o = _attend(cfg, q, k, v, causal=True)
    x = x + (o.reshape(b, s, -1) @ w["attn"]["wo"])
    return _ffn(cfg, x, w)


def _head(cfg: LMConfig, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor):
    """tokens (B, S) → logits (B, S, V) f32, aux_loss."""
    b, s = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(s, device=tokens.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(first: int, count: int, x, aux, inner_remat: bool):
        for i in range(first, first + count):
            w = _layer(params, cfg, i)
            if inner_remat:
                x, a = checkpoint(_one_layer, cfg, x, w, positions, use_reentrant=False)
            else:
                x, a = _one_layer(cfg, x, w, positions)
            x, aux = x.to(cfg.dtype), aux + a
        return x, aux

    lb = cfg.layer_block
    if lb > 1 and cfg.n_layers % lb == 0:
        for first in range(0, cfg.n_layers, lb):
            if cfg.remat:   # nested: block boundaries saved, layers recomputed
                x, aux = checkpoint(run, first, lb, x, aux, True, use_reentrant=False)
            else:
                x, aux = run(first, lb, x, aux, False)
    else:
        x, aux = run(0, cfg.n_layers, x, aux, cfg.remat)
    x = nn.rmsnorm(x, params["ln_f"])
    return (x @ _head(cfg, params)).float(), aux


def lm_loss(cfg: LMConfig, params: dict, tokens: torch.Tensor, labels: torch.Tensor):
    logits, aux = forward(cfg, params, tokens)
    if cfg.vocab_padded != cfg.vocab:   # mask the padding columns
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = torch.where(pad[None, None, :], nn.MASKED, logits)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(ll) + aux


class TrainStepFns(NamedTuple):
    init: Any
    train_step: Any
    opt_init: Any


def make_train_step(cfg: LMConfig, lr: float = 3e-4) -> TrainStepFns:
    """(init, train_step, opt_init). ``init(generator, device=None)`` makes
    params; ``train_step(params, opt_state, tokens, labels)`` →
    (params, opt_state, mean loss over the microbatches)."""
    optimizer = adam(constant_schedule(lr), slot_dtype=cfg.opt_slot_dtype)

    def train_step(params, opt_state, tokens, labels):
        mb = cfg.microbatches
        b = tokens.shape[0]
        tok_mb = tokens.reshape(mb, b // mb, -1)
        lab_mb = labels.reshape(mb, b // mb, -1)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.grad_dtype,
                                             device=p.device), params)
        losses = []
        for i in range(mb):
            loss, g = nn.value_and_grad(
                lambda p: lm_loss(cfg, p, tok_mb[i], lab_mb[i]), params)
            acc = tree_map(lambda a, gg: a + gg.to(cfg.grad_dtype) / mb, acc, g)
            losses.append(loss)
        params, opt_state = optimizer.update(acc, opt_state, params)
        return params, opt_state, torch.mean(torch.stack(losses))

    return TrainStepFns(init=lambda generator, device=None: init_lm(generator, cfg, device),
                        train_step=train_step, opt_init=optimizer.init)


# --------------------------------------------------------------------------
# Serving: prefill + decode with KV cache
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor        # (L, B, Smax, Hkv, dh)
    v: torch.Tensor
    length: torch.Tensor   # () int32 — valid prefix


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor, max_len: int):
    """tokens (B, S) → (logits of the last position (B, V) f32, a cache of
    ``max_len`` slots holding the S positions)."""
    b, s = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(s, device=tokens.device)[None, :]
    cache = init_cache(cfg, b, max_len, tokens.device)
    for i in range(cfg.n_layers):
        w = _layer(params, cfg, i)
        q, k, v = _qkv(cfg, nn.rmsnorm(x, w["ln1"]), w, positions)
        o = _attend(cfg, q, k, v, causal=True)
        x = x + (o.reshape(b, s, -1) @ w["attn"]["wo"])
        x = _ffn(cfg, x, w)[0].to(cfg.dtype)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    x = nn.rmsnorm(x[:, -1:], params["ln_f"])
    logits = (x[:, 0] @ _head(cfg, params)).float()
    return logits, cache._replace(length=torch.full((), s, dtype=torch.int32,
                                                    device=tokens.device))


@torch.no_grad()
def decode_step(cfg: LMConfig, params: dict, cache: KVCache, tokens: torch.Tensor):
    """One-token decode. tokens (B,) → (logits (B, V) f32, the cache with
    this token's K and V written at ``cache.length`` in place and the length
    advanced). Attention runs against the whole cache with a valid-length
    mask, as the reference's does."""
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None, :].to(cfg.dtype)          # (B, 1, D)
    pos = cache.length
    at = pos.reshape(1).long()
    for i in range(cfg.n_layers):
        w = _layer(params, cfg, i)
        q, k, v = _qkv(cfg, nn.rmsnorm(x, w["ln1"]), w, pos[None, None])
        kc, vc = cache.k[i], cache.v[i]
        kc.index_copy_(1, at, k)
        vc.index_copy_(1, at, v)
        o = nn.gqa_attention(q, kc, vc, causal=False, q_offset=pos, kv_len=pos + 1)
        x = x + (o.reshape(b, 1, -1) @ w["attn"]["wo"])
        x = _ffn(cfg, x, w)[0].to(cfg.dtype)
    x = nn.rmsnorm(x, params["ln_f"])
    logits = (x[:, 0] @ _head(cfg, params)).float()
    return logits, cache._replace(length=cache.length + 1)
