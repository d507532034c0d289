"""Shared neural-net layers of the architecture zoo. Port of
``repro/models/layers.py``.

Conventions, as the reference's:
* params are nested dicts of tensors; layer-stacked weights carry a leading
  (L, ...) axis, which the models index layer by layer;
* compute dtype is the config's (bf16 at full width), reductions and
  softmax run in f32;
* attention is GQA throughout (n_kv ≤ n_heads); decode takes a KV cache.

Every init draws from a ``torch.Generator`` and builds its tensor on
``device`` (on the ``meta`` device it allocates nothing: the shapes of a
config too large to hold).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.treeutil import tree_leaves, tree_unflatten

MASKED = -1e30   # the reference's mask value (not -inf: an all-masked row stays finite)


def uniform_init(generator: torch.Generator, shape, scale: float,
                 dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """U(-scale, scale) drawn in f32 on the generator's device, stored as
    ``dtype`` on ``device`` (default: the generator's)."""
    device = torch.device(device) if device is not None else generator.device
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u.mul_(2 * scale).sub_(scale).to(device=device, dtype=dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype=torch.bfloat16,
               stacked: int = 0, device=None) -> torch.Tensor:
    shape = (stacked, d_in, d_out) if stacked else (d_in, d_out)
    return uniform_init(generator, shape, 1.0 / math.sqrt(d_in), dtype, device)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in f32, cast back to ``x``'s dtype, then scaled."""
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * gamma


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
               ) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (d/2,)
    ang = positions[..., None].float() * freqs                   # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention (train / prefill / decode)
# --------------------------------------------------------------------------

def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, kv_len) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=kpos.device)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    return mask


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset=0, kv_len=None) -> torch.Tensor:
    """Grouped-query attention over the full score matrix.

    q: (B, Sq, Hq, d), k/v: (B, Skv, Hkv, d) with Hq = G·Hkv.
    q_offset: absolute position of q[0] (decode: cache length; int or 0-d
    tensor). kv_len: optional valid-prefix length of k/v (masks the cache
    tail). Scores come out of the product in q's dtype, as the reference's
    einsum gives them, and the probabilities are cast back to it before the
    PV product. Returns (B, Sq, Hq, d).
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)
    mask = _mask(qpos, torch.arange(skv, device=q.device), causal, kv_len)
    scores = torch.where(mask[None, None, None], scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, hq, d)


def chunked_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool, q_chunk: int = 2048, kv_chunk: int = 1024,
                          q_offset=0, kv_len=None) -> torch.Tensor:
    """Online-softmax (flash-style) GQA attention, chunk by chunk.

    The reference's numerics: q, k and v are rounded to bf16 (whatever
    their dtype), both products multiply those bf16 values in f32, and the
    probabilities are rounded to bf16 before the PV product. The running
    max starts at -inf and masked scores are -1e30, so an all-masked first
    chunk gives a correction of 0, not NaN. Peak score buffer = (B, Hkv,
    G, q_chunk, kv_chunk) f32.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    nq = max(sq // q_chunk, 1)
    q_chunk = sq // nq
    nkv = max(skv // kv_chunk, 1)
    kv_chunk = skv // nkv

    bf = lambda t: t.to(torch.bfloat16).float()
    qg = bf(q).reshape(b, nq, q_chunk, hkv, g, d)
    kc = bf(k).reshape(b, nkv, kv_chunk, hkv, d)
    vc = bf(v).reshape(b, nkv, kv_chunk, hkv, d)
    scale = 1.0 / math.sqrt(d)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi]                                       # (B, qc, Hkv, G, d)
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, hkv, g, q_chunk), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=torch.float32, device=q.device)
        for ki in range(nkv):
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kc[:, ki]) * scale
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = _mask(qpos, kpos, causal, kv_len)
            s = torch.where(mask[None, None, None], s, MASKED)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", bf(p), vc[:, ki])
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B, Hkv, G, qc, d)
        outs.append(out.permute(0, 3, 1, 2, 4))                # (B, qc, Hkv, G, d)
    return torch.cat(outs, dim=1).reshape(b, sq, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor
           ) -> torch.Tensor:
    h = F.silu((x @ w1).float()).to(x.dtype) * (x @ w3)
    return h @ w2


def mlp_stack(generator: torch.Generator, sizes: list, dtype=torch.float32,
              device=None) -> list:
    """Plain MLP params for recsys towers: [{"w", "b"}, ...]."""
    return [{"w": dense_init(generator, sizes[i], sizes[i + 1], dtype, device=device),
             "b": torch.zeros((sizes[i + 1],), dtype=dtype,
                              device=device if device is not None else generator.device)}
            for i in range(len(sizes) - 1)]


def mlp_apply(params: list, x: torch.Tensor, *, final_act: bool = False) -> torch.Tensor:
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def value_and_grad(loss_fn, params):
    """(loss, grads) of ``loss_fn(params)``: each grad in its param's dtype,
    as ``jax.value_and_grad`` gives them; ``params`` are left as they are."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))
