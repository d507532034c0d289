"""The port's layers, MoE FFN and decoder LMs vs the JAX package, on the CPU.

Params are initialised by the reference and carried across with
``repro_torch.convert`` (the port's ``torch.Generator`` cannot reproduce
``jax.random``), so both packages compute the same function on the same
numpy inputs. f32 compares within rtol 1e-5, atol 1e-6 unless a test says
why it needs more. Each JAX function runs once per case, its outputs
shared through module-scoped fixtures (JAX compiles every scan it meets).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as jnn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.common.treeutil import tree_leaves
from repro_torch.configs import get_arch
from repro_torch.models import layers as nn
from repro_torch.models import moe
from repro_torch.models import transformer as tf

LM_ARCHS = ["granite-3-8b", "llama3-405b", "starcoder2-3b", "granite-moe-1b-a400m",
            "olmoe-1b-7b"]
B, S = 4, 16
LR = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_norms_and_rope_vs_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3 + 1
    g = rng.normal(size=(16,)).astype(np.float32)
    bta = rng.normal(size=(16,)).astype(np.float32)
    close(nn.rmsnorm(T(x), T(g)), jnn.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    close(nn.layernorm(T(x), T(g), T(bta)),
          jnn.layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(bta)))
    pos = np.arange(5)[None, :] + 7
    for theta in (10000.0, 500000.0):
        close(nn.apply_rope(T(x), T(pos), theta),
              jnn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), atol=1e-5)


def _qkv(seed, b=2, sq=6, skv=6, hq=4, hkv=2, d=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", ["causal", "offset_kv_len", "groups"])
def test_gqa_attention_vs_jax(case):
    if case == "causal":            # G = 1
        q, k, v = _qkv(1, hq=2, hkv=2)
        kw = dict(causal=True)
    elif case == "offset_kv_len":   # a decode-like query against a cache tail
        q, k, v = _qkv(2, sq=2, skv=10)
        kw = dict(causal=True, q_offset=5, kv_len=7)
    else:                           # G = 4, non-causal with a valid prefix
        q, k, v = _qkv(3, hq=8, hkv=2)
        kw = dict(causal=False, kv_len=4)
    got = nn.gqa_attention(T(q), T(k), T(v), **kw)
    jkw = dict(kw, kv_len=None if "kv_len" not in kw else jnp.asarray(kw["kv_len"]))
    close(got, jnn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))


def _chunked_composition(q, k, v, *, causal, q_chunk, kv_chunk, q_offset=0, kv_len=None):
    """The reference's online softmax written out step by step: bf16-rounded
    inputs, f32 products of them, p rounded to bf16 before the PV product."""
    bf = lambda t: t.to(torch.bfloat16).float()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    out = torch.zeros((b, sq, hkv, g, d))
    for q0 in range(0, sq, q_chunk):
        qb = bf(q[:, q0:q0 + q_chunk]).reshape(b, q_chunk, hkv, g, d)
        m = torch.full((b, hkv, g, q_chunk), -math.inf)
        den = torch.zeros((b, hkv, g, q_chunk))
        acc = torch.zeros((b, hkv, g, q_chunk, d))
        for k0 in range(0, skv, kv_chunk):
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, bf(k[:, k0:k0 + kv_chunk]))
            s = s * (1.0 / math.sqrt(d))
            qpos = torch.arange(q0, q0 + q_chunk) + q_offset
            kpos = torch.arange(k0, k0 + kv_chunk)
            ok = torch.ones((q_chunk, kv_chunk), dtype=torch.bool)
            if causal:
                ok = kpos[None] <= qpos[:, None]
            if kv_len is not None:
                ok = ok & (kpos[None] < kv_len)
            s = torch.where(ok, s, -1e30)
            m2 = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m2[..., None])
            c = torch.exp(m - m2)
            den = den * c + p.sum(-1)
            acc = acc * c[..., None] + torch.einsum("bkgqs,bskd->bkgqd", bf(p),
                                                    bf(v[:, k0:k0 + kv_chunk]))
            m = m2
        out[:, q0:q0 + q_chunk] = (acc / den.clamp(min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, hq, d)


@pytest.mark.parametrize("causal,q_offset,kv_len", [(True, 0, None), (False, 3, 13)])
def test_chunked_attention_vs_jax(causal, q_offset, kv_len):
    """Small chunks (4 × 8 over 16 × 24): against JAX within 2e-2 (both
    round q, k, v and the probabilities to bf16, and a probability on a
    rounding boundary may go either way), and bit for bit against the same
    arithmetic written out step by step."""
    q, k, v = _qkv(4, sq=16, skv=24, hq=6, hkv=2, d=8)
    kw = dict(causal=causal, q_chunk=4, kv_chunk=8, q_offset=q_offset, kv_len=kv_len)
    got = nn.chunked_gqa_attention(T(q), T(k), T(v), **kw)
    jkw = dict(kw, kv_len=None if kv_len is None else jnp.asarray(kv_len))
    want = jnn.chunked_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    close(got, want, rtol=0, atol=2e-2)
    assert torch.equal(got, _chunked_composition(T(q), T(k), T(v), **kw))
    # with one chunk each way it is the full-score attention, to bf16
    full = nn.gqa_attention(T(q), T(k), T(v), causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
    close(got, full.numpy(), rtol=0, atol=3e-2)


def test_swiglu_and_mlp_vs_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, 8)).astype(np.float32)
    w1, w3 = (rng.normal(size=(8, 12)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(size=(12, 8)).astype(np.float32)
    close(nn.swiglu(T(x), T(w1), T(w3), T(w2)),
          jnn.swiglu(*map(jnp.asarray, (x, w1, w3, w2))), atol=1e-5)
    jp = jnn.mlp_stack(jax.random.PRNGKey(1), [8, 16, 4, 1])
    tp = [{k: T(v) for k, v in lyr.items()} for lyr in jax.tree.map(np.asarray, jp)]
    for final in (False, True):
        close(nn.mlp_apply(tp, T(x), final_act=final),
              jnn.mlp_apply(jp, jnp.asarray(x), final_act=final))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _moe_weights(seed, d, e, f):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(size=(d, e)).astype(np.float32),
            "w1": (rng.normal(size=(e, d, f)) * 0.3).astype(np.float32),
            "w3": (rng.normal(size=(e, d, f)) * 0.3).astype(np.float32),
            "w2": (rng.normal(size=(e, f, d)) * 0.3).astype(np.float32)}


@pytest.mark.parametrize("overflow", [False, True])
def test_moe_ffn_vs_jax(overflow):
    """Tie-free router probabilities (continuous random inputs). With
    capacity factor 0.5 over groups of 16 tokens, some tokens overflow
    their expert's capacity and are dropped — the same ones in both."""
    t, d, e, k, f = 48, 8, 4, 2, 16
    cf = 0.5 if overflow else 1.25
    jcfg = jmoe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf,
                          group_size=16)
    tcfg = moe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf,
                         group_size=16)
    w = _moe_weights(7, d, e, f)
    x = np.random.default_rng(8).normal(size=(t, d)).astype(np.float32)
    want = jmoe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, w), jcfg)
    got = moe.moe_ffn(T(x), {k_: T(v) for k_, v in w.items()}, tcfg)
    close(got.y, want.y, atol=1e-5)
    close(got.aux_loss, want.aux_loss)
    # did tokens overflow? count each group's demand against the capacity
    probs = jax.nn.softmax(x.reshape(3, 16, d) @ w["router"], -1)
    idx = np.asarray(jax.lax.top_k(probs, k)[1])
    demand = max(np.bincount(g.reshape(-1), minlength=e).max() for g in idx)
    cap = int(16 * k * cf / e) + 1
    assert (demand > cap) == overflow


def test_moe_top_k_breaks_ties_to_the_lower_index():
    """On heavily tied probabilities the router's top-k picks the experts of
    ``lax.top_k`` and of ``graphs.knn.topk_lower`` (on the negated values)."""
    from repro_torch.graphs.knn import topk_lower

    rng = np.random.default_rng(11)
    probs = (rng.integers(0, 4, (3, 50, 16)) / 4).astype(np.float32)
    got = moe.top_k_lower(T(probs), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.lax.top_k(probs, 5)[1]))
    want = topk_lower(-T(probs).reshape(-1, 16), 5)[1].reshape(3, 50, 5)
    assert torch.equal(got, want)


def test_moe_ffn_matches_dense_oracle():
    """Capacity-unconstrained MoE == per-token dense expert mixing (as
    ``tests/test_archs.py`` holds the reference)."""
    t, d, e, k, f = 32, 8, 4, 2, 16
    cfg = moe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=8.0,
                        group_size=32)
    w = {k_: T(v) for k_, v in _moe_weights(9, d, e, f).items()}
    x = T(np.random.default_rng(10).normal(size=(t, d)).astype(np.float32))
    out = moe.moe_ffn(x, w, cfg)
    probs = torch.softmax(x @ w["router"], -1)
    gv, gi = torch.topk(probs, k)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros((t, d))
    for ti in range(t):
        for kk in range(k):
            ei = int(gi[ti, kk])
            h = torch.nn.functional.silu(x[ti] @ w["w1"][ei]) * (x[ti] @ w["w3"][ei])
            want[ti] += gv[ti, kk] * (h @ w["w2"][ei])
    close(out.y, want.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the LMs, each reduced config against JAX
# --------------------------------------------------------------------------

def _lm_case(arch, **overrides):
    jcfg = dataclasses.replace(jget_arch(arch).make_reduced(), **overrides)
    tcfg = dataclasses.replace(get_arch(arch).make_reduced(), **overrides)
    jp = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tp, toks, labels


@pytest.fixture(scope="module", params=LM_ARCHS)
def lm(request):
    """One reduced LM: JAX's forward, loss, train step, prefill and two
    decode steps, each run once; the port's inputs converted."""
    jcfg, tcfg, jp, tp, toks, labels = _lm_case(request.param)
    jt, jl = jnp.asarray(toks), jnp.asarray(labels)
    out = {"arch": request.param, "jcfg": jcfg, "tcfg": tcfg, "tp": tp,
           "toks": toks, "labels": labels}
    out["fwd"] = jtf.forward(jcfg, jp, jt)
    out["loss"] = jtf.lm_loss(jcfg, jp, jt, jl)
    fns = jtf.make_train_step(jcfg, lr=LR)
    # jitted: op by op, the optimizer's many small updates cost 3× the compile
    out["step"] = jax.jit(fns.train_step)(jp, fns.opt_init(jp), jt, jl)
    logits, cache = jtf.prefill(jcfg, jp, jt[:, :-2], max_len=S + 4)
    dec = [logits]
    for i in (2, 1):
        logits, cache = jtf.decode_step(jcfg, jp, cache, jt[:, -i])
        dec.append(logits)
    out["serve"] = (dec, cache)
    return out


def test_lm_forward_vs_jax(lm):
    logits, aux = tf.forward(lm["tcfg"], lm["tp"], T(lm["toks"]))
    assert logits.dtype == torch.float32
    close(logits, lm["fwd"][0], atol=1e-5)
    close(aux, lm["fwd"][1])
    assert (float(aux) > 0) == (lm["tcfg"].moe is not None)


def test_lm_loss_vs_jax(lm):
    close(tf.lm_loss(lm["tcfg"], lm["tp"], T(lm["toks"]), T(lm["labels"])), lm["loss"])


def test_lm_train_step_vs_jax(lm):
    """One step of gradient accumulation (llama3-405b's reduced config:
    two microbatches, remat) + Adam. Adam's first step moves each param by
    lr·g/(|g| + 1e-8): where |g| is near 1e-8 that ratio turns on the
    gradient's last bits, so params are held within 1e-5 relative where
    |g| ≥ 1e-6 (the gradient read back from JAX's first moment, m = 0.1·g)
    and within the step's own size, 2·lr, elsewhere. The first moments
    are held within 1e-5 relative and 1e-6 of each leaf's largest entry."""
    jparams, jstate, jloss = lm["step"]
    fns = tf.make_train_step(lm["tcfg"], lr=LR)
    tp, ts, tloss = fns.train_step(lm["tp"], fns.opt_init(lm["tp"]), T(lm["toks"]),
                                   T(lm["labels"]))
    close(tloss, jloss)
    assert int(ts.step) == 1
    jm = jax.tree.leaves(jstate.inner[0])
    for a, b in zip(jm, tree_leaves(ts.inner[0])):
        close(b, a, rtol=1e-5, atol=1e-6 * float(np.abs(a).max()))
    for a, b, m in zip(jax.tree.leaves(jparams), tree_leaves(tp), jm):
        a, b, g = np.asarray(a), b.numpy(), np.abs(np.asarray(m)) / 0.1
        sure = g >= 1e-5
        np.testing.assert_allclose(b[sure], a[sure], rtol=1e-5, atol=1e-7)
        assert np.all(np.abs(b - a)[~sure] <= 2 * LR + 1e-6)
        assert sure.mean() > 0.9


def test_lm_prefill_and_decode_vs_jax(lm):
    jdec, jcache = lm["serve"]
    tcfg, tp, toks = lm["tcfg"], lm["tp"], T(lm["toks"])
    logits, cache = tf.prefill(tcfg, tp, toks[:, :-2], max_len=S + 4)
    got = [logits]
    for i in (2, 1):
        logits, cache = tf.decode_step(tcfg, tp, cache, toks[:, -i])
        got.append(logits)
    for a, b in zip(jdec, got):
        assert b.shape == (B, tcfg.vocab_padded)
        close(b, a, atol=1e-5)
    assert int(cache.length) == int(jcache.length) == S
    close(cache.k, jcache.k, atol=1e-5)
    close(cache.v, jcache.v, atol=1e-5)


def test_lm_chunked_attention_path_vs_jax():
    """kv chunks of 8 over S = 16 take the flash-style path (bf16 q, k, v
    and probabilities) in forward and prefill: held within 2e-2 of JAX."""
    jcfg, tcfg, jp, tp, toks, _ = _lm_case("granite-3-8b", attn_q_chunk=8,
                                           attn_kv_chunk=8)
    jt = jnp.asarray(toks)
    close(tf.forward(tcfg, tp, T(toks))[0], jtf.forward(jcfg, jp, jt)[0], rtol=0, atol=2e-2)
    close(tf.prefill(tcfg, tp, T(toks), max_len=S)[0],
          jtf.prefill(jcfg, jp, jt, max_len=S)[0], rtol=0, atol=2e-2)


@pytest.mark.parametrize("arch", ["granite-3-8b", "olmoe-1b-7b"])
def test_decode_equals_forward_last_position(arch):
    """On the port alone: prefill S-1 tokens, decode the last; its logits
    are forward's last position's. Forward, prefill and decode route
    different token groups, so for the MoE the capacity factor is raised to
    n_experts / top_k, where no expert can overflow and routing is per
    token."""
    over = {}
    if arch == "olmoe-1b-7b":
        m = get_arch(arch).make_reduced().moe
        over["moe"] = dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)
    tcfg = dataclasses.replace(get_arch(arch).make_reduced(), **over)
    _, _, _, tp, toks, _ = _lm_case(arch)
    full, _ = tf.forward(tcfg, tp, T(toks))
    _, cache = tf.prefill(tcfg, tp, T(toks[:, :-1]), max_len=S + 1)
    dec, _ = tf.decode_step(tcfg, tp, cache, T(toks[:, -1]))
    close(dec, full[:, -1].numpy(), rtol=1e-4, atol=1e-5)


def test_remat_and_layer_block_change_no_number():
    """llama3-405b's reduced stack (3 layers) with remat per layer and with
    nested remat over blocks of 3: the loss and every gradient equal the
    plain run's bit for bit."""
    _, tcfg, _, tp, toks, labels = _lm_case("llama3-405b")
    runs = []
    for remat, lb in ((False, 1), (True, 1), (True, 3)):
        cfg = dataclasses.replace(tcfg, remat=remat, layer_block=lb)
        runs.append(nn.value_and_grad(
            lambda p: tf.lm_loss(cfg, p, T(toks), T(labels)), tp))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(grads)):
            assert torch.equal(a, b)
