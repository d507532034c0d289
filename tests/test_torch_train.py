"""Port RPQ training vs the JAX package, on the CPU: rotation, the
differentiable quantizer, the ``pq_pairwise`` gradient, features, losses,
Adam + one-cycle, the train step and ``fit`` — plus the retrieval scorers.

Every comparison feeds the same numpy inputs (made from a seed) to both
packages. JAX's threefry draws cannot be reproduced in PyTorch, so the
tests regenerate them with the reference's own key splits and inject them:
the Gumbel noise (``trainer._make_loss_fn`` → ``losses`` → ``quantize_st``),
the triplet ``randint``s, ``subsample_routing``'s indices and the routing
pool's query ids. Off the TPU the reference differentiates the
``pq_pairwise`` oracle, so its gradients are the yardstick of the port's
backward.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.common import adam as j_adam
from repro.common import clip_by_global_norm as j_clip
from repro.common import one_cycle as j_one_cycle
from repro.core import features as jF
from repro.core import losses as jL
from repro.core import quantizer as jQ
from repro.core import rotation as jrot
from repro.core import trainer as jT
from repro.graphs import build_vamana as j_build_vamana
from repro.kernels import ref as jref
from repro.models import recsys as jrecsys
from repro.pq import base as jbase
from repro.pq.pq import train_pq as j_train_pq
from repro_torch import convert
from repro_torch.common import adam, clip_by_global_norm, one_cycle
from repro_torch.core import features as F
from repro_torch.core import losses as L
from repro_torch.core import quantizer as Q
from repro_torch.core import rotation as rot
from repro_torch.core import trainer as T
from repro_torch.core.rpq import train_rpq
from repro_torch.data import load_dataset as t_load
from repro_torch.graphs.vamana import build_vamana as t_build_vamana
from repro_torch.kernels import ops as tops
from repro_torch.models import recsys
from repro_torch.pq import base as tbase
from repro_torch.search import beam as tbeam
from repro.search import beam as jbeam

N, D, M, K = 300, 16, 4, 16


def T_(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _gumbel(key, shape):
    return np.asarray(jax.random.gumbel(key, shape, jnp.float32))


def _to_port(params) -> Q.RPQParams:
    return convert.rpq_params_from_numpy(*(np.asarray(p) for p in params),
                                         device="cpu")


def _trip_to_port(t) -> F.TripletBatch:
    return F.TripletBatch(*(T_(np.asarray(a)).long() if a.dtype != jnp.bool_
                            else T_(np.asarray(a)) for a in t))


def _route_to_port(rb) -> F.RoutingBatch:
    return F.RoutingBatch(q=T_(rb.q), cand=T_(rb.cand).long(),
                          label=T_(rb.label).long(), valid=T_(rb.valid))


@pytest.fixture(scope="module")
def S():
    """A small clustered set, a JAX Vamana graph over it, RPQ parameters off
    the identity (random θ) and JAX-sampled triplet and routing batches."""
    r = np.random.default_rng(11)
    centers = r.normal(size=(6, D)) * 2.0
    x = (centers[r.integers(0, 6, N)] + r.normal(size=(N, D))).astype(np.float32)
    jx = jnp.asarray(x)
    jgraph = j_build_vamana(jax.random.PRNGKey(1), jx, r=12, l=24)
    tgraph = convert.graph_from_numpy(np.asarray(jgraph.neighbors),
                                      np.asarray(jgraph.medoid), device="cpu")
    cfg = jQ.RPQConfig(dim=D, m=M, k=K)
    tcfg = Q.RPQConfig(dim=D, m=M, k=K)
    cb = j_train_pq(jax.random.PRNGKey(0), jx, M, K, iters=5).codebooks
    jparams = jQ.RPQParams(
        theta=jnp.asarray(r.normal(size=(D * (D - 1) // 2,)) * 0.05, jnp.float32),
        codebooks=jnp.asarray(cb, jnp.float32),
        log_alpha=jnp.asarray(0.2, jnp.float32))
    trip = jF.sample_triplets(jax.random.PRNGKey(2), jgraph, jx,
                              jnp.arange(40, dtype=jnp.int32), k_pos=5, k_neg=15)
    jmodel = jT.to_model(cfg, jparams)
    codes = jbase.encode(jmodel, jx)
    pool = jF.sample_routing(jgraph, jx, jx[:12], codes,
                             lut_fn=lambda q: jbase.build_lut(jmodel, q),
                             h=8, trace_len=12)
    route = jF.subsample_routing(jax.random.PRNGKey(3), pool, 32)
    return dict(x=x, jx=jx, jgraph=jgraph, tgraph=tgraph, cfg=cfg, tcfg=tcfg,
                jparams=jparams, tparams=_to_port(jparams), trip=trip,
                route=route, pool=pool)


def _req(params: Q.RPQParams) -> Q.RPQParams:
    return Q.RPQParams(*(t.detach().clone().requires_grad_() for t in params))


def _assert_grads(tparams_req, jgrads, *, rtol, atol):
    for name, tp, jg in zip(Q.RPQParams._fields, tparams_req, jgrads):
        assert tp.grad is not None, name
        np.testing.assert_allclose(_np(tp.grad), np.asarray(jg), rtol=rtol,
                                   atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# rotation, pq_pairwise backward, quantizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [8, 16])
def test_rotation_and_its_gradient_vs_jax(dim):
    rng = np.random.default_rng(dim)
    theta = (rng.normal(size=(dim * (dim - 1) // 2,)) * 0.3).astype(np.float32)
    w = rng.normal(size=(dim, dim)).astype(np.float32)
    want_r = np.asarray(jrot.rotation_from_params(jnp.asarray(theta), dim))
    want_g = np.asarray(jax.grad(lambda t: jnp.sum(
        jrot.rotation_from_params(t, dim) * w))(jnp.asarray(theta)))
    t = T_(theta).requires_grad_()
    r = rot.rotation_from_params(t, dim)
    (r * T_(w)).sum().backward()
    np.testing.assert_allclose(_np(r), want_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(t.grad), want_g, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(rot.skew_from_params(T_(theta), dim)),
                                  np.asarray(jrot.skew_from_params(jnp.asarray(theta), dim)))
    x = rng.normal(size=(5, dim)).astype(np.float32)
    np.testing.assert_allclose(_np(rot.rotate(T_(x), r)),
                               np.asarray(jrot.rotate(jnp.asarray(x), jnp.asarray(want_r))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(37, 4, 16, 4), (200, 8, 64, 8)])
def test_pq_pairwise_backward_vs_jax_grad(shape):
    """The port's explicit backward against autodiff of the JAX oracle
    (the reference has no backward kernel)."""
    n, m, k, dsub = shape
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, m, dsub)).astype(np.float32)
    c = rng.normal(size=(m, k, dsub)).astype(np.float32)
    g = rng.normal(size=(n, m, k)).astype(np.float32)
    out, vjp = jax.vjp(jref.pq_pairwise_ref, jnp.asarray(x), jnp.asarray(c))
    want_gx, want_gc = vjp(jnp.asarray(g))
    tx, tc = T_(x).requires_grad_(), T_(c).requires_grad_()
    got = tops.pq_pairwise(tx, tc)
    assert got.grad_fn is not None
    got.backward(T_(g))
    np.testing.assert_allclose(_np(got), np.asarray(out), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(want_gx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(tc.grad), np.asarray(want_gc), rtol=1e-5, atol=1e-4)


def test_pq_pairwise_without_grad_carries_no_graph():
    x, c = torch.randn(5, 2, 3), torch.randn(2, 4, 3)
    assert tops.pq_pairwise(x, c).grad_fn is None
    assert tops.pq_pairwise(x, c.requires_grad_()).grad_fn is not None


@pytest.mark.parametrize("straight_through", [True, False])
def test_quantizer_forward_vs_jax_with_injected_noise(S, straight_through):
    cfg = S["cfg"]._replace(straight_through=straight_through)
    tcfg = S["tcfg"]._replace(straight_through=straight_through)
    jp, tp = S["jparams"], S["tparams"]
    x = S["x"][:50]
    jx, tx = jnp.asarray(x), T_(x)
    key = jax.random.PRNGKey(5)
    noise = _gumbel(key, (50, M, K))
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(Q.subspace_distances(tcfg, tp, tx)),
                               np.asarray(jQ.subspace_distances(cfg, jp, jx)), **close)
    np.testing.assert_allclose(_np(Q.soft_assign(tcfg, tp, tx)),
                               np.asarray(jQ.soft_assign(cfg, jp, jx)), **close)
    want_y = np.asarray(jQ.gumbel_codes(cfg, jp, jx, key))
    got_y = _np(Q.gumbel_codes(tcfg, tp, tx, noise=T_(noise)))
    want_xq = np.asarray(jQ.quantize_st(cfg, jp, jx, key))
    got_xq = _np(Q.quantize_st(tcfg, tp, tx, noise=T_(noise)))
    if straight_through:  # the exact one-hot and its codewords
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_xq, want_xq)
    else:
        np.testing.assert_allclose(got_y, want_y, **close)
        np.testing.assert_allclose(got_xq, want_xq, **close)


def test_quantizer_inference_paths_vs_jax(S):
    cfg, tcfg, jp, tp = S["cfg"], S["tcfg"], S["jparams"], S["tparams"]
    jx, tx = S["jx"], T_(S["x"])
    codes = Q.encode(tcfg, tp, tx)
    jcodes = jQ.encode(cfg, jp, jx)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(_np(codes), np.asarray(jcodes))
    np.testing.assert_array_equal(_np(Q.decode(tcfg, tp, codes)),
                                  np.asarray(jQ.decode(cfg, jp, jcodes)))
    q = S["x"][:7] + 0.5
    np.testing.assert_allclose(_np(Q.build_lut(tcfg, tp, T_(q))),
                               np.asarray(jQ.build_lut(cfg, jp, jnp.asarray(q))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(Q.adc_distances(tcfg, tp, codes, T_(q))),
                               np.asarray(jQ.adc_distances(cfg, jp, jcodes, jnp.asarray(q))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(Q.reconstruction_mse(tcfg, tp, tx)),
                               float(jQ.reconstruction_mse(cfg, jp, jx)), rtol=1e-5)
    np.testing.assert_allclose(_np(Q.rotation_matrix(tcfg._replace(learn_rotation=False), tp)),
                               np.eye(D))


def test_quantize_st_gradient_vs_jax(S):
    cfg, tcfg, jp = S["cfg"], S["tcfg"], S["jparams"]
    x = S["x"][:40]
    key = jax.random.PRNGKey(8)
    w = np.random.default_rng(8).normal(size=(40, D)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jQ.quantize_st(cfg, p, jnp.asarray(x), key) * w))(jp)
    tp = _req(S["tparams"])
    (Q.quantize_st(tcfg, tp, T_(x), noise=T_(_gumbel(key, (40, M, K)))) * T_(w)).sum().backward()
    assert tp.log_alpha.grad is None  # not on this path
    for name, t, g in (("theta", tp.theta, jg.theta), ("codebooks", tp.codebooks, jg.codebooks)):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _nbr_noise(key, b):
    ka, kp, kn = jax.random.split(key, 3)
    return tuple(T_(_gumbel(k, (b, M, K))) for k in (ka, kp, kn))


def test_neighborhood_loss_and_gradients_vs_jax(S):
    cfg, tcfg, jp = S["cfg"], S["tcfg"], S["jparams"]
    key = jax.random.PRNGKey(21)
    b = S["trip"].v.shape[0]
    fn = lambda p: jL.neighborhood_loss(cfg, p, S["jx"], S["trip"], key)
    want, jg = jax.value_and_grad(fn)(jp)
    tp = _req(S["tparams"])
    got = L.neighborhood_loss(tcfg, tp, T_(S["x"]), _trip_to_port(S["trip"]),
                              noise=_nbr_noise(key, b))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    assert tp.log_alpha.grad is None
    for name in ("theta", "codebooks"):
        np.testing.assert_allclose(_np(getattr(tp, name).grad),
                                   np.asarray(getattr(jg, name)), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_routing_loss_and_gradients_vs_jax(S):
    cfg, tcfg, jp = S["cfg"], S["tcfg"], S["jparams"]
    key = jax.random.PRNGKey(22)
    b, h = S["route"].cand.shape
    fn = lambda p: jL.routing_loss(cfg, p, S["jx"], S["route"], key)
    want, jg = jax.value_and_grad(fn)(jp)
    tp = _req(S["tparams"])
    got = L.routing_loss(tcfg, tp, T_(S["x"]), _route_to_port(S["route"]),
                         noise=T_(_gumbel(key, (b * h, M, K))))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for name in ("theta", "codebooks"):
        np.testing.assert_allclose(_np(getattr(tp, name).grad),
                                   np.asarray(getattr(jg, name)), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("fixed_alpha", [None, 0.5])
def test_joint_loss_and_gradients_vs_jax(S, fixed_alpha):
    cfg, tcfg, jp = S["cfg"], S["tcfg"], S["jparams"]
    key = jax.random.PRNGKey(23)
    kt, kr = jax.random.split(key)
    b, h = S["route"].cand.shape
    fn = lambda p: jL.joint_loss(cfg, p, S["jx"], S["trip"], S["route"], key,
                                 fixed_alpha=fixed_alpha)
    (want, jrep), jg = jax.value_and_grad(fn, has_aux=True)(jp)
    tp = _req(S["tparams"])
    noise = (_nbr_noise(kt, S["trip"].v.shape[0]), T_(_gumbel(kr, (b * h, M, K))))
    got, rep = L.joint_loss(tcfg, tp, T_(S["x"]), _trip_to_port(S["trip"]),
                            _route_to_port(S["route"]), fixed_alpha=fixed_alpha,
                            noise=noise)
    got.backward()
    for name in L.LossReport._fields:
        np.testing.assert_allclose(getattr(rep, name).item(), float(getattr(jrep, name)),
                                   rtol=1e-4, err_msg=name)
    if fixed_alpha is not None:
        assert tp.log_alpha.grad is None
        tp = tp._replace(log_alpha=torch.zeros((), requires_grad=True))
        tp.log_alpha.grad = torch.zeros(())
    _assert_grads(tp, jg, rtol=1e-4, atol=1e-5)


def test_routing_loss_gradients_finite_on_invalid_rows(S):
    """A weightless row of sentinels only, and one with a single candidate,
    leave the loss and every gradient finite; the loss is that of the valid
    rows alone (compared without the adaptive temperature, whose batch mean
    would see the other rows)."""
    tcfg = S["tcfg"]._replace(adaptive_temp=False)
    rb = _route_to_port(S["route"])
    good = rb.valid.clone()
    cand, valid = rb.cand.clone(), rb.valid.clone()
    cand[0] = N                      # no candidate at all
    cand[1, 1:] = N                  # one candidate
    valid[:2] = False
    label = rb.label.clone()
    label[:2] = 0
    bad = F.RoutingBatch(rb.q, cand, label, valid)
    b, h = cand.shape
    noise = torch.from_numpy(np.random.default_rng(0).gumbel(
        size=(b * h, M, K)).astype(np.float32))
    tp = _req(S["tparams"])
    loss = L.routing_loss(tcfg, tp, T_(S["x"]), bad, noise=noise)
    loss.backward()
    assert bool(torch.isfinite(loss))
    for name, t in zip(Q.RPQParams._fields[:2], tp[:2]):
        assert bool(torch.isfinite(t.grad).all()), name
    keep = valid & good
    ref = L.routing_loss(tcfg, S["tparams"], T_(S["x"]),
                         F.RoutingBatch(rb.q[keep], rb.cand[keep], rb.label[keep],
                                        rb.valid[keep]),
                         noise=noise.reshape(b, h, M, K)[keep].reshape(-1, M, K))
    torch.testing.assert_close(loss.detach(), ref, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def test_one_cycle_schedule_vs_jax():
    jsched, tsched = j_one_cycle(1e-3, 37), one_cycle(1e-3, 37)
    for step in range(0, 40):
        np.testing.assert_allclose(float(tsched(torch.tensor(step, dtype=torch.int32))),
                                   float(jsched(jnp.int32(step))), rtol=1e-6)


def test_adam_one_cycle_clip_five_steps_vs_jax():
    rng = np.random.default_rng(4)
    shapes = jQ.RPQParams(theta=(28,), codebooks=(2, 4, 3), log_alpha=())
    p0 = jQ.RPQParams(*(rng.normal(size=s).astype(np.float32) for s in shapes))
    grads = [jQ.RPQParams(*(rng.normal(size=s).astype(np.float32) * 3 for s in shapes))
             for _ in range(5)]
    jopt, topt = j_adam(j_one_cycle(1e-2, 12)), adam(one_cycle(1e-2, 12))
    jp = jQ.RPQParams(*(jnp.asarray(a) for a in p0))
    tp = convert.rpq_params_from_numpy(*p0, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jg, jn = j_clip(jQ.RPQParams(*(jnp.asarray(a) for a in g)), 1.0)
        tg, tn = clip_by_global_norm(convert.rpq_params_from_numpy(*g, device="cpu"), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
    assert int(ts.step) == int(js.step) == 5
    for name, a, b in zip(jQ.RPQParams._fields, tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for slot in range(2):
        for a, b in zip(ts.inner[slot], js.inner[slot]):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------

def _tie_free_codes(rng, n):
    codes = rng.integers(0, K, (n, M)).astype(np.uint8)
    while np.unique(codes, axis=0).shape[0] != n:  # pragma: no cover
        codes = rng.integers(0, K, (n, M)).astype(np.uint8)
    return codes


@pytest.mark.parametrize("trace_len,expand", [(6, 1), (64, 1), (16, 3)])
def test_beam_search_trace_vs_jax(S, trace_len, expand):
    """Tie-free codes: every recorded beam, hop_valid and the counters
    equal JAX's; trace_len 6 is shorter than the searches (later rounds
    must keep the last slot)."""
    rng = np.random.default_rng(trace_len)
    codes_p = np.concatenate([_tie_free_codes(rng, N), np.zeros((1, M), np.uint8)])
    luts = (rng.random((9, M, K)) * 5).astype(np.float32)
    g = S["jgraph"]
    jt = jbeam.beam_search_trace(g.neighbors, g.medoid, jnp.asarray(luts),
                                 jbeam.make_adc_dist_fn(jnp.asarray(codes_p)),
                                 h=10, max_steps=40, trace_len=trace_len, expand=expand)
    tt = tbeam.beam_search_trace(S["tgraph"].neighbors, S["tgraph"].medoid, T_(luts),
                                 tbeam.make_adc_dist_fn(T_(codes_p)), h=10,
                                 max_steps=40, trace_len=trace_len, expand=expand)
    assert int(np.asarray(jt.result.rounds).max()) > 6
    np.testing.assert_array_equal(_np(tt.beam_ids), np.asarray(jt.beam_ids))
    np.testing.assert_array_equal(_np(tt.hop_valid), np.asarray(jt.hop_valid))
    np.testing.assert_allclose(_np(tt.beam_dists), np.asarray(jt.beam_dists),
                               rtol=1e-6)
    for name in ("ids", "hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(_np(getattr(tt.result, name)),
                                      np.asarray(getattr(jt.result, name)), err_msg=name)


def _jax_triplet_draws(key, b):
    """``draws`` that replays the reference's per-anchor randints: one key
    per anchor, split into (positive, negative)."""
    keys = jax.random.split(key, b)
    kp, kn = jax.vmap(jax.random.split, out_axes=1)(keys)
    rint = jax.vmap(lambda k, hi: jax.random.randint(k, (), 0, hi))

    def draws(pos_span, neg_span):
        pos = rint(kp, jnp.maximum(jnp.asarray(_np(pos_span), jnp.int32), 1))
        neg = rint(kn, jnp.maximum(jnp.asarray(_np(neg_span), jnp.int32), 1))
        return T_(pos).long(), T_(neg).long()
    return draws


@pytest.mark.parametrize("n_hops,k_pos,k_neg", [(2, 5, 15), (1, 3, 6), (2, 10, 30)])
def test_sample_triplets_vs_jax_with_injected_draws(S, n_hops, k_pos, k_neg):
    key = jax.random.PRNGKey(31 + n_hops)
    anchors = np.random.default_rng(k_neg).integers(0, N, 48).astype(np.int32)
    jt = jF.sample_triplets(key, S["jgraph"], S["jx"], jnp.asarray(anchors),
                            n_hops=n_hops, k_pos=k_pos, k_neg=k_neg)
    tt = F.sample_triplets(S["tgraph"], T_(S["x"]), T_(anchors), n_hops=n_hops,
                           k_pos=k_pos, k_neg=k_neg,
                           draws=_jax_triplet_draws(key, anchors.shape[0]))
    for name in F.TripletBatch._fields:
        np.testing.assert_array_equal(_np(getattr(tt, name)),
                                      np.asarray(getattr(jt, name)), err_msg=name)


def test_sample_triplets_chunked_equals_whole(S, monkeypatch):
    anchors = torch.arange(0, N, 3)
    draws = F.uniform_draws(torch.Generator().manual_seed(0))
    whole = F.sample_triplets(S["tgraph"], T_(S["x"]), anchors,
                              draws=F.uniform_draws(torch.Generator().manual_seed(0)))
    monkeypatch.setattr(F, "TRIPLET_CHUNK_BYTES", 7 * (12 + 144) * D * 4)
    chunked = F.sample_triplets(S["tgraph"], T_(S["x"]), anchors, draws=draws)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sample_routing_and_subsample_vs_jax(S):
    """Injected routing-pool query ids (``jax.random.choice``) and
    subsample indices; tie-free codes and identical LUTs on both sides."""
    rng = np.random.default_rng(5)
    codes = _tie_free_codes(rng, N)
    qidx = np.asarray(jax.random.choice(jax.random.PRNGKey(6), N, (10,), replace=False))
    q = S["x"][qidx]
    luts = (rng.random((10, M, K)) * 5).astype(np.float32)
    jb = jF.sample_routing(S["jgraph"], S["jx"], jnp.asarray(q), jnp.asarray(codes),
                           lut_fn=lambda _: jnp.asarray(luts), h=8, trace_len=10)
    tb = F.sample_routing(S["tgraph"], T_(S["x"]), T_(q), T_(codes),
                          lut_fn=lambda _: T_(luts), h=8, trace_len=10)
    np.testing.assert_array_equal(_np(tb.q), np.asarray(jb.q))
    for name in ("cand", "label", "valid"):
        np.testing.assert_array_equal(_np(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)), err_msg=name)
    assert 0 < int(np.asarray(jb.valid).sum()) < jb.valid.shape[0]
    key = jax.random.PRNGKey(7)
    nvalid = int(np.asarray(jb.valid).sum())
    idx = np.asarray(jax.random.randint(key, (24,), 0, max(nvalid, 1)))
    js = jF.subsample_routing(key, jb, 24)
    ts = F.subsample_routing(tb, 24, idx=T_(idx))
    for name in F.RoutingBatch._fields:
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name)), err_msg=name)


def test_subsample_routing_with_no_valid_rows_flags_all_invalid(S):
    rb = _route_to_port(S["route"])
    none = rb._replace(valid=torch.zeros_like(rb.valid))
    out = F.subsample_routing(none, 5, generator=torch.Generator().manual_seed(0))
    assert out.cand.shape == (5, rb.cand.shape[1]) and not bool(out.valid.any())


# --------------------------------------------------------------------------
# train step, fit
# --------------------------------------------------------------------------

def _step_noise(key, nt, nr_rows):
    kt, kr = jax.random.split(key)
    return (_nbr_noise(kt, nt), T_(_gumbel(kr, (nr_rows, M, K))))


def test_five_train_steps_vs_jax(S):
    """5 ``make_train_step`` steps on JAX-sampled batches with the step's
    Gumbel noise injected: params, Adam slots and reports within 1e-4."""
    cfg, tcfg_q = S["cfg"], S["tcfg"]
    jtc = jT.TrainConfig(steps=20, lr=1e-2)
    ttc = T.TrainConfig(steps=20, lr=1e-2)
    jopt, topt = j_adam(j_one_cycle(jtc.lr, jtc.steps)), adam(one_cycle(ttc.lr, ttc.steps))
    jstep = jT.make_train_step(cfg, jtc, jopt)
    tstep = T.make_train_step(tcfg_q, ttc, topt)
    jp, tp = S["jparams"], S["tparams"]
    js, ts = jopt.init(jp), topt.init(tp)
    b, h = S["route"].cand.shape
    for i in range(5):
        key = jax.random.PRNGKey(100 + i)
        trip = jF.sample_triplets(jax.random.PRNGKey(200 + i), S["jgraph"], S["jx"],
                                  jnp.arange(8 * i, 8 * i + 32, dtype=jnp.int32),
                                  k_pos=5, k_neg=15)
        route = jF.subsample_routing(jax.random.PRNGKey(300 + i), S["pool"], b)
        jp, js, jrep, jn = jstep(jp, js, S["jx"], trip, route, key)
        tp, ts, trep, tn = tstep(tp, ts, T_(S["x"]), _trip_to_port(trip),
                                 _route_to_port(route),
                                 noise=_step_noise(key, 32, b * h))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-4)
        for name in L.LossReport._fields:
            np.testing.assert_allclose(float(getattr(trep, name)),
                                       float(getattr(jrep, name)), rtol=1e-4,
                                       err_msg=f"step {i} {name}")
    for name, a, bb in zip(Q.RPQParams._fields, tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(bb), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    for slot in range(2):
        for a, bb in zip(ts.inner[slot], js.inner[slot]):
            np.testing.assert_allclose(_np(a), np.asarray(bb), rtol=1e-3, atol=1e-8)
    # the reference's state carries over to the port
    carried = convert.opt_state_from_numpy(js.step, *(tuple(np.asarray(a) for a in slot)
                                                      for slot in js.inner), device="cpu")
    assert int(carried.step) == 5 and carried.inner[0].codebooks.shape == (M, K, D // M)


def _small_fit_cfg(steps, **kw):
    return T.TrainConfig(steps=steps, refresh_every=5, triplet_batch=32,
                         routing_batch=32, routing_pool_queries=8, log_every=1,
                         **kw)


def test_fit_resume_re_derives_the_same_steps(S):
    """Steps 0–9 in one run equal steps 0–4, then a resume at step 5 from
    the state after step 4 (per-step generators seeded by (seed, step))."""
    x = T_(S["x"])
    tcfg = _small_fit_cfg(10)
    saved = {}

    def keep(step, params, opt_state):
        if step == 4:
            saved["p"], saved["o"] = params, opt_state

    full = T.fit(S["tcfg"], tcfg, x, S["tgraph"], seed=3, params=S["tparams"],
                 checkpoint_cb=keep, verbose=False, device="cpu")
    resumed = T.fit(S["tcfg"], tcfg, x, S["tgraph"], seed=3, params=saved["p"],
                    opt_state=saved["o"], start_step=5, verbose=False, device="cpu")
    assert int(resumed.opt_state.step) == int(full.opt_state.step) == 10
    for a, b in zip(full.params, resumed.params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert full.history[5:] == [dict(h, wall=full.history[5 + i]["wall"])
                                for i, h in enumerate(resumed.history)]


def test_fit_refuses_a_graph_over_other_rows(S):
    with pytest.raises(ValueError, match="training rows"):
        T.fit(S["tcfg"], _small_fit_cfg(2), T_(S["x"][:200]), S["tgraph"],
              params=S["tparams"], verbose=False, device="cpu")


def test_fit_ablations_run(S):
    for kw in ({"use_routing": False}, {"use_neighborhood": False},
               {"fixed_alpha": 0.5}):
        st = T.fit(S["tcfg"], _small_fit_cfg(3, **kw), T_(S["x"]), S["tgraph"],
                   params=S["tparams"], verbose=False, device="cpu")
        assert np.isfinite(st.history[-1]["total"])


def test_port_fit_on_unit_test_lowers_the_joint_loss():
    """The port's own ``fit`` (``train_rpq``) on ``unit-test``, as
    tests/test_rpq_core.py trains the reference: the joint loss on a fixed
    batch and noise falls, and the exported rotation is orthonormal."""
    ds = t_load("unit-test", device="cpu")
    graph = t_build_vamana(ds.base, generator=torch.Generator().manual_seed(0),
                           r=16, l=32, device="cpu")
    cfg = Q.RPQConfig(dim=ds.base.shape[1], m=4, k=32)
    tcfg = T.TrainConfig(steps=80, lr=1e-2, refresh_every=20, triplet_batch=128,
                         routing_batch=128, routing_pool_queries=32, log_every=10)
    params0 = T.init_rpq(cfg, ds.base, generator=torch.Generator().manual_seed(0),
                         kmeans_iters=5)
    rpq = train_rpq(ds.base, graph, seed=0, cfg=cfg, tcfg=tcfg, verbose=False,
                    device="cpu")
    gen = torch.Generator().manual_seed(9)
    model0 = T.to_model(cfg, params0)
    pool = F.sample_routing(graph, ds.base, ds.base[:64], tbase.encode(model0, ds.base),
                            lut_fn=lambda q: tbase.build_lut(model0, q), h=16)
    trip = F.sample_triplets(graph, ds.base, torch.arange(0, 2000, 4), generator=gen)
    route = F.subsample_routing(pool, 512, generator=gen)
    b, h = route.cand.shape
    noise = ((tuple(Q.gumbel_noise((trip.v.shape[0], 4, 32), generator=gen, device="cpu")
                    for _ in range(3))),
             Q.gumbel_noise((b * h, 4, 32), generator=gen, device="cpu"))
    before, _ = L.joint_loss(cfg, params0, ds.base, trip, route, noise=noise)
    after, _ = L.joint_loss(cfg, rpq.params, ds.base, trip, route, noise=noise)
    assert float(after) < float(before)
    assert all(np.isfinite(h_["total"]) and np.isfinite(h_["gnorm"]) for h_ in rpq.history)
    r = rpq.model.r
    torch.testing.assert_close(r @ r.T, torch.eye(r.shape[0]), rtol=0, atol=1e-4)
    codes = rpq.encode(ds.base)
    assert codes.shape == (2000, 4) and rpq.lut_fn()(ds.queries).shape == (100, 4, 32)


# --------------------------------------------------------------------------
# retrieval scorers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 100])
def test_score_candidates_vs_jax(k):
    rng = np.random.default_rng(k)
    emb = rng.normal(size=(3000, 24)).astype(np.float32)
    qv = rng.normal(size=(24,)).astype(np.float32)
    codes = rng.integers(0, 64, (3000, 8)).astype(np.uint8)
    codes[1500:1600] = codes[:100]           # equal codes: ties by index
    lut = (rng.random((8, 64)) * 4).astype(np.float32)
    jv, ji = jrecsys.score_candidates_exact(jnp.asarray(qv), jnp.asarray(emb), k=k)
    tv, ti = recsys.score_candidates_exact(T_(qv), T_(emb), k=k)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5, atol=1e-5)
    jv, ji = jrecsys.score_candidates_adc(jnp.asarray(lut), jnp.asarray(codes), k=k,
                                          backend="ref")
    tv, ti = recsys.score_candidates_adc(T_(lut), T_(codes), k=k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-6)
