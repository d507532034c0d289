"""Data-parallel training with int8 gradient compression, port vs the JAX
package, on the CPU.

* ``dist/compression.py``: bit-equal to JAX on seeded trees (an all-zero
  leaf included) over several error-feedback steps, and the identity
  ``dequantize + new_err == g + err``.
* ``fit(data_parallel=True)`` with 4 replicas: JAX runs its ``shard_map``
  step on 4 forced host devices (one subprocess); the port runs the 4
  replicas as row slices on one device with every draw of JAX's replayed
  through ``fit(draws=)`` — the pool, anchors, triplets and subsample from
  the step's key splits, and each replica's Gumbel noise from
  ``fold_in(k5, replica)``. Params within 1e-4 after 3 steps.
* with ``compress_grads``: under the installed jax the reference's step
  does not compress per replica. Inside its ``shard_map`` the gradient
  with respect to the replicated params comes back already summed over
  the replicas (autodiff transposes the implicit replication into a
  ``psum``), so every replica compresses the same SUM and the ``pmean``
  leaves it as it is (its reported ``gnorm`` is S times the mean's). The
  port keeps the reference's written design — each replica's gradient
  compressed with its own residual, then averaged — and is held, over 3
  steps, to that design composed from JAX's own loss, compression, clip
  and Adam on one device, within 1e-4.
* the divisibility ``ValueError``, the error-feedback bound, and
  ``RefreshConfig(data_parallel=True)``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.common import adam as j_adam
from repro.common import clip_by_global_norm as j_clip
from repro.common import one_cycle as j_one_cycle
from repro.core import features as jF
from repro.core import quantizer as jQ
from repro.core import trainer as jT
from repro.dist import compression as jcomp
from repro.graphs.adjacency import Graph as JGraph
from repro.pq import base as jbase
from repro.pq.pq import train_pq as j_train_pq
from repro_torch import convert
from repro_torch.common import adam, one_cycle
from repro_torch.core import features as F
from repro_torch.core import quantizer as Q
from repro_torch.core import trainer as T
from repro_torch.dist import compression as comp
from repro_torch.graphs.vamana import build_vamana
from repro_torch.index import BaseSegment, RefreshConfig, refresh_quantizer
from repro_torch.index.segment import encode_codes
from repro_torch.pq.pq import train_pq

N, D, M, K, S = 300, 16, 4, 16, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T_(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------

def _tree(rng, scale):
    return ((rng.normal(size=(3, 4)) * scale).astype(np.float32),
            (rng.standard_cauchy(size=(17,)) * scale).astype(np.float32),
            np.zeros((2, 2), np.float32),                       # amax = 0
            np.asarray(rng.normal() * scale, np.float32))       # a scalar leaf


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_compression_bit_equal_to_jax_over_error_feedback_steps(scale):
    rng = np.random.default_rng(int(scale * 1000) + 1)
    t_state = comp.init_state(tuple(T_(a) for a in _tree(rng, scale)))
    j_state = jcomp.init_state(tuple(jnp.asarray(a) for a in _tree(rng, scale)))
    for _ in range(4):
        g = _tree(rng, scale)
        tg, jg = tuple(T_(a) for a in g), tuple(jnp.asarray(a) for a in g)
        (tq, ts), t_new = comp.compress_tree(tg, t_state)
        (jq, js), j_new = jcomp.compress_tree(jg, j_state)
        for a, b in zip(tq, jq):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        for a, b in zip(ts + t_new, js + j_new):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        deq = comp.decompress_tree((tq, ts))
        for d_, e_new, gg, e_old in zip(deq, t_new, tg, t_state):
            # the error-feedback identity, and the residual within one step
            torch.testing.assert_close(d_ + e_new, gg + e_old, rtol=0, atol=0)
        for e_new, sc in zip(t_new, ts):
            assert bool((e_new.abs() <= sc / 2 * (1 + 1e-6)).all())
        np.testing.assert_array_equal(_np(tq[2]), 0)
        assert float(ts[2]) == 1.0                                # the amax > 0 guard
        t_state, j_state = t_new, j_new


def test_quantize_leaf_clips_and_rounds_half_to_even():
    g = torch.tensor([127.0, -127.0, 0.5, 1.5, 2.5, -0.5])
    q, scale, err = comp.quantize_leaf(g, torch.zeros_like(g))
    jq, js, je = jcomp.quantize_leaf(jnp.asarray(g.numpy()), jnp.zeros(6))
    assert float(scale) == 1.0
    np.testing.assert_array_equal(q.numpy(), [127, -127, 0, 2, 2, 0])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(je))


# --------------------------------------------------------------------------
# data-parallel fit vs JAX on 4 forced host devices
# --------------------------------------------------------------------------

DP_KW = dict(steps=3, lr=1e-2, triplet_batch=32, routing_batch=32,
             routing_pool_queries=8, refresh_every=2, beam_h=8, log_every=1,
             data_parallel=True)

_DP_SUBPROC = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.core import quantizer as Q
from repro.core import trainer as T
from repro.graphs.adjacency import Graph

assert len(jax.devices()) == 4
z = np.load({path!r})
cfg = Q.RPQConfig(dim={d}, m={m}, k={k})
params = Q.RPQParams(theta=jnp.asarray(z["theta"]), codebooks=jnp.asarray(z["codebooks"]),
                     log_alpha=jnp.asarray(z["log_alpha"]))
graph = Graph(neighbors=jnp.asarray(z["neighbors"]), medoid=jnp.asarray(z["medoid"]))
st = T.fit(jax.random.PRNGKey(7), cfg, T.TrainConfig(**{kw!r}), jnp.asarray(z["x"]),
           graph, params=params, verbose=False)
np.savez({out!r}, theta=np.asarray(st.params.theta),
         codebooks=np.asarray(st.params.codebooks),
         log_alpha=np.asarray(st.params.log_alpha),
         total=np.asarray([h["total"] for h in st.history]),
         gnorm=np.asarray([h["gnorm"] for h in st.history]))
print("DP_OK")
"""


def _jax_dp_draws(key, tcfg, n_dp):
    """``fit(draws=)`` replaying the reference's data-parallel fit: fit
    splits its key into (key, kinit), step s draws from the five splits of
    fold_in(key, s), and replica r's loss from fold_in(k5, r) split into
    (neighborhood (anchor, positive, negative), routing) Gumbel keys."""
    fkey, _ = jax.random.split(key)
    b, rb, p = tcfg.triplet_batch, tcfg.routing_batch, tcfg.routing_pool_queries

    def gumbel(kk, shape):
        return T_(np.asarray(jax.random.gumbel(kk, shape, jnp.float32)))

    def draws(step, n_live):
        k1, k2, k3, k4, k5 = jax.random.split(jax.random.fold_in(fkey, step), 5)
        keys = jax.random.split(k3, b)
        kp, kn = jax.vmap(jax.random.split, out_axes=1)(keys)
        rint = jax.vmap(lambda kk, hi: jax.random.randint(kk, (), 0, hi))

        def triplets(pos_span, neg_span):
            pos = rint(kp, jnp.maximum(jnp.asarray(_np(pos_span), jnp.int32), 1))
            neg = rint(kn, jnp.maximum(jnp.asarray(_np(neg_span), jnp.int32), 1))
            return T_(pos).long(), T_(neg).long()

        noise = []
        for r in range(n_dp):
            kt, kr = jax.random.split(jax.random.fold_in(k5, r))
            noise.append((tuple(gumbel(kk, (b // n_dp, M, K))
                                for kk in jax.random.split(kt, 3)),
                          gumbel(kr, (rb // n_dp * tcfg.beam_h, M, K))))
        return T.StepDraws(
            pool=lambda: T_(np.asarray(jax.random.choice(k1, n_live, (p,), replace=False))),
            anchors=T_(np.asarray(jax.random.randint(k2, (b,), 0, n_live))),
            triplets=triplets,
            subsample=lambda nvalid: T_(np.asarray(jax.random.randint(
                k4, (rb,), 0, max(int(nvalid), 1)))),
            noise=noise)
    return draws


@pytest.fixture(scope="module")
def dp_case():
    r = np.random.default_rng(11)
    centers = r.normal(size=(6, D)) * 2.0
    x = (centers[r.integers(0, 6, N)] + r.normal(size=(N, D))).astype(np.float32)
    graph = build_vamana(T_(x), generator=torch.Generator().manual_seed(1), r=12, l=24,
                         device="cpu")
    cb = np.asarray(j_train_pq(jax.random.PRNGKey(0), jnp.asarray(x), M, K,
                               iters=5).codebooks)
    theta = (r.normal(size=(D * (D - 1) // 2,)) * 0.05).astype(np.float32)
    return dict(x=x, graph=graph, codebooks=cb, theta=theta,
                log_alpha=np.asarray(0.2, np.float32))


def test_dp_fit_4_replicas_within_1e4_of_jax_4_devices(dp_case, tmp_path):
    path, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(path, x=dp_case["x"], neighbors=dp_case["graph"].neighbors.numpy(),
             medoid=np.asarray(int(dp_case["graph"].medoid), np.int32),
             theta=dp_case["theta"], codebooks=dp_case["codebooks"],
             log_alpha=dp_case["log_alpha"])
    code = _DP_SUBPROC.format(path=path, out=out, kw=DP_KW, d=D, m=M, k=K)
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    # the port's side runs while JAX compiles its step
    tcfg = T.TrainConfig(**DP_KW, dp_replicas=S)
    params = convert.rpq_params_from_numpy(dp_case["theta"], dp_case["codebooks"],
                                           dp_case["log_alpha"], device="cpu")
    st = T.fit(Q.RPQConfig(dim=D, m=M, k=K), tcfg, T_(dp_case["x"]), dp_case["graph"],
               params=params, draws=_jax_dp_draws(jax.random.PRNGKey(7), tcfg, S),
               verbose=False, device="cpu")
    stdout, stderr = proc.communicate(timeout=600)
    assert "DP_OK" in stdout, (stdout[-1500:], stderr[-3000:])
    want = np.load(out)
    for name in Q.RPQParams._fields:
        np.testing.assert_allclose(_np(getattr(st.params, name)), want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose([h["total"] for h in st.history], want["total"], rtol=1e-4)
    # the reference's gradient is the replicas' SUM (see the module doc);
    # Adam is blind to the scale, the reported norm is not
    np.testing.assert_allclose([S * h["gnorm"] for h in st.history], want["gnorm"],
                               rtol=1e-4)


@pytest.fixture(scope="module")
def step_case(dp_case):
    """JAX-sampled triplets and a routing pool over the case's graph, and
    RPQ parameters off the identity, for the step-level comparison."""
    x, jx = dp_case["x"], jnp.asarray(dp_case["x"])
    g = dp_case["graph"]
    jgraph = JGraph(jnp.asarray(g.neighbors.numpy()), jnp.asarray(int(g.medoid), jnp.int32))
    cfg = jQ.RPQConfig(dim=D, m=M, k=K)
    jp = jQ.RPQParams(theta=jnp.asarray(dp_case["theta"]),
                      codebooks=jnp.asarray(dp_case["codebooks"]),
                      log_alpha=jnp.asarray(dp_case["log_alpha"]))
    jmodel = jT.to_model(cfg, jp)
    pool = jF.sample_routing(jgraph, jx, jx[:12], jbase.encode(jmodel, jx),
                             lut_fn=lambda q: jbase.build_lut(jmodel, q), h=8,
                             trace_len=12)
    return dict(jx=jx, jgraph=jgraph, cfg=cfg, jp=jp, pool=pool)


def test_dp_step_with_compression_vs_jax_per_replica_composition(dp_case, step_case):
    """3 steps of ``make_dp_train_step(compress=True)`` with 4 replicas
    against the reference's design composed from JAX's own pieces on one
    device: per replica slice, the loss gradient under fold_in(key, r), int8
    compression with that replica's residual; then the mean, the clip and
    Adam. Params, Adam slots, reports, norms and residuals within 1e-4."""
    cfg, jx = step_case["cfg"], step_case["jx"]
    jtc, ttc = jT.TrainConfig(lr=1e-2, steps=20), T.TrainConfig(lr=1e-2, steps=20)
    jopt, topt = j_adam(j_one_cycle(jtc.lr, jtc.steps)), adam(one_cycle(ttc.lr, ttc.steps))
    jgrad = jax.jit(jax.value_and_grad(jT._make_loss_fn(cfg, jtc), has_aux=True))
    tstep = T.make_dp_train_step(Q.RPQConfig(dim=D, m=M, k=K), ttc, topt, S, compress=True)
    jp, tp = step_case["jp"], convert.rpq_params_from_numpy(
        dp_case["theta"], dp_case["codebooks"], dp_case["log_alpha"], device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jres = [jcomp.init_state(jp) for _ in range(S)]
    tres = T.init_dp_comp_state(tp, S)
    b, h = 32, 8
    sl = lambda batch, r: type(batch)(*(a[r * b // S:(r + 1) * b // S] for a in batch))
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        trip = jF.sample_triplets(jax.random.PRNGKey(200 + i), step_case["jgraph"], jx,
                                  jnp.arange(8 * i, 8 * i + b, dtype=jnp.int32),
                                  k_pos=5, k_neg=15)
        route = jF.subsample_routing(jax.random.PRNGKey(300 + i), step_case["pool"], b)
        grads, reps, noise = [], [], []
        for r in range(S):
            kr = jax.random.fold_in(key, r)
            (_, rep), g = jgrad(jp, jx, sl(trip, r), sl(route, r), kr)
            (q, sc), jres[r] = jcomp.compress_tree(g, jres[r])
            grads.append(jcomp.decompress_tree((q, sc)))
            reps.append(rep)
            kt, kk = jax.random.split(kr)
            noise.append((tuple(T_(jax.random.gumbel(k_, (b // S, M, K)))
                                for k_ in jax.random.split(kt, 3)),
                          T_(jax.random.gumbel(kk, (b // S * h, M, K)))))
        g = jax.tree.map(lambda *a: sum(a) / S, *grads)
        g, jn = j_clip(g, jtc.grad_clip)
        jp, js = jopt.update(g, js, jp)
        tp, ts, tres, trep, tn, tsc = tstep(
            tp, ts, tres, T_(dp_case["x"]),
            F.TripletBatch(*(T_(np.asarray(a)).long() if a.dtype != jnp.bool_
                             else T_(np.asarray(a)) for a in trip)),
            F.RoutingBatch(q=T_(route.q), cand=T_(route.cand).long(),
                           label=T_(route.label).long(), valid=T_(route.valid)),
            noise=noise)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-4)
        for name in trep._fields:
            want = np.mean([float(getattr(rp, name)) for rp in reps])
            np.testing.assert_allclose(float(getattr(trep, name)), want, rtol=1e-4,
                                       err_msg=f"step {i} {name}")
    for name, a, bb in zip(Q.RPQParams._fields, tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(bb), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    for r in range(S):
        for name, a, bb in zip(Q.RPQParams._fields, tres, jres[r]):
            np.testing.assert_allclose(_np(a[r]), np.asarray(bb), rtol=1e-4, atol=1e-5,
                                       err_msg=f"residual {r} {name}")
    # every replica's residual within half a quantization step of its leaf
    for err, sc in zip(tres, tsc):
        assert sc.shape == (S,)
        bound = sc.reshape((S,) + (1,) * (err.dim() - 1)) / 2 * (1 + 1e-6)
        assert bool((err.abs() <= bound).all())


def test_dp_fit_divisibility_and_generator_noise(dp_case):
    cfg = Q.RPQConfig(dim=D, m=M, k=K)
    x = T_(dp_case["x"])
    with pytest.raises(ValueError, match="must divide"):
        T.fit(cfg, T.TrainConfig(**dict(DP_KW, triplet_batch=30), dp_replicas=S), x,
              dp_case["graph"], verbose=False, device="cpu")
    with pytest.raises(ValueError, match="3-way data axis"):
        T.fit(cfg, T.TrainConfig(**DP_KW, dp_replicas=3), x, dp_case["graph"],
              verbose=False, device="cpu")
    # per-step generators (no injected draws); the placeholder routing batch
    # has one row per replica under use_routing=False
    for kw in ({"compress_grads": True}, {"use_routing": False, "compress_grads": True},
               {}):
        st = T.fit(cfg, T.TrainConfig(**dict(DP_KW, **kw), dp_replicas=S), x,
                   dp_case["graph"], seed=2, verbose=False, device="cpu")
        assert all(np.isfinite(h["total"]) for h in st.history)
        assert (st.comp_state is None) == (st.comp_scales is None) == (
            "compress_grads" not in kw)


def test_refresh_quantizer_data_parallel_runs(dp_case):
    """``RefreshConfig(data_parallel=True)`` trains through the data-parallel
    step; on a one-device CPU run (one replica) it equals the plain step."""
    x = T_(dp_case["x"])
    model = train_pq(x, M, K, generator=torch.Generator().manual_seed(0), iters=3,
                     device="cpu")
    seg = BaseSegment(graph=dp_case["graph"], codes=encode_codes(model, x, "u8"), vectors=x)
    kw = dict(steps=3, kmeans_iters=1, triplet_batch=32, routing_batch=32,
              routing_pool_queries=8, routing_refresh_every=2, beam_h=8)
    new_dp, rep_dp = refresh_quantizer(seg, model, cfg=RefreshConfig(data_parallel=True, **kw),
                                       device="cpu")
    new, rep = refresh_quantizer(seg, model, cfg=RefreshConfig(**kw), device="cpu")
    torch.testing.assert_close(new_dp.codebooks, new.codebooks, rtol=0, atol=0)
    assert rep_dp["history"] == [dict(h, wall=rep_dp["history"][i]["wall"])
                                 for i, h in enumerate(rep["history"])]
