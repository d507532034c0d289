"""The port's Catalyst baseline vs the JAX package, on the CPU: the MLP,
KoLeo and the triplet loss, the gradient against ``jax.grad``, 20 training
steps with the JAX trainer's draws injected, and the serving protocol on a
JAX-trained model carried across with ``repro_torch.convert``. (The JAX
package has no test of its own for Catalyst; these hold each function of
``repro/pq/catalyst.py`` to the port's.)"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.pq import catalyst as jcat
from repro_torch import convert
from repro_torch.pq import catalyst as tcat

N, D, D_HIDDEN, D_OUT, M, K = 1000, 32, 48, 16, 4, 16
STEPS, BATCH = 20, 64


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _data(seed, n=N):
    r = np.random.default_rng(seed)
    centers = r.normal(size=(12, D)) * 2.0
    return (centers[r.integers(0, 12, n)] + r.normal(size=(n, D))).astype(np.float32)


def _net(seed):
    r = np.random.default_rng(seed)
    arrs = [r.uniform(-0.2, 0.2, (D, D_HIDDEN)), r.normal(size=D_HIDDEN) * 0.1,
            r.uniform(-0.2, 0.2, (D_HIDDEN, D_OUT)), r.normal(size=D_OUT) * 0.1]
    arrs = [a.astype(np.float32) for a in arrs]
    return jcat.CatalystParams(*map(jnp.asarray, arrs)), tcat.CatalystParams(*map(T, arrs))


def _batch(seed, dup=False):
    x = _data(seed, 3 * BATCH)
    a, p, n = x[:BATCH], x[BATCH:2 * BATCH], x[2 * BATCH:]
    if dup:                       # duplicate anchors: KoLeo's d2 = 0 case
        a[1::2] = a[::2]
    return a, p, n


def test_forward_koleo_loss_match_jax():
    jnet, tnet = _net(0)
    a, p, n = _batch(1)
    np.testing.assert_allclose(tcat.forward(tnet, T(a)).numpy(),
                               np.asarray(jcat.forward(jnet, jnp.asarray(a))),
                               rtol=1e-6, atol=1e-6)
    y = np.asarray(jcat.forward(jnet, jnp.asarray(a)))
    np.testing.assert_allclose(float(tcat._koleo(T(y))),
                               float(jcat._koleo(jnp.asarray(y))), rtol=1e-6, atol=1e-6)
    want = jcat._loss(jnet, *map(jnp.asarray, (a, p, n)), 0.005)
    got = tcat._loss(tnet, *map(T, (a, p, n)), 0.005)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dup", [False, True])
def test_gradient_matches_jax_grad(dup):
    """Every leaf within 1e-5; with duplicate anchors (a tied KoLeo
    minimum) the gradient is finite and split as JAX splits it."""
    jnet, tnet = _net(2)
    a, p, n = _batch(3, dup=dup)
    want = jax.grad(jcat._loss)(jnet, *map(jnp.asarray, (a, p, n)), 0.005)
    leaves = tcat.CatalystParams(*(t.clone().requires_grad_() for t in tnet))
    got = torch.autograd.grad(tcat._loss(leaves, *map(T, (a, p, n)), 0.005), leaves)
    for name, g, w in zip(tcat.CatalystParams._fields, got, want):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def _jax_draws(key, n, *, m, k, steps, batch, n_neighbors=10):
    """Every draw ``repro.pq.catalyst.train_catalyst`` takes from ``key``."""
    n_sub = min(n, tcat.POSITIVE_ROWS)
    key, knet, kpq = jax.random.split(key, 3)
    net = jcat.init_net(knet, D, D_HIDDEN, D_OUT)
    anchors, slots, negs = [], [], []
    for _ in range(steps):
        key, kk = jax.random.split(key)
        ka, kp, kn = jax.random.split(kk, 3)
        anchors.append(np.asarray(jax.random.randint(ka, (batch,), 0, n_sub)))
        slots.append(np.asarray(jax.random.randint(kp, (batch,), 0, n_neighbors)))
        negs.append(np.asarray(jax.random.randint(kn, (batch,), 0, n_sub)))
    rows = np.stack([np.asarray(jax.random.permutation(kj, n))[:k]
                     for kj in jax.random.split(kpq, m)])
    return tcat.CatalystDraws(tcat.CatalystParams(*(T(p) for p in net)),
                              np.stack(anchors), np.stack(slots), np.stack(negs), rows)


@pytest.fixture(scope="module")
def trained():
    x = _data(4)
    key = jax.random.PRNGKey(5)
    jm = jcat.train_catalyst(key, jnp.asarray(x), M, K, d_out=D_OUT,
                             d_hidden=D_HIDDEN, steps=STEPS, batch=BATCH)
    draws = _jax_draws(key, N, m=M, k=K, steps=STEPS, batch=BATCH)
    tm, losses = tcat.train_catalyst_from_draws(T(x), draws, M, K)
    return x, jm, tm, losses


def test_train_from_jax_draws_matches_jax(trained):
    """20 steps with JAX's draws injected: every parameter within 1e-4;
    then the PQ in the output space from JAX's k-means rows."""
    _, jm, tm, losses = trained
    for name, t, j in zip(tcat.CatalystParams._fields, tm.net, jm.net):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert losses.shape == (STEPS,) and bool(torch.isfinite(losses).all())
    np.testing.assert_array_equal(tm.pq.r.numpy(), np.eye(D_OUT, dtype=np.float32))
    np.testing.assert_allclose(tm.pq.codebooks.numpy(), np.asarray(jm.pq.codebooks),
                               rtol=1e-4, atol=1e-4)


def test_serving_on_converted_jax_model_matches_jax(trained):
    """encode exact; build_lut and adc allclose (f32 sums)."""
    x, jm, _, _ = trained
    tm = convert.catalyst_from_numpy(*(np.asarray(p) for p in jm.net),
                                     np.asarray(jm.pq.r), np.asarray(jm.pq.codebooks),
                                     device="cpu")
    q = _data(6, 50)
    codes = tcat.encode(tm, T(x))
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jcat.encode(jm, jnp.asarray(x))))
    np.testing.assert_allclose(tcat.build_lut(tm, T(q)).numpy(),
                               np.asarray(jcat.build_lut(jm, jnp.asarray(q))),
                               rtol=1e-5, atol=1e-6)
    assert tcat.build_lut(tm, T(q[0])).shape == (1, M, K)
    np.testing.assert_allclose(tcat.adc(tm, codes, T(q)).numpy(),
                               np.asarray(jcat.adc(jm, jnp.asarray(codes.numpy()),
                                                   jnp.asarray(q))),
                               rtol=1e-5, atol=1e-5)


def test_output_width_not_a_multiple_of_m_raises():
    """The reference asserts in train_pq after training (d_out=40, M=16);
    the port refuses before it."""
    with pytest.raises(ValueError, match="d_out=40"):
        tcat.train_catalyst(T(_data(7, 50)), 16, 256, generator=torch.Generator(),
                            d_out=40, steps=1, device="cpu")


def test_train_catalyst_from_a_generator_serves():
    x = T(_data(8, 600))
    model, losses = tcat.train_catalyst(x, M, K, generator=torch.Generator().manual_seed(0),
                                        d_out=D_OUT, d_hidden=D_HIDDEN, steps=5,
                                        batch=32, device="cpu")
    assert losses.shape == (5,) and bool(torch.isfinite(losses).all())
    y = tcat.forward(model.net, x)
    np.testing.assert_allclose(torch.linalg.vector_norm(y, dim=1).numpy(), 1.0, atol=1e-5)
    codes = tcat.encode(model.to("cpu"), x)
    assert codes.shape == (600, M) and int(codes.max()) < K
