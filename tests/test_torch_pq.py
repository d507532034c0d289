"""Port data + quantizers vs the JAX package, on the CPU: bit-identical
datasets, k-means from an injected init, encode / build_lut / adc / decode
on a quantizer carried across with ``repro_torch.convert``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.data import load_dataset as j_load
from repro.pq import base as jbase
from repro.pq.kmeans import kmeans_multi as j_kmeans_multi
from repro.pq import pq as jpq
from repro.pq.pq import train_pq as j_train_pq
from repro.pq.pq import train_pq_fs4 as j_train_pq_fs4
from repro_torch import convert
from repro_torch.data import SPECS, load_dataset as t_load
from repro_torch.pq import base as tbase
from repro_torch.pq.kmeans import kmeans as t_kmeans
from repro_torch.pq.kmeans import kmeans_multi as t_kmeans_multi
from repro_torch.pq import pq as tpq
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.pq.pq import train_pq as t_train_pq
from repro_torch.pq.pq import train_pq_fs4 as t_train_pq_fs4


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


@pytest.fixture(scope="module")
def ds():
    return j_load("unit-test"), t_load("unit-test", device="cpu")


@pytest.fixture(scope="module")
def models(ds):
    jds, _ = ds
    jm = j_train_pq(jax.random.PRNGKey(1), jds.train, 8, 32, iters=6)
    tm = convert.quantizer_from_numpy(np.asarray(jm.r),
                                      np.asarray(jm.codebooks), device="cpu")
    return jm, tm


def test_load_dataset_bit_identical(ds):
    jds, tds = ds
    for name in ("base", "queries", "train"):
        a, b = np.asarray(getattr(jds, name)), getattr(tds, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tds.dim == jds.dim == SPECS["unit-test"].dim


def test_kmeans_multi_injected_init_matches_jax():
    # well-separated clusters, so near-tie flips between the two summation
    # orders cannot move a point; rtol 1e-4 covers segment_sum vs index_add_
    rng = np.random.default_rng(11)
    m, n, d, k = 3, 600, 4, 12
    centers = rng.normal(size=(m, k, d)).astype(np.float32) * 6.0
    x = (centers[np.arange(m)[:, None], rng.integers(0, k, (m, n))]
         + 0.3 * rng.normal(size=(m, n, d))).astype(np.float32)
    init = x[:, rng.permutation(n)[:k]].copy()
    want = j_kmeans_multi(jax.random.PRNGKey(0), jnp.asarray(x), k, iters=8,
                          block=256, init=jnp.asarray(init))
    got = t_kmeans_multi(T(x), k, iters=8, block=256, init=T(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_kmeans_reseeds_empty_clusters_like_jax():
    """Duplicate init centroids leave clusters empty; both re-seed them at
    the same worst-quantized points."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(1, 200, 3)).astype(np.float32)
    init = np.repeat(x[:, :2], 4, axis=1)                  # (1, 8, 3) dups
    want = j_kmeans_multi(jax.random.PRNGKey(0), jnp.asarray(x), 8, iters=1,
                          init=jnp.asarray(init))
    got = t_kmeans_multi(T(x), 8, iters=1, init=T(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_kmeans_single_space_from_generator():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 6))
                         .astype(np.float32))
    cent, idx = t_kmeans(x, 10, generator=torch.Generator().manual_seed(0),
                         iters=5)
    assert cent.shape == (10, 6) and idx.shape == (300,)
    assert idx.dtype == torch.int32 and int(idx.max()) < 10
    d_own = ((x - cent[idx.long()]) ** 2).sum(1)
    d_all = ((x[:, None] - cent[None]) ** 2).sum(-1).min(1).values
    np.testing.assert_allclose(d_own.numpy(), d_all.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_encode_matches_jax(ds, models, monkeypatch):
    monkeypatch.setattr(tbase, "ENCODE_CHUNK", 333)           # ragged chunks
    jds, tds = ds
    jm, tm = models
    want = np.asarray(jbase.encode(jm, jds.base))
    got = tbase.encode(tm, tds.base)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    same_rows = np.mean(np.all(got.numpy() == want, axis=1))
    assert same_rows >= 0.999


def test_build_lut_and_adc_match_jax(ds, models):
    # rtol 1e-5 / atol 1e-4: x² − 2x·c + c² reduced in another order
    jds, tds = ds
    jm, tm = models
    want = np.asarray(jbase.build_lut(jm, jds.queries))
    got = tbase.build_lut(tm, tds.queries)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    codes = np.asarray(jbase.encode(jm, jds.base))
    want_adc = np.asarray(jbase.adc(jm, codes, jds.queries[:7]))
    got_adc = tbase.adc(tm, T(codes), tds.queries[:7])
    np.testing.assert_allclose(got_adc.numpy(), want_adc, rtol=1e-5,
                               atol=1e-3)


def test_decode_and_distortion_match_jax(ds, models):
    jds, tds = ds
    jm, tm = models
    codes = np.asarray(jbase.encode(jm, jds.base))
    np.testing.assert_allclose(tbase.decode(tm, T(codes)).numpy(),
                               np.asarray(jbase.decode(jm, codes)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tbase.distortion(tm, tds.base)),
                               float(jbase.distortion(jm, jds.base)),
                               rtol=1e-3)


def test_train_pq_on_cpu_is_a_working_quantizer(ds):
    _, tds = ds
    model = t_train_pq(tds.train, 8, 32, generator=torch.Generator().manual_seed(0),
                       iters=6, device="cpu")
    assert model.codebooks.shape == (8, 32, 4) and model.dim == 32
    torch.testing.assert_close(model.r, torch.eye(32))
    # trained codebooks beat the random-init ones they start from
    init_cb = tds.train[torch.randperm(tds.train.shape[0],
                                       generator=torch.Generator().manual_seed(5))[:32]]
    init = tbase.QuantizerModel(model.r, init_cb.reshape(32, 8, 4).transpose(0, 1)
                                .contiguous())
    assert float(tbase.distortion(model, tds.base)) < float(
        tbase.distortion(init, tds.base))


def test_train_pq_fs4_injected_init_matches_jax(monkeypatch):
    """train_pq_fs4 is train_pq at K=16: from the same injected k-means
    init both packages reach the same codebooks (well-separated clusters,
    so near-tie flips between the two summation orders move no point;
    rtol 1e-4 covers segment_sum vs index_add_)."""
    rng = np.random.default_rng(21)
    m, dsub, n = 4, 2, 800
    centers = rng.normal(size=(m, 16, dsub)).astype(np.float32) * 6.0
    labels = rng.integers(0, 16, (n, m))
    x = (centers[np.arange(m)[None, :], labels].reshape(n, m * dsub)
         + 0.3 * rng.normal(size=(n, m * dsub))).astype(np.float32)
    init = x[rng.permutation(n)[:16]].reshape(16, m, dsub).transpose(1, 0, 2).copy()
    j_km, t_km = jpq.kmeans_multi, tpq.kmeans_multi
    monkeypatch.setattr(jpq, "kmeans_multi", lambda key, xr, k, iters: j_km(
        key, xr, k, iters=iters, init=jnp.asarray(init)))
    monkeypatch.setattr(tpq, "kmeans_multi", lambda xr, k, generator, iters: t_km(
        xr, k, iters=iters, init=T(init)))
    want = j_train_pq_fs4(jax.random.PRNGKey(0), jnp.asarray(x), m, iters=6)
    got = t_train_pq_fs4(T(x), m, generator=torch.Generator().manual_seed(0),
                         iters=6, device="cpu")
    assert got.k == 16 and got.codebooks.shape == (m, 16, dsub)
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks),
                               rtol=1e-4, atol=1e-5)
    codes = tbase.encode(got, T(x))
    assert int(codes.max()) < 16


def test_build_lut_quantized_matches_jax(ds):
    """build_lut(quantize=True): the f32 tables agree at rtol 1e-5 (another
    reduction order), so the quantized bytes agree within one step and the
    affine within the same rtol; fed JAX's own f32 tables, quantize_luts is
    bit-exact (tests/test_torch_fastscan.py)."""
    jds, tds = ds
    jm = j_train_pq_fs4(jax.random.PRNGKey(2), jds.train, 8, iters=4)
    tm = convert.quantizer_from_numpy(np.asarray(jm.r), np.asarray(jm.codebooks),
                                      device="cpu")
    want = jbase.build_lut(jm, jds.queries, quantize=True)
    got = tbase.build_lut(tm, tds.queries, quantize=True)
    assert isinstance(got, QuantizedLUT) and got.lut.dtype == torch.uint8
    diff = np.abs(got.lut.numpy().astype(np.int32) - np.asarray(want.lut).astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 0.01
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-5)
    np.testing.assert_allclose(got.bias.numpy(), np.asarray(want.bias), rtol=1e-5,
                               atol=1e-4)


def test_train_pq_under_a_fixed_rotation_matches_jax(monkeypatch):
    """``train_pq(rotation=)``: the same rotation and injected k-means init
    give the same model on both sides (rtol 1e-4: segment_sum vs
    index_add_, and the rotation product's order)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(600, 8)).astype(np.float32) * 3.0
    r, _ = np.linalg.qr(rng.normal(size=(8, 8)))
    r = r.astype(np.float32)
    init = rng.normal(size=(2, 8, 4)).astype(np.float32)
    j_km, t_km = jpq.kmeans_multi, tpq.kmeans_multi
    monkeypatch.setattr(jpq, "kmeans_multi", lambda key, xr, k, iters: j_km(
        key, xr, k, iters=iters, init=jnp.asarray(init)))
    monkeypatch.setattr(tpq, "kmeans_multi", lambda xr, k, generator, iters: t_km(
        xr, k, iters=iters, init=T(init)))
    want = j_train_pq(jax.random.PRNGKey(0), jnp.asarray(x), 2, 8, iters=5,
                      rotation=jnp.asarray(r))
    got = t_train_pq(T(x), 2, 8, generator=torch.Generator(), iters=5,
                     rotation=T(r), device="cpu")
    np.testing.assert_array_equal(got.r.numpy(), np.asarray(want.r))
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks),
                               rtol=1e-4, atol=1e-4)


def test_train_opq_matches_jax_from_injected_inits(monkeypatch):
    """OPQ alternates Lloyd and Procrustes; with every k-means started from
    the same injected init, both packages reach the same rotation and
    codebooks (rtol 1e-3 / atol 1e-3: SVDs and reductions of two
    libraries; R = U·Vᵀ is free of the SVD's sign choice)."""
    from repro.pq.opq import train_opq as j_train_opq
    from repro_torch.pq.opq import train_opq as t_train_opq

    rng = np.random.default_rng(8)
    basis, _ = np.linalg.qr(rng.normal(size=(8, 8)))
    centers = rng.normal(size=(40, 8)) * 4.0
    x = ((centers[rng.integers(0, 40, 800)] + 0.3 * rng.normal(size=(800, 8)))
         @ np.diag(np.geomspace(2.0, 0.5, 8)) @ basis.T).astype(np.float32)
    # K=16 codewords over 4-d subspaces: the Procrustes matrix has full
    # rank and distinct singular values, so R is unique
    init = x[rng.permutation(800)[:16]].reshape(16, 2, 4).transpose(1, 0, 2).copy()
    j_km, t_km = jpq.kmeans_multi, tpq.kmeans_multi
    monkeypatch.setattr(jpq, "kmeans_multi", lambda key, xr, k, iters: j_km(
        key, xr, k, iters=iters, init=jnp.asarray(init)))
    monkeypatch.setattr(tpq, "kmeans_multi", lambda xr, k, generator, iters: t_km(
        xr, k, iters=iters, init=T(init)))
    want = j_train_opq(jax.random.PRNGKey(0), jnp.asarray(x), 2, 16, outer_iters=3,
                       kmeans_iters=4)
    got = t_train_opq(T(x), 2, 16, generator=torch.Generator(), outer_iters=3,
                      kmeans_iters=4, device="cpu")
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks),
                               rtol=1e-3, atol=1e-3)
    rr = got.r.numpy()
    np.testing.assert_allclose(rr @ rr.T, np.eye(8), atol=1e-5)
