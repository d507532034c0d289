"""Codebook refresh across streaming generations (``index/refresh.py`` and
the refresh arm of ``consolidate``), the port vs the JAX package on the
CPU, plus the streaming scenario of the port's ``serve`` driver.

``refresh_quantizer`` is held to the reference's codebooks within 1e-4 with
the reference's draws injected: the Lloyd stage is warm-started and draws
nothing (``kmeans_multi(init=)``), and every draw of the gradient stage —
the routing pool, the anchors, the triplets, the routing subsample and the
Gumbel noise — is replayed from JAX's ``k_fit`` key splits through
``fit(draws=)``. The rest mirrors ``tests/test_refresh.py`` on the port:
the snapshot carries the quantizer so ``restore()`` is self-contained,
surviving rows re-encode against the new codebooks in both layouts, the
seed table rebuilds against them, post-refresh serving equals a fresh
engine's, a crash between retraining and the snapshot leaves the previous
generation restorable, and refreshed codebooks beat frozen ones on recall
under drift.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.graphs.adjacency import Graph as JGraph
from repro.index import BaseSegment as JBase
from repro.index import RefreshConfig as JRefreshConfig
from repro.index import Tombstones as JTombstones
from repro.index import refresh_quantizer as j_refresh
from repro.pq import base as jbase
from repro_torch.core import trainer as T
from repro_torch.graphs.knn import knn_ids
from repro_torch.graphs.vamana import build_vamana
from repro_torch.index import (BaseSegment, RefreshConfig, StreamingEngine,
                               Tombstones, refresh_quantizer)
from repro_torch.index.segment import encode_codes, load_segment, save_segment
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.pq.pack import unpack_codes
from repro_torch.pq.pq import train_pq, train_pq_fs4
from repro_torch.search.metrics import recall_at_k
from repro_torch.search.seed import build_seed_index

N, D, NQ, M, K = 900, 32, 20, 8, 32

# sized so a refreshed consolidate stays in test-suite time (the reference's)
TINY = RefreshConfig(steps=4, kmeans_iters=2, triplet_batch=64, routing_batch=64,
                     routing_pool_queries=16, routing_refresh_every=4, beam_h=8)


def T_(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _data(n, seed=1, nc=12):
    r = np.random.default_rng(seed)
    centers = r.normal(size=(nc, D)).astype(np.float32) * 3
    lab = r.integers(0, nc, n)
    basis = (np.linalg.qr(r.normal(size=(D, D)))[0]
             @ np.diag(np.linspace(1.5, 0.3, D))).astype(np.float32)
    x = ((centers[lab] + r.normal(size=(n, D))) @ basis).astype(np.float32)
    return x, lab, centers, basis, r


@pytest.fixture(scope="module")
def S():
    x, _, centers, basis, r = _data(N)
    q = ((centers[r.integers(0, 12, NQ)] + r.normal(size=(NQ, D))) @ basis).astype(np.float32)
    graph = build_vamana(T_(x), generator=torch.Generator().manual_seed(0), r=12, l=24,
                         device="cpu")
    gen = torch.Generator().manual_seed(3)
    models = {"u8": train_pq(T_(x), M, K, generator=gen, iters=8, device="cpu"),
              "fs4": train_pq_fs4(T_(x), M, generator=gen, iters=8, device="cpu")}
    return dict(x=x, q=T_(q), graph=graph, models=models)


def make_engine(S, layout="u8"):
    model = S["models"][layout]
    seg = BaseSegment(graph=S["graph"], codes=encode_codes(model, T_(S["x"]), layout),
                      vectors=T_(S["x"]), layout=layout)
    return StreamingEngine(seg, model, delta_capacity=512, device="cpu")


def churn(eng, x, *, n_del=300, n_ins=100, seed=11):
    rng = np.random.default_rng(seed)
    rows = x[rng.integers(0, x.shape[0], n_ins)]
    gids = eng.insert(rows + 0.1 * rng.normal(size=rows.shape).astype(np.float32))
    eng.delete(rng.choice(eng.base.n, n_del, replace=False))
    return gids


# ---------------------------------------------------------------------------
# refresh_quantizer vs the reference
# ---------------------------------------------------------------------------

def _jax_fit_draws(key, cfg, m, k):
    """``fit(draws=)`` replaying the reference's: refresh splits its key
    into (k_lloyd, k_fit), fit splits k_fit into (key, kinit), and step s
    draws from the five splits of fold_in(key, s)."""
    _, k_fit = jax.random.split(key)
    fkey, _ = jax.random.split(k_fit)
    b, rb, p = cfg.triplet_batch, cfg.routing_batch, cfg.routing_pool_queries

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

        kt, kr = jax.random.split(k5)
        ka, kpp, knn = jax.random.split(kt, 3)
        noise = (tuple(gumbel(kk, (b, m, k)) for kk in (ka, kpp, knn)),
                 gumbel(kr, (rb * cfg.beam_h, m, k)))
        return T.StepDraws(
            pool=lambda: T_(np.asarray(jax.random.choice(k1, n_live, (p,),
                                                         replace=n_live < p))),
            anchors=T_(np.asarray(jax.random.randint(k2, (b,), 0, n_live))),
            triplets=triplets,
            subsample=lambda nvalid: T_(np.asarray(jax.random.randint(
                k4, (rb,), 0, max(int(nvalid), 1)))),
            noise=noise)
    return draws


@pytest.mark.parametrize("cfg", [TINY, RefreshConfig(steps=0, kmeans_iters=3),
                                 RefreshConfig(steps=3, kmeans_iters=0, triplet_batch=32,
                                               routing_batch=32, routing_pool_queries=8,
                                               routing_refresh_every=2, beam_h=8,
                                               max_sample=500, use_neighborhood=False)])
def test_refresh_quantizer_equals_jax_with_its_draws(S, cfg):
    model = S["models"]["u8"]
    jmodel = jbase.QuantizerModel(r=jnp.asarray(model.r.numpy()),
                                  codebooks=jnp.asarray(model.codebooks.numpy()))
    codes = _np(encode_codes(model, T_(S["x"]), "u8"))
    jts = JTombstones(N)
    jts.add(np.arange(0, N, 4))
    jseg = JBase(graph=JGraph(jnp.asarray(S["graph"].neighbors.numpy()),
                              jnp.asarray(int(S["graph"].medoid), jnp.int32)),
                 codes=jnp.asarray(codes), vectors=jnp.asarray(S["x"]))
    jcfg = JRefreshConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    key = jax.random.PRNGKey(cfg.seed)
    jnew, jrep = j_refresh(jseg, jmodel, tombstones=jts._words, cfg=jcfg, key=key)
    seg = BaseSegment(graph=S["graph"], codes=T_(codes), vectors=T_(S["x"]))
    new, rep = refresh_quantizer(seg, model, tombstones=jts._words, cfg=cfg,
                                 draws=_jax_fit_draws(key, cfg, M, K), device="cpu")
    np.testing.assert_allclose(_np(new.codebooks), np.asarray(jnew.codebooks),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(new.r), np.asarray(jnew.r))
    assert rep["n_live"] == jrep["n_live"] and len(rep["history"]) == len(jrep["history"])
    for name in ("distortion_before", "distortion_after"):
        np.testing.assert_allclose(rep[name], jrep[name], rtol=1e-4, err_msg=name)


def test_refresh_reduces_distortion_and_keeps_rotation(S):
    model = S["models"]["u8"]
    seg = BaseSegment(graph=S["graph"], codes=encode_codes(model, T_(S["x"]), "u8"),
                      vectors=T_(S["x"]))
    ts = Tombstones(N, device="cpu")
    ts.add(np.arange(0, N, 3))
    new, rep = refresh_quantizer(seg, model, tombstones=ts._words,
                                 cfg=RefreshConfig(steps=0, kmeans_iters=6), device="cpu")
    assert rep["distortion_after"] <= rep["distortion_before"] + 1e-4
    assert rep["n_live"] == N - ts.count
    assert torch.equal(new.r, model.r) and new.codebooks.shape == model.codebooks.shape
    new2, rep2 = refresh_quantizer(seg, model, tombstones=ts._words, cfg=TINY, device="cpu")
    assert bool(torch.isfinite(new2.codebooks).all()) and len(rep2["history"]) > 0


def test_refresh_too_few_live_rows_and_data_parallel_raise(S):
    model = S["models"]["u8"]
    seg = BaseSegment(graph=S["graph"], codes=encode_codes(model, T_(S["x"]), "u8"),
                      vectors=T_(S["x"]))
    ts = Tombstones(N, device="cpu")
    ts.add(np.arange(N - 5))
    dp = dataclasses.replace(TINY, data_parallel=True)
    for cfg in (TINY, dp):
        with pytest.raises(ValueError, match="live rows"):
            refresh_quantizer(seg, model, tombstones=ts._words, cfg=cfg, device="cpu")
    # the data-parallel fit is ported: it trains instead of raising
    new, rep = refresh_quantizer(seg, model, cfg=dp, device="cpu")
    assert bool(torch.isfinite(new.codebooks).all()) and len(rep["history"]) > 0


def test_refresh_subsample_is_the_references(S, monkeypatch):
    """``max_sample`` picks the live rows with ``np.random.default_rng(seed)``
    as the reference does: the Lloyd stage sees the same rows."""
    seen = {}
    real = importlib.import_module("repro_torch.index.refresh").kmeans_multi

    def spy(sub, k, **kw):
        seen["sub"] = _np(sub)
        return real(sub, k, **kw)

    monkeypatch.setattr("repro_torch.index.refresh.kmeans_multi", spy)
    model = S["models"]["u8"]
    seg = BaseSegment(graph=S["graph"], codes=encode_codes(model, T_(S["x"]), "u8"),
                      vectors=T_(S["x"]))
    ts = Tombstones(N, device="cpu")
    ts.add(np.arange(0, N, 5))
    refresh_quantizer(seg, model, tombstones=ts._words, device="cpu",
                      cfg=RefreshConfig(steps=0, kmeans_iters=1, max_sample=300, seed=7))
    live = np.setdiff1d(np.arange(N), np.arange(0, N, 5))
    idx = np.sort(np.random.default_rng(7).choice(live, 300, replace=False))
    want = S["x"][idx].reshape(300, M, D // M).transpose(1, 0, 2)
    np.testing.assert_array_equal(seen["sub"], want)


# ---------------------------------------------------------------------------
# Snapshot persistence: the quantizer travels with the generation
# ---------------------------------------------------------------------------

def test_snapshot_roundtrips_quantizer(S, tmp_path):
    model = S["models"]["u8"]
    seg = BaseSegment(graph=S["graph"], codes=encode_codes(model, T_(S["x"]), "u8"),
                      vectors=T_(S["x"]))
    save_segment(str(tmp_path), seg, model=model)
    seg2, stored = load_segment(str(tmp_path), with_model=True, device="cpu")
    assert torch.equal(stored.r, model.r) and torch.equal(stored.codebooks, model.codebooks)
    assert (stored.m, stored.k) == (model.m, model.k)
    assert load_segment(str(tmp_path), device="cpu").n == seg.n


@pytest.mark.parametrize("layout", ["u8", "fs4"])
def test_restore_self_contained_after_refresh(S, tmp_path, layout):
    eng = make_engine(S, layout)
    churn(eng, S["x"])
    stats = eng.consolidate(ckpt_dir=str(tmp_path), refresh=TINY)
    assert stats["refreshed"] and "refresh" in stats
    res = eng.search(S["q"], k=10, h=32)
    restored = StreamingEngine.restore(str(tmp_path), device="cpu")
    assert restored.generation == 1
    assert torch.equal(restored.model.codebooks, eng.model.codebooks)
    assert torch.equal(restored.search(S["q"], k=10, h=32).ids, res.ids)


def test_legacy_codebookless_snapshot_regression(S, tmp_path):
    model = S["models"]["u8"]
    seg = BaseSegment(graph=S["graph"], codes=encode_codes(model, T_(S["x"]), "u8"),
                      vectors=T_(S["x"]))
    save_segment(str(tmp_path), seg)
    _, stored = load_segment(str(tmp_path), with_model=True, device="cpu")
    assert stored is None
    with pytest.raises(ValueError, match="no stored quantizer"):
        StreamingEngine.restore(str(tmp_path), device="cpu")
    eng = StreamingEngine.restore(str(tmp_path), model, device="cpu")
    assert bool(torch.isfinite(eng.search(S["q"], k=5, h=16).dists[:, 0]).all())
    wrong = train_pq(T_(S["x"]), 4, 32, generator=torch.Generator().manual_seed(8),
                     iters=2, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        StreamingEngine.restore(str(tmp_path), wrong, device="cpu")


def test_explicit_model_overrides_stored(S, tmp_path):
    model = S["models"]["u8"]
    seg = BaseSegment(graph=S["graph"], codes=encode_codes(model, T_(S["x"]), "u8"),
                      vectors=T_(S["x"]))
    save_segment(str(tmp_path), seg, model=model)
    override = train_pq(T_(S["x"]), M, K, generator=torch.Generator().manual_seed(9),
                        iters=2, device="cpu")
    eng = StreamingEngine.restore(str(tmp_path), override, device="cpu")
    assert torch.equal(eng.model.codebooks, override.codebooks)


# ---------------------------------------------------------------------------
# Re-encode + rebuilt serving state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["u8", "fs4"])
def test_reencoded_codes_roundtrip(S, layout):
    eng = make_engine(S, layout)
    churn(eng, S["x"])
    eng.consolidate(refresh=TINY)
    assert torch.equal(eng.base.codes, encode_codes(eng.model, eng.base.vectors, layout))
    frozen = make_engine(S, layout)
    churn(frozen, S["x"])
    frozen.consolidate()
    assert not torch.equal(eng.base.codes, frozen.base.codes)


def test_seed_index_rebuilt_against_new_codebooks(S):
    eng = make_engine(S, "fs4")
    eng.search(S["q"][:4], k=5, h=16, entries=4)
    assert eng._seedix is not None
    churn(eng, S["x"])
    eng.consolidate(refresh=TINY)
    assert eng._seedix is None
    eng.search(S["q"][:4], k=5, h=16, entries=4)
    expect = build_seed_index(unpack_codes(eng.base.codes, eng.model.m), device="cpu")
    assert torch.equal(eng._seedix.table, expect.table)
    assert torch.equal(eng._seedix.codes, eng.base.codes)   # scored packed


@pytest.mark.parametrize("entries", [1, 4])
def test_post_refresh_serving_matches_fresh_engine(S, entries):
    eng = make_engine(S)
    churn(eng, S["x"])
    eng.consolidate(refresh=TINY)
    fresh = StreamingEngine(eng.base, eng.model, delta_capacity=512, device="cpu")
    a = eng.search(S["q"], k=10, h=32, entries=entries)
    b = fresh.search(S["q"], k=10, h=32, entries=entries)
    for name in ("ids", "dists", "n_dist"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ---------------------------------------------------------------------------
# Crash safety
# ---------------------------------------------------------------------------

def test_crash_mid_refresh_previous_generation_restores(S, tmp_path, monkeypatch):
    """Kill consolidate(refresh=...) after the retrain but before the
    snapshot: the engine keeps serving the old generation with the OLD
    codebooks, and restore() brings back the OLD codebooks too."""
    C = importlib.import_module("repro_torch.index.consolidate")
    eng = make_engine(S)
    churn(eng, S["x"], seed=7)
    eng.consolidate(ckpt_dir=str(tmp_path))
    old_books = eng.model.codebooks.clone()
    churn(eng, S["x"], n_del=200, n_ins=50, seed=13)
    n_live = eng.n_live
    before = eng.search(S["q"], k=10, h=32)
    seen = {}

    def boom(directory, seg, keep=None, model=None):
        seen["retrained"] = model is not None and not torch.equal(model.codebooks, old_books)
        raise RuntimeError("disk died")

    monkeypatch.setattr(C, "save_segment", boom)
    with pytest.raises(RuntimeError, match="disk died"):
        eng.consolidate(ckpt_dir=str(tmp_path), refresh=TINY)
    assert seen["retrained"]
    assert eng.generation == 1 and eng.n_live == n_live
    assert torch.equal(eng.model.codebooks, old_books)
    assert torch.equal(eng.search(S["q"], k=10, h=32).ids, before.ids)
    restored = StreamingEngine.restore(str(tmp_path), device="cpu")
    assert restored.generation == 1 and torch.equal(restored.model.codebooks, old_books)


# ---------------------------------------------------------------------------
# Acceptance: refreshed codebooks beat frozen ones under drift
# ---------------------------------------------------------------------------

def test_drift_recall_refreshed_beats_frozen():
    """The live corpus narrows to 3 of 12 clusters (~75% deletes + fresh
    in-cluster inserts): the retrain cuts live distortion hard and the
    refreshed generation beats the frozen one on recall@10 at an equal
    search budget."""
    n = 1600
    x, lab, centers, basis, r = _data(n, seed=2)
    model = train_pq(T_(x), M, 16, generator=torch.Generator().manual_seed(3), iters=8,
                     device="cpu")
    g = build_vamana(T_(x), generator=torch.Generator().manual_seed(0), r=16, l=32,
                     device="cpu")
    keep_c = np.arange(3)
    dead = np.flatnonzero(~np.isin(lab, keep_c))
    xnew = ((centers[r.choice(keep_c, 500)] + r.normal(size=(500, D))) @ basis
            ).astype(np.float32)

    def churned():
        seg = BaseSegment(graph=g, codes=encode_codes(model, T_(x), "u8"), vectors=T_(x))
        e = StreamingEngine(seg, model, delta_capacity=512, device="cpu")
        e.insert(xnew)
        e.delete(dead)
        return e

    live_base = np.setdiff1d(np.arange(n), dead)
    corpus = np.concatenate([x[live_base], xnew])
    q = T_(((centers[r.choice(keep_c, 100)] + r.normal(size=(100, D))) @ basis
            ).astype(np.float32))
    gt = knn_ids(T_(corpus), q, 10)[0].numpy()
    frozen = churned()
    frozen.consolidate()
    refreshed = churned()
    rep = refreshed.consolidate(refresh=RefreshConfig(steps=30, kmeans_iters=10))["refresh"]
    assert rep["distortion_after"] < 0.75 * rep["distortion_before"], rep
    r_frozen = recall_at_k(frozen.search(q, k=10, h=32).ids, gt, 10)
    r_refresh = recall_at_k(refreshed.search(q, k=10, h=32).ids, gt, 10)
    assert r_refresh >= r_frozen + 0.04, (r_frozen, r_refresh)


# ---------------------------------------------------------------------------
# serve --scenario streaming
# ---------------------------------------------------------------------------

def test_serve_streaming_scenario_rounds_refresh_and_chaos(tmp_path, capsys):
    """The reference's per-round, consolidation and chaos-restore lines,
    on the unit-test set (generation 0 = 1800 rows, a 200-row stream)."""
    d = str(tmp_path)
    ttrain.main(["--dataset", "unit-test", "--steps", "2", "--m", "4", "--k", "16",
                 "--batch", "32", "--routing-queries", "8", "--graph-r", "8",
                 "--graph-l", "16", "--beam", "16", "--checkpoint-every", "4", "--quiet",
                 "--device", "cpu", "--ckpt-dir", d])
    capsys.readouterr()
    common = ["--ckpt-dir", d, "--scenario", "streaming", "--churn", "0.1",
              "--graph-r", "8", "--graph-l", "16", "--device", "cpu"]
    out = tserve.main(common + ["--churn-rounds", "4", "--refresh-every", "2"])
    text = capsys.readouterr().out
    assert "[serve] streaming: base 1800 rows (gen 0), insert stream 200" in text
    for tag in ("round0", "round1", "refreshed1", "round2", "round3", "consolidated"):
        assert f"[serve] streaming/{tag}: recall@10=" in text, tag
    assert text.count("codebooks refreshed (live distortion") == 2
    assert "[serve] consolidated → generation 2: 1800 rows (100 dropped, 100 folded in)" in text
    assert out["engine"].generation == 2 and out["evals"]["consolidated"]["live"] == 1800
    out = tserve.main(common + ["--churn-rounds", "2", "--codes", "fs4",
                                "--chaos", "crash=consolidate,corrupt,seed=3"])
    text = capsys.readouterr().out
    assert "[serve] chaos: injected crash during consolidation" in text
    assert "failed verification (ChecksumError) — falling back" in text
    assert "[serve] chaos: restored generation 2 (1800 live rows)" in text
    assert "[serve] streaming/restored: recall@10=" in text
    with pytest.raises(SystemExit, match="not available with --scenario streaming"):
        tserve.main(common + ["--port-stdin"])
