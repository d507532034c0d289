"""The port's streaming index vs the JAX package, on the CPU: tombstones,
the delta segment, the two-arm search and its merge tie order,
consolidation, snapshots across packages, K = 512 int32 codes in the
engine, and feature
sampling under churn (``core/features.py`` ``tombstones=``).

Both packages route on one graph (built by the port, handed to JAX as
arrays) with one quantizer (trained by the port, handed to JAX). Where ids
and counters must be exact, the base codes are tie-free (unique random rows,
the ``codes_uniq`` trick of ``tests/test_engine.py``) and the LUTs are
integer-valued f32 injected into both engines, so every ADC sum is exact in
any order; then ids, ``hops``, ``rounds``, ``n_dist`` and ``truncated``
equal JAX's and distances are held at rtol 1e-5, atol 1e-5. Consolidation
must give JAX's ``old2new``, codes and medoid exactly and its neighbors on
≥ 99% of rows (the bar of ``prune_from_vectors`` in
``tests/test_torch_graphs.py``). The guarantees of the reference's own tests
(``tests/test_streaming.py``, ``tests/test_features_churn.py``) are held on
the port as they are there.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import features as jF
from repro.graphs.adjacency import Graph as JGraph
from repro.index import BaseSegment as JBase
from repro.index import StreamingEngine as JEngine
from repro.index import Tombstones as JTombstones
from repro.index.delta import DeltaSegment as JDelta
from repro.index.segment import load_segment as j_load_segment
from repro.index.segment import save_segment as j_save_segment
from repro.kernels import ops as jops
from repro.pq import base as jbase
from repro.pq import pack as jpack
from repro.search import beam as jbeam
from repro_torch import convert
from repro_torch.core import features as F
from repro_torch.core import trainer as T
from repro_torch.dist import checkpoint as tckpt
from repro_torch.dist.fault import corrupt_snapshot
from repro_torch.dist.retry import RetryPolicy
from repro_torch.graphs.knn import knn_ids
from repro_torch.graphs.vamana import build_vamana
from repro_torch.index import (BaseSegment, DeltaFullError, DeltaSegment,
                               StreamingEngine, Tombstones)
from repro_torch.index.segment import (bitset_words, encode_codes, load_segment,
                                       save_segment)
from repro_torch.pq import pack
from repro_torch.pq.pq import train_pq, train_pq_fs4
from repro_torch.search import beam as tbeam
from repro_torch.search.metrics import recall_at_k

N, D, NQ, M, K = 800, 32, 16, 8, 32
RTOL = ATOL = 1e-5


def T_(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def S():
    """Clustered anisotropic data (the reference's conftest recipe at 800
    rows), a port Vamana graph shared with JAX, u8 (M=8, K=32) and fs4
    (M=8) quantizers trained by the port and shared with JAX, and the exact
    top-10."""
    r = np.random.default_rng(1)
    centers = r.normal(size=(12, D)).astype(np.float32) * 3
    basis = (np.linalg.qr(r.normal(size=(D, D)))[0]
             @ np.diag(np.linspace(1.5, 0.3, D))).astype(np.float32)
    x = ((centers[r.integers(0, 12, N)] + r.normal(size=(N, D))) @ basis).astype(np.float32)
    q = ((centers[r.integers(0, 12, NQ)] + r.normal(size=(NQ, D))) @ basis).astype(np.float32)
    tgraph = build_vamana(T_(x), generator=torch.Generator().manual_seed(0), r=12,
                          l=24, device="cpu")
    jgraph = JGraph(jnp.asarray(tgraph.neighbors.numpy()),
                    jnp.asarray(int(tgraph.medoid), jnp.int32))
    gen = torch.Generator().manual_seed(3)
    models = {"u8": train_pq(T_(x), M, K, generator=gen, iters=8, device="cpu"),
              "fs4": train_pq_fs4(T_(x), M, generator=gen, iters=8, device="cpu")}
    jmodels = {k: jbase.QuantizerModel(r=jnp.asarray(v.r.numpy()),
                                       codebooks=jnp.asarray(v.codebooks.numpy()))
               for k, v in models.items()}
    gt, _ = knn_ids(T_(x), T_(q), 10)
    return dict(x=x, q=q, tgraph=tgraph, jgraph=jgraph, models=models,
                jmodels=jmodels, gt=gt.numpy())


def make_engine(S, layout="u8", *, capacity=256, codes=None, **kw):
    model = S["models"][layout]
    codes = encode_codes(model, T_(S["x"]), layout) if codes is None else T_(codes)
    seg = BaseSegment(graph=S["tgraph"], codes=codes, vectors=T_(S["x"]), layout=layout)
    return StreamingEngine(seg, model, delta_capacity=capacity, device="cpu", **kw)


def make_jax_engine(S, layout, codes, *, capacity=256):
    seg = JBase(graph=S["jgraph"], codes=jnp.asarray(codes), vectors=jnp.asarray(S["x"]),
                layout=layout)
    return JEngine(seg, S["jmodels"][layout], delta_capacity=capacity)


def new_rows(x, count, seed=9):
    """Fresh vectors from the fixture's distribution: jittered samples."""
    r = np.random.default_rng(seed)
    rows = np.asarray(x)[r.integers(0, x.shape[0], count)]
    return (rows + 0.1 * r.normal(size=rows.shape)).astype(np.float32)


def _tie_free(layout, seed=4):
    """Unique random base code rows (u8 (N, M), fs4 packed (N, M/2))."""
    r = np.random.default_rng(seed)
    k = 16 if layout == "fs4" else K
    codes = r.integers(0, k, (N, M)).astype(np.uint8)
    while np.unique(codes, axis=0).shape[0] != N:  # pragma: no cover
        codes = r.integers(0, k, (N, M)).astype(np.uint8)
    return codes if layout == "u8" else _np(pack.pack_codes(T_(codes)))


def _int_luts(layout, seed=5):
    """Per-query LUTs with exact sums: integer f32 (u8); uint8 tables with a
    power-of-two scale and a bias on a 1/64 grid (fs4)."""
    r = np.random.default_rng(seed)
    if layout == "u8":
        return r.integers(0, 64, (NQ, M, K)).astype(np.float32)
    return (r.integers(0, 256, (NQ, M, 16)).astype(np.uint8),
            (2.0 ** -r.integers(0, 4, NQ)).astype(np.float32),
            (r.integers(0, 64, NQ) / 64).astype(np.float32))


def _inject(eng, jeng, layout):
    """Both engines answer with the same exact LUTs."""
    luts = _int_luts(layout)
    if layout == "u8":
        eng.lut_fn = lambda q: T_(luts)
        jeng.lut_fn = lambda q: jnp.asarray(luts)
    else:
        eng.lut_fn = lambda q: convert.quantized_lut_from_numpy(*luts, device="cpu")
        jeng.lut_fn = lambda q: jpack.QuantizedLUT(*(jnp.asarray(a) for a in luts))


def _assert_same(t_res, j_res):
    np.testing.assert_array_equal(_np(t_res.ids), np.asarray(j_res.ids))
    np.testing.assert_allclose(_np(t_res.dists), np.asarray(j_res.dists),
                               rtol=RTOL, atol=ATOL)
    for name in ("hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(_np(getattr(t_res, name)),
                                      np.asarray(getattr(j_res, name)), err_msg=name)


# ---------------------------------------------------------------------------
# Tombstone semantics (the reference's guarantees, on the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["u8", "fs4"])
@pytest.mark.parametrize("h", [8, 32, 64])
def test_tombstoned_id_never_returned(S, layout, h):
    """Delete each query's true top-1 (base) plus some delta rows — no beam
    width, no layout ever returns them, and live results still flow."""
    eng = make_engine(S, layout)
    dgids = eng.insert(new_rows(S["x"], 64))
    dead_base = np.unique(S["gt"][:, 0])
    dead_delta = dgids[::3]
    eng.delete(dead_base)
    eng.delete(dead_delta)
    ids = _np(eng.search(T_(S["q"]), k=10, h=h).ids)
    assert not np.isin(ids, np.concatenate([dead_base, dead_delta])).any()
    assert (ids >= 0).any(axis=1).all()


def test_delete_medoid_keeps_routing(S):
    eng = make_engine(S)
    q = T_(S["q"])
    r_before = recall_at_k(eng.search(q, k=10, h=32).ids, S["gt"], 10)
    medoid = int(S["tgraph"].medoid)
    eng.delete(medoid)
    res = eng.search(q, k=10, h=32)
    ids = _np(res.ids)
    assert not (ids == medoid).any()
    assert int(res.hops.min()) > 0
    assert recall_at_k(ids, S["gt"], 10) >= r_before - 0.02
    assert not eng.tombstones.contains([eng._entry])[0]


def test_delete_every_medoid_neighbor_then_medoid(S):
    """Entry re-anchoring survives its preferred candidates being dead, and
    lands where the reference's does."""
    eng = make_engine(S)
    jeng = make_jax_engine(S, "u8", _np(eng.base.codes))
    medoid = int(S["tgraph"].medoid)
    nbrs = S["tgraph"].neighbors[medoid].numpy()
    nbrs = nbrs[nbrs < N]
    for e in (eng, jeng):
        e.delete(nbrs)
        e.delete(medoid)
    assert eng._entry == jeng._entry
    ids = _np(eng.search(T_(S["q"]), k=10, h=32).ids)
    assert not np.isin(ids, np.concatenate([nbrs, [medoid]])).any()
    assert (ids >= 0).any()


def test_word_boundary_ids(S):
    eng = make_engine(S)
    boundary = np.array([0, 31, 32, 63, 64, N - 33, N - 32, N - 1])
    eng.delete(boundary)
    assert eng.tombstones.contains(boundary).all()
    assert not eng.tombstones.contains(np.array([1, 30, 33, 65, N - 31, N - 2])).any()
    ids = _np(eng.search(T_(S["q"]), k=10, h=32).ids)
    assert not np.isin(ids, boundary).any()


def test_tombstones_bitset_unit_and_words_equal_jax():
    ts, jts = Tombstones(64, device="cpu"), JTombstones(64)
    assert ts._words.shape[0] == bitset_words(64) == 3
    assert ts.add([0, 31, 32, 63]) == jts.add([0, 31, 32, 63]) == 4
    assert ts.add([31, 63]) == 0
    assert ts.count == 4
    assert ts.contains([31, 32]).all() and not ts.contains([1, 33]).any()
    np.testing.assert_array_equal(ts._words, jts._words)
    # the device view: the same 32 bits as int32, uploaded once per mutation
    view = ts.words
    assert view is ts.words and view.dtype == torch.int32
    np.testing.assert_array_equal(view.numpy().view(np.uint32), jts._words)
    assert ts.add([5]) == 1 and ts.words is not view
    with pytest.raises(ValueError):
        ts.add([64])
    ts.clear()
    assert ts.count == 0 and not ts.contains([0]).any()


def test_make_adc_dist_fn_baked_tombstones_equals_jax(S):
    """The frozen-snapshot variant: dead ids score +inf; the beam over it
    equals JAX's (live entry, tie-free codes, exact LUTs)."""
    codes = _tie_free("u8")
    cp = np.concatenate([codes, np.zeros((1, M), np.uint8)])
    luts = _int_luts("u8")
    jts = JTombstones(N)
    dead = np.unique(S["gt"][:, 0])
    dead = dead[dead != int(S["tgraph"].medoid)]
    jts.add(dead)
    jres = jbeam.beam_search(S["jgraph"].neighbors, S["jgraph"].medoid,
                             jnp.asarray(luts),
                             jbeam.make_adc_dist_fn(jnp.asarray(cp), tombstones=jts.words),
                             h=32)
    tres = tbeam.beam_search(S["tgraph"].neighbors, S["tgraph"].medoid, T_(luts),
                             tbeam.make_adc_dist_fn(T_(cp), tombstones=jts._words),
                             h=32)
    _assert_same(tres, jres)
    ids, dists = _np(tres.ids), _np(tres.dists)
    assert not np.isin(ids[np.isfinite(dists)], dead).any()
    assert np.isfinite(dists[:, 0]).all()


def test_delete_then_reinsert(S):
    """A reinserted vector gets a NEW id; the old id stays dead."""
    eng = make_engine(S)
    victim = 123
    eng.delete(victim)
    (new_gid,) = eng.insert(S["x"][victim][None])
    assert new_gid == N
    ids = _np(eng.search(T_(S["x"][victim][None]), k=5, h=32).ids)[0]
    assert ids[0] == new_gid and victim not in ids


def test_delete_validation_and_idempotence(S):
    eng = make_engine(S)
    assert eng.delete([5, 5, 7]) == 2
    assert eng.delete([5]) == 0
    with pytest.raises(ValueError, match="out of the occupied range"):
        eng.delete([N])
    gid = eng.insert(new_rows(S["x"], 1))[0]
    assert eng.delete([gid]) == 1
    with pytest.raises(ValueError):
        eng.delete([-1])


# ---------------------------------------------------------------------------
# Delta segment
# ---------------------------------------------------------------------------

def test_delta_capacity_overflow(S):
    eng = make_engine(S, capacity=8)
    eng.insert(new_rows(S["x"], 5))
    with pytest.raises(DeltaFullError, match="consolidate"):
        eng.insert(new_rows(S["x"], 4))
    assert eng.delta.count == 5
    eng.insert(new_rows(S["x"], 3))
    assert np.isfinite(_np(eng.search(T_(S["q"][:4]), k=5, h=16).dists)[:, 0]).all()


def test_delta_segment_equals_jax(S, monkeypatch):
    """Appends in batches give the reference's vectors, codes and greedy
    adjacency exactly — also with the distance block cut into row chunks."""
    rows = new_rows(S["x"], 150, seed=3)
    codes = np.random.default_rng(3).integers(0, K, (150, M)).astype(np.uint8)
    jd = JDelta(200, D, M, degree=6)
    for s, e in ((0, 1), (1, 40), (40, 150)):
        jd.append(rows[s:e], codes[s:e])
    for block in (None, 7 * 150):
        if block:
            monkeypatch.setattr("repro_torch.index.delta.LINK_BLOCK_ELEMS", block)
        td = DeltaSegment(200, D, M, degree=6)
        for s, e in ((0, 1), (1, 40), (40, 150)):
            td.append(rows[s:e], codes[s:e])
        for name in ("vectors", "codes", "neighbors"):
            np.testing.assert_array_equal(getattr(td, name), getattr(jd, name), err_msg=name)
        assert td.count == jd.count and td.memory_bytes() == jd.memory_bytes()


def test_k512_int32_codes_roundtrip_equals_jax(S):
    """K > 256 quantizers encode to int32 codes; the delta stores them
    unclipped, the int32 kernels' plain versions score them, and the
    results equal the reference's."""
    r = np.random.default_rng(3)
    cb = r.normal(size=(4, 512, 8)).astype(np.float32)
    model = convert.quantizer_from_numpy(np.eye(D, dtype=np.float32), cb, device="cpu")
    jmodel = jbase.QuantizerModel(r=jnp.eye(D), codebooks=jnp.asarray(cb))
    codes = encode_codes(model, T_(S["x"]), "u8")
    assert codes.dtype == torch.int32 and int(codes.max()) > 255
    eng = StreamingEngine(BaseSegment(graph=S["tgraph"], codes=codes, vectors=T_(S["x"])),
                          model, delta_capacity=8, device="cpu")
    jeng = JEngine(JBase(graph=S["jgraph"], codes=jnp.asarray(_np(codes)),
                         vectors=jnp.asarray(S["x"])), jmodel, delta_capacity=8)
    assert eng.delta.codes.dtype == np.int32
    rows = new_rows(S["x"], 4)
    gids = eng.insert(rows)
    np.testing.assert_array_equal(gids, jeng.insert(rows))
    np.testing.assert_array_equal(eng.delta.codes, jeng.delta.codes)
    res = eng.search(T_(rows), k=3, h=32)
    assert (_np(res.ids)[:, 0] == gids).all()
    jres = jeng.search(jnp.asarray(rows), k=3, h=32)
    np.testing.assert_array_equal(_np(res.ids), np.asarray(jres.ids))
    np.testing.assert_allclose(_np(res.dists), np.asarray(jres.dists), rtol=RTOL, atol=ATOL)


def test_inserted_rows_are_found(S):
    eng = make_engine(S)
    rows = new_rows(S["x"], 16)
    gids = eng.insert(rows)
    assert (_np(eng.search(T_(rows), k=3, h=32).ids)[:, 0] == gids).all()


# ---------------------------------------------------------------------------
# Search and merge vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,kw", [
    ("u8", {}), ("u8", {"entries": 4}), ("u8", {"prune_eps": 0.2, "m_prefix": 2}),
    ("u8", {"skip_delta": True}), ("u8", {"max_rounds": 3}),
    ("fs4", {}), ("fs4", {"entries": 4, "expand": 2})])
def test_search_equals_jax(S, layout, kw):
    """After inserts and deletes (base, delta and the medoid), the two-arm
    search equals the reference's: ids, counters, distances."""
    codes = _tie_free(layout)
    eng = make_engine(S, layout, codes=codes)
    jeng = make_jax_engine(S, layout, codes)
    _inject(eng, jeng, layout)
    rows = new_rows(S["x"], 40, seed=11)
    for e in (eng, jeng):
        gids = e.insert(rows)
        e.delete(np.arange(0, N, 7))
        e.delete(gids[::4])
        e.delete([int(S["tgraph"].medoid)])
    np.testing.assert_array_equal(eng.delta.codes, jeng.delta.codes)
    assert eng._entry == jeng._entry and eng.n_live == jeng.n_live
    _assert_same(eng.search(T_(S["q"]), k=10, h=16, **kw),
                 jeng.search(jnp.asarray(S["q"]), k=10, h=16, **kw))


def test_merge_puts_fresh_inserts_first_on_ties(S):
    """A delta row with a base row's exact codes ties with it; the delta
    lane wins (read-your-writes), in both packages, and a beam sentinel or
    an +inf candidate reports -1."""
    from repro.index.engine import _merge_delta as j_merge
    from repro_torch.index.engine import _merge_delta as t_merge

    codes = _tie_free("u8")
    luts = _int_luts("u8")[:2]
    beam_ids = np.array([[3, 9, N, N], [5, N, N, N]], np.int32)
    beam_d = np.asarray(jops.hop_adc(codes, np.minimum(beam_ids, N - 1), luts))
    beam_d = np.where(beam_ids < N, beam_d, np.inf).astype(np.float32)
    delta = np.zeros((6, M), np.uint8)
    delta[2], delta[4] = codes[9], codes[5]        # exact twins of base rows
    live = np.array([False, True, True, True, True, False])
    jids, jd = j_merge(jnp.asarray(beam_ids), jnp.asarray(beam_d), jnp.asarray(delta),
                       jnp.asarray(luts), jnp.asarray(live), k=8, n_base=N)
    tids, td = t_merge(T_(beam_ids), T_(beam_d), T_(delta), T_(luts), T_(live),
                       k=8, n_base=N)
    np.testing.assert_array_equal(_np(tids), np.asarray(jids))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=RTOL, atol=ATOL)
    row0 = list(_np(tids)[0])
    assert row0.index(N + 2) == row0.index(9) - 1
    assert (_np(tids)[~np.isfinite(_np(td))] == -1).all()


def test_merge_float_luts_puts_delta_twin_first():
    """Float LUTs at M=32: a delta row with a live base row's codes scores
    the same float through the beam's ``ops.hop_adc`` and through the delta
    arm's scan, so the merge ranks the delta twin just before its base
    twin (read-your-writes) on the CPU route too."""
    from repro_torch.index.engine import _merge_delta
    from repro_torch.kernels import ops

    r = np.random.default_rng(21)
    n, m, k, q, r_beam = 300, 32, 256, 6, 16
    codes = r.integers(0, k, (n, m)).astype(np.uint8)
    luts = (r.random((q, m, k)) * 20).astype(np.float32)
    beam_ids = np.stack([r.permutation(n)[:r_beam] for _ in range(q)]).astype(np.int32)
    beam_d = ops.hop_adc(T_(codes), T_(beam_ids), T_(luts))
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    beam_ids = np.take_along_axis(beam_ids, _np(order), 1)
    twin_of = beam_ids[:, :4].reshape(-1)               # base id of each delta slot
    delta = codes[twin_of]
    ids, d = _merge_delta(T_(beam_ids), beam_d, T_(delta), T_(luts),
                          torch.ones(len(delta), dtype=torch.bool), k=8, n_base=n)
    ids, d = _np(ids), _np(d)
    checked = 0
    for row, drow in zip(ids, d):
        pos = {int(g): i for i, g in enumerate(row)}
        for slot, b in enumerate(twin_of):
            if int(b) in pos:
                assert n + slot in pos, (b, slot, row)
                assert pos[n + slot] < pos[int(b)], (b, slot, row)
                assert drow[pos[n + slot]] == drow[pos[int(b)]]
                checked += 1
    assert checked >= q


# ---------------------------------------------------------------------------
# Consolidation and snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["u8", "fs4"])
def test_consolidate_equals_jax(S, layout):
    codes = _np(encode_codes(S["models"][layout], T_(S["x"]), layout))
    eng = make_engine(S, layout, codes=codes)
    jeng = make_jax_engine(S, layout, codes)
    rows = new_rows(S["x"], 60, seed=13)
    for e in (eng, jeng):
        gids = e.insert(rows)
        e.delete(np.arange(0, 300, 3))
        e.delete(gids[:12])
    np.testing.assert_array_equal(eng.delta.codes, jeng.delta.codes)
    ts, js = eng.consolidate(), jeng.consolidate()
    np.testing.assert_array_equal(ts["old2new"], js["old2new"])
    for name in ("generation", "n", "dropped", "folded", "refreshed"):
        assert ts[name] == js[name], name
    np.testing.assert_array_equal(_np(eng.base.codes), np.asarray(jeng.base.codes))
    np.testing.assert_array_equal(_np(eng.base.vectors), np.asarray(jeng.base.vectors))
    assert int(eng.base.graph.medoid) == int(jeng.base.graph.medoid)
    same = (_np(eng.base.graph.neighbors) == np.asarray(jeng.base.graph.neighbors)).all(1)
    assert same.mean() >= 0.99, same.mean()


def test_consolidate_snapshot_and_restore(S, tmp_path):
    eng = make_engine(S)
    gids = eng.insert(new_rows(S["x"], 50))
    eng.delete(np.arange(0, 200, 4))
    eng.delete(gids[:10])
    n_live = eng.n_live
    stats = eng.consolidate(ckpt_dir=str(tmp_path))
    assert stats["generation"] == eng.generation == 1
    assert stats["n"] == n_live == eng.base.n
    assert eng.tombstones.count == 0 and eng.delta.count == 0
    o2n = stats["old2new"]
    assert (o2n[np.arange(0, 200, 4)] == -1).all() and (o2n[gids[:10]] == -1).all()
    assert (np.sort(o2n[o2n >= 0]) == np.arange(stats["n"])).all()
    res = eng.search(T_(S["q"]), k=10, h=32)
    restored = StreamingEngine.restore(str(tmp_path), S["models"]["u8"], device="cpu")
    assert restored.generation == 1 and restored.base.n == stats["n"]
    res2 = restored.search(T_(S["q"]), k=10, h=32)
    assert torch.equal(res.ids, res2.ids) and torch.equal(res.dists, res2.dists)
    wrong = train_pq(T_(S["x"]), 4, 32, generator=torch.Generator().manual_seed(8),
                     iters=2, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        StreamingEngine.restore(str(tmp_path), wrong, device="cpu")


def test_consolidate_all_dead_raises(S):
    eng = make_engine(S)
    eng.delete(np.arange(N))
    with pytest.raises(ValueError, match="every row is tombstoned"):
        eng.consolidate()


@pytest.mark.parametrize("layout", ["u8", "fs4"])
def test_snapshots_restore_across_packages(S, tmp_path, layout):
    """JAX ``save_segment`` → port ``load_segment`` and back, with the
    quantizer, with and without the vectors: every array equal."""
    codes = _np(encode_codes(S["models"][layout], T_(S["x"]), layout))
    jseg = JBase(graph=S["jgraph"], codes=jnp.asarray(codes), vectors=jnp.asarray(S["x"]),
                 layout=layout, generation=3)
    j_save_segment(str(tmp_path / "j"), jseg, model=S["jmodels"][layout])
    seg, model = load_segment(str(tmp_path / "j"), with_model=True, device="cpu")
    assert seg.generation == 3 and seg.layout == layout
    np.testing.assert_array_equal(_np(seg.graph.neighbors), np.asarray(S["jgraph"].neighbors))
    assert int(seg.graph.medoid) == int(S["jgraph"].medoid)
    np.testing.assert_array_equal(_np(seg.codes), codes)
    np.testing.assert_array_equal(_np(seg.vectors), S["x"])
    np.testing.assert_array_equal(_np(model.codebooks), np.asarray(S["jmodels"][layout].codebooks))
    lean = load_segment(str(tmp_path / "j"), with_vectors=False, device="cpu")
    assert lean.vectors is None and lean.dim == D

    save_segment(str(tmp_path / "t"), seg, model=model)
    back, jmodel = j_load_segment(str(tmp_path / "t"), with_model=True)
    assert back.generation == 3 and back.layout == layout
    for name in ("neighbors", "medoid"):
        np.testing.assert_array_equal(np.asarray(getattr(back.graph, name)),
                                      np.asarray(getattr(S["jgraph"], name)))
    np.testing.assert_array_equal(np.asarray(back.codes), codes)
    np.testing.assert_array_equal(np.asarray(back.vectors), S["x"])
    np.testing.assert_array_equal(np.asarray(jmodel.r), _np(model.r))
    # the port's snapshot is the reference's file for file, byte for byte
    for name in ("index.json", "index.npz"):
        a = (tmp_path / "j" / "step_00000003" / name).read_bytes()
        b = (tmp_path / "t" / "step_00000003" / name).read_bytes()
        assert a == b, name


def test_restore_falls_back_past_a_corrupt_generation(S, tmp_path):
    eng = make_engine(S)
    eng.delete(np.arange(10))
    eng.consolidate(ckpt_dir=str(tmp_path))
    eng.delete(np.arange(10))
    eng.consolidate(ckpt_dir=str(tmp_path))
    assert corrupt_snapshot(str(tmp_path), seed=1) == 2
    seen = []
    back = StreamingEngine.restore(str(tmp_path), retry=RetryPolicy(), device="cpu",
                                   on_fallback=lambda g, e: seen.append((g, type(e))))
    assert back.generation == 1 and seen == [(2, tckpt.ChecksumError)]
    with pytest.raises(tckpt.ChecksumError):
        load_segment(str(tmp_path), 2, device="cpu")


@pytest.mark.parametrize("layout", ["u8", "fs4"])
def test_churn_recall_vs_rebuild(S, layout):
    """10% inserts + 10% deletes: live serving within 3 recall points of a
    full rebuild on the post-churn corpus; within 1 point after
    consolidate()."""
    x, q = S["x"], S["q"]
    model = S["models"][layout]
    frac = N // 10
    dead = np.random.default_rng(17).choice(N, frac, replace=False)
    xnew = new_rows(x, frac, seed=21)
    eng = make_engine(S, layout, capacity=frac)
    gids = eng.insert(xnew)
    eng.delete(dead)
    live_base = np.setdiff1d(np.arange(N), dead)
    corpus = np.concatenate([x[live_base], xnew])
    gid_of = np.concatenate([live_base, gids])
    gt = knn_ids(T_(corpus), T_(q), 10)[0].numpy()
    gt_gid = gid_of[gt]
    r_live = recall_at_k(eng.search(T_(q), k=10, h=32).ids, gt_gid, 10)
    rebuild = BaseSegment.build(T_(corpus), model, generator=torch.Generator().manual_seed(7),
                                layout=layout, r=12, l=24, device="cpu")
    r_rebuild = recall_at_k(StreamingEngine(rebuild, model, device="cpu")
                            .search(T_(q), k=10, h=32).ids, gt, 10)
    assert r_live >= r_rebuild - 0.03, (r_live, r_rebuild)
    stats = eng.consolidate()
    gt_new = stats["old2new"][gt_gid]
    assert (gt_new >= 0).all()
    r_cons = recall_at_k(eng.search(T_(q), k=10, h=32).ids, gt_new, 10)
    assert r_cons >= r_rebuild - 0.01, (r_cons, r_rebuild)


# ---------------------------------------------------------------------------
# Feature sampling under churn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def C(S):
    """20% of the vertices tombstoned (the reference's churn fixture)."""
    ts = JTombstones(N)
    dead = np.sort(np.random.default_rng(5).choice(N, N // 5, replace=False))
    ts.add(dead)
    live = np.setdiff1d(np.arange(N), dead)
    return dict(words=ts._words, dead=dead, live=live)


def _jax_triplet_draws(key, b):
    keys = jax.random.split(key, b)
    kp, kn = jax.vmap(jax.random.split, out_axes=1)(keys)
    rint = jax.vmap(lambda k, hi: jax.random.randint(k, (), 0, hi))

    def draws(pos_span, neg_span):
        pos = rint(kp, jnp.maximum(jnp.asarray(_np(pos_span), jnp.int32), 1))
        neg = rint(kn, jnp.maximum(jnp.asarray(_np(neg_span), jnp.int32), 1))
        return T_(pos).long(), T_(neg).long()
    return draws


@pytest.mark.parametrize("which", ["live", "dead"])
def test_triplets_under_churn_equal_jax(S, C, which):
    """Live anchors: no dead leg, most triplets valid; dead anchors: every
    triplet invalid. Both exactly the reference's (its draws injected)."""
    pool = C["live"] if which == "live" else C["dead"]
    anchors = np.random.default_rng(2).choice(pool, 64, replace=False).astype(np.int32)
    key = jax.random.PRNGKey(1)
    jt = jF.sample_triplets(key, S["jgraph"], jnp.asarray(S["x"]), jnp.asarray(anchors),
                            tombstones=jnp.asarray(C["words"]))
    tt = F.sample_triplets(S["tgraph"], T_(S["x"]), T_(anchors),
                           draws=_jax_triplet_draws(key, 64), tombstones=C["words"])
    for name in F.TripletBatch._fields:
        np.testing.assert_array_equal(_np(getattr(tt, name)), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    ok = _np(tt.valid)
    if which == "dead":
        assert not ok.any()
    else:
        assert ok.mean() > 0.8
        assert not np.isin(_np(tt.vpos)[ok], C["dead"]).any()
        assert not np.isin(_np(tt.vneg)[ok], C["dead"]).any()


@pytest.mark.parametrize("entry", [None, "live"])
def test_routing_under_churn_equals_jax(S, C, entry):
    """Tie-free codes and the same LUTs: candidates, labels and valid flags
    equal the reference's; no dead id survives, and each label is the
    exact-distance argmin over the live candidates."""
    codes = _tie_free("u8")
    luts = _int_luts("u8")
    q = S["x"][C["live"][:NQ]]
    start = None if entry is None else int(C["live"][3])
    jb = jF.sample_routing(S["jgraph"], jnp.asarray(S["x"]), jnp.asarray(q),
                           jnp.asarray(codes), lambda _: jnp.asarray(luts), h=8,
                           trace_len=12, tombstones=jnp.asarray(C["words"]),
                           entry=None if start is None else jnp.int32(start))
    tb = F.sample_routing(S["tgraph"], T_(S["x"]), T_(q), T_(codes), lambda _: T_(luts),
                          h=8, trace_len=12, tombstones=C["words"], entry=start)
    for name in ("cand", "label", "valid"):
        np.testing.assert_array_equal(_np(getattr(tb, name)), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    cand, ok = _np(tb.cand), _np(tb.valid)
    assert not np.isin(cand, C["dead"]).any()
    dex = ((S["x"][np.minimum(cand, N - 1)] - _np(tb.q)[:, None]) ** 2).sum(-1)
    dex = np.where(cand == N, np.inf, dex)
    assert (_np(tb.label)[ok] == np.argmin(dex, axis=1)[ok]).all()


def test_tombstone_pattern_changes_the_draw_not_the_shapes(S, C):
    """The bitset is data, not configuration: two churn patterns give
    batches of one shape, and each masks only its own dead ids."""
    anchors = T_(np.arange(0, 256, 2))
    draws = lambda: F.uniform_draws(torch.Generator().manual_seed(0))
    other = JTombstones(N)
    other.add(np.arange(1, N, 9))
    a = F.sample_triplets(S["tgraph"], T_(S["x"]), anchors, draws=draws(),
                          tombstones=C["words"])
    b = F.sample_triplets(S["tgraph"], T_(S["x"]), anchors, draws=draws(),
                          tombstones=other._words)
    assert all(x.shape == y.shape for x, y in zip(a, b))
    assert not torch.equal(a.valid, b.valid) or not torch.equal(a.vpos, b.vpos)
    assert not np.isin(_np(b.vpos)[_np(b.valid)], np.arange(1, N, 9)).any()


def test_sampling_is_seeded_deterministic(S, C):
    anchors = T_(C["live"][:64])
    runs = [F.sample_triplets(S["tgraph"], T_(S["x"]), anchors, tombstones=C["words"],
                              generator=torch.Generator().manual_seed(4)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_no_tombstones_path_unchanged(S):
    """``tombstones=None`` and an all-clear bitset give the same features."""
    anchors = T_(np.arange(0, 128))
    draws = lambda: F.uniform_draws(torch.Generator().manual_seed(1))
    a = F.sample_triplets(S["tgraph"], T_(S["x"]), anchors, draws=draws())
    b = F.sample_triplets(S["tgraph"], T_(S["x"]), anchors, draws=draws(),
                          tombstones=np.zeros(bitset_words(N), np.uint32))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fit_under_churn_samples_live_ids_only(S, C, monkeypatch):
    """``fit(tombstones=)``: every anchor and routing query is live, the
    bitset reaches both samplers, and an all-dead bitset raises."""
    seen = {"anchors": [], "routing": []}
    real_trip, real_route = F.sample_triplets, F.sample_routing

    def trip(graph, x, anchors, **kw):
        seen["anchors"].append(_np(anchors))
        assert kw["tombstones"] is not None
        return real_trip(graph, x, anchors, **kw)

    def route(graph, x, queries, *a, **kw):
        seen["routing"].append(_np(queries))
        assert kw["tombstones"] is not None
        return real_route(graph, x, queries, *a, **kw)

    monkeypatch.setattr(F, "sample_triplets", trip)
    monkeypatch.setattr(F, "sample_routing", route)
    from repro_torch.core import quantizer as Q
    cfg = Q.RPQConfig(dim=D, m=M, k=K, learn_rotation=False)
    tcfg = T.TrainConfig(steps=3, triplet_batch=32, routing_batch=32,
                         routing_pool_queries=8, refresh_every=2, log_every=1)
    params = Q.init_params(cfg, S["models"]["u8"].codebooks)
    T.fit(cfg, tcfg, T_(S["x"]), S["tgraph"], params=params, tombstones=C["words"],
          verbose=False, device="cpu")
    assert not np.isin(np.concatenate(seen["anchors"]), C["dead"]).any()
    live_rows = {tuple(r) for r in S["x"][C["live"]]}
    assert all(tuple(r) in live_rows for r in np.concatenate(seen["routing"]))
    with pytest.raises(ValueError, match="every vertex is tombstoned"):
        T.fit(cfg, tcfg, T_(S["x"]), S["tgraph"], params=params, verbose=False,
              tombstones=np.full(bitset_words(N), 0xFFFFFFFF, np.uint32), device="cpu")
