"""Adaptive routing, tombstones, budgets and the degradation ladder: the
port vs the JAX package on the CPU, both routing on one graph (built by
the port, handed to JAX as arrays).

Exactness: the LUTs are INTEGER-valued f32 with K a power of two (the fs4
tables uint8 with a power-of-two scale and a bias on a 1/64 grid), so every
distance, every prefix bound and the
calibration ratio are exact in any summation order, and the pruning gate
cannot flip on a last-bit difference; then ids, dists, hops, ``n_dist``,
rounds and ``truncated`` must equal JAX's exactly (ties break toward the
lower index on both sides). The Hybrid engine's exact rerank sums f32
squares in another order: its distances are held at rtol 1e-6, its ids
exactly. ``io_time`` at rtol 1e-6."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.graphs.adjacency import Graph as JGraph
from repro.graphs.knn import knn_ids as j_knn_ids
from repro.pq import pack as jpack
from repro.search import beam as jbeam
from repro.search import degrade as jdegrade
from repro.search import seed as jseed
from repro.search.engine import HybridEngine as JHybrid
from repro.search.engine import InMemoryEngine as JInMemory
from repro.search.engine import ShardedEngine as JSharded
from repro.search.metrics import live_ground_truth as j_live_gt
from repro.dist.retry import RetryPolicy as JRetry
from repro_torch.graphs.vamana import build_vamana as t_build_vamana
from repro_torch.dist.retry import RetryPolicy as TRetry
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.search import beam as tbeam
from repro_torch.search import degrade as tdegrade
from repro_torch.search import seed as tseed
from repro_torch.search.engine import HybridEngine, InMemoryEngine, ShardedEngine
from repro_torch.search.metrics import live_ground_truth as t_live_gt

N, D, Q, M, K = 240, 32, 8, 4, 16
RTOL = 1e-6


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


@pytest.fixture(scope="module")
def setup():
    r = np.random.default_rng(11)
    centers = r.normal(size=(8, D)) * 2.5
    x = (centers[r.integers(0, 8, N)] + r.normal(size=(N, D))).astype(np.float32)
    q = (centers[r.integers(0, 8, Q)] + r.normal(size=(Q, D))).astype(np.float32)
    # the port's builder (no JAX compile); both packages route on it
    tgraph = t_build_vamana(T(x), generator=torch.Generator().manual_seed(1), r=12,
                            l=32, device="cpu")
    jgraph = JGraph(jnp.asarray(tgraph.neighbors.numpy()),
                    jnp.asarray(int(tgraph.medoid), jnp.int32))
    codes = r.integers(0, K, (N, M)).astype(np.uint8)
    while np.unique(codes, axis=0).shape[0] != N:  # pragma: no cover
        codes = r.integers(0, K, (N, M)).astype(np.uint8)
    luts = r.integers(0, 64, (Q, M, K)).astype(np.float32)   # integer-valued
    packed = np.asarray(jpack.pack_codes(jnp.asarray(codes)))
    # fs4: a power-of-two scale and a bias on a 1/64 grid keep the dequant
    # scale·acc + M·bias exact, fused multiply-add or not
    ql = (r.integers(0, 256, (Q, M, 16)).astype(np.uint8),
          (2.0 ** -r.integers(0, 4, Q)).astype(np.float32),
          (r.integers(0, 64, Q) / 64).astype(np.float32))
    return dict(x=x, q=q, jgraph=jgraph, tgraph=tgraph, codes=codes, luts=luts,
                packed=packed, ql=ql)


def _pad(a):
    return np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)])


_CACHE: dict = {}


def _fns(setup, packed: bool, mp: int = 0):
    """(jax dist fn, port dist fn, jax qdatas, port qdatas) for a layout;
    one set per (layout, prefix), so JAX's jit sees the same static
    callables across tests and traces each configuration once."""
    key = ("fns", packed, mp)
    if key not in _CACHE:
        _CACHE[key] = _make_fns(setup, packed, mp)
    return _CACHE[key]


def _make_fns(setup, packed: bool, mp: int):
    if packed:
        cp = _pad(setup["packed"])
        return (jbeam.make_adc_dist_fn(jnp.asarray(cp), packed=True, m_prefix=mp),
                tbeam.make_adc_dist_fn(T(cp), packed=True, m_prefix=mp),
                jpack.QuantizedLUT(*(jnp.asarray(a) for a in setup["ql"])),
                QuantizedLUT(*(T(a) for a in setup["ql"])))
    cp = _pad(setup["codes"])
    return (jbeam.make_adc_dist_fn(jnp.asarray(cp), m_prefix=mp),
            tbeam.make_adc_dist_fn(T(cp), m_prefix=mp),
            jnp.asarray(setup["luts"]), T(setup["luts"]))


def _assert_same(t_res, j_res):
    np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(j_res.ids))
    np.testing.assert_array_equal(t_res.dists.numpy(), np.asarray(j_res.dists))
    for name in ("hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(getattr(t_res, name).numpy(),
                                      np.asarray(getattr(j_res, name)), err_msg=name)


def _beams(setup, entry, *, packed=False, prune=None, ts=None, **kw):
    """The same beam on both sides. ``prune`` = (m_prefix, eps, calibrated)."""
    jfn, tfn, jq, tq = _fns(setup, packed)
    jkw, tkw = dict(kw), dict(kw)
    if prune is not None:
        mp, eps, calib = prune
        jlb, tlb, _, _ = _fns(setup, packed, mp)
        jkw.update(lb_dist_fn=jlb, m_prefix=mp, m_total=M, prune_eps=eps)
        tkw.update(lb_dist_fn=tlb, m_prefix=mp, m_total=M, prune_eps=eps)
        if calib:
            key = ("cal", packed, mp)
            if key not in _CACHE:
                _CACHE[key] = jbeam.make_lb_scale_fn(packed=packed, m_prefix=mp)
            jkw["lb_scale_fn"] = _CACHE[key]
            tkw["lb_scale_fn"] = tbeam.make_lb_scale_fn(packed=packed, m_prefix=mp)
    if ts is not None:
        jkw["tombstones"] = jnp.asarray(ts)
        tkw["tombstones"] = ts
    j_res = jbeam.beam_search(setup["jgraph"].neighbors, jnp.asarray(entry), jq, jfn,
                              **jkw)
    t_res = tbeam.beam_search(setup["tgraph"].neighbors, T(entry), tq, tfn, **tkw)
    return t_res, j_res


def _tombstones(dead):
    words = np.zeros((N + 31) // 32 + 1, np.uint32)
    for i in dead:
        words[i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    return words


def _entry_sets(setup, s=6, seed=0):
    r = np.random.default_rng(seed)
    e = r.integers(0, N, (Q, s)).astype(np.int32)
    e[:, 1] = e[:, 0]                    # a duplicate in every set
    e[0, 2:] = -1                        # padding lanes (the seeder's -1)
    e[1, 3] = N + 5                      # out of range: ignored
    e[2] = int(setup["jgraph"].medoid)   # one id repeated S times
    return e


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "fs4"])
def test_entry_set_width1_is_bit_identical_to_classic(setup, packed):
    _, tfn, _, tq = _fns(setup, packed)
    med = int(setup["jgraph"].medoid)
    nb = setup["tgraph"].neighbors
    runs = [tbeam.beam_search(nb, e, tq, tfn, h=16, expand=2)
            for e in (med, T(np.full(Q, med, np.int32)), T(np.full((Q, 1), med, np.int32)))]
    for res in runs[1:]:
        for name in ("ids", "dists", "hops", "n_dist", "rounds", "truncated"):
            assert torch.equal(getattr(res, name), getattr(runs[0], name)), name


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "fs4"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("h", [4, 16])
def test_multi_entry_equals_jax(setup, packed, expand, h):
    t_res, j_res = _beams(setup, _entry_sets(setup), packed=packed, h=h, expand=expand)
    _assert_same(t_res, j_res)


@pytest.mark.parametrize("entry", ["medoid", "sets"])
@pytest.mark.parametrize("expand", [1, 3])
def test_tombstones_equal_jax(setup, entry, expand):
    """Word-boundary ids, a dead medoid and random deaths; dead ids never
    come back, and everything else equals JAX."""
    med = int(setup["jgraph"].medoid)
    dead = [31, 32, 63, 64, 95, 96, med] + list(np.random.default_rng(3).integers(0, N, 30))
    ts = _tombstones(dead)
    e = med if entry == "medoid" else _entry_sets(setup, seed=2)
    for budget in (None, 2):
        t_res, j_res = _beams(setup, e, ts=ts, h=16, expand=expand, max_rounds=budget)
        _assert_same(t_res, j_res)
        assert not np.isin(t_res.ids.numpy(), dead).any()


def test_all_dead_entry_set_still_routes(setup):
    e = _entry_sets(setup, s=4, seed=5)
    e = np.where(e < 0, 0, np.where(e >= N, 0, e)).astype(np.int32)
    ts = _tombstones(np.unique(e))
    t_res, j_res = _beams(setup, e, ts=ts, h=16)
    _assert_same(t_res, j_res)
    assert bool((t_res.hops > 1).all())           # routed off a dead seed
    assert not np.isin(t_res.ids.numpy(), np.unique(e)).any()


def test_tombstone_bitset_takes_port_int32_words(setup):
    ts = _tombstones([0, 31, 32, 200])
    a, _ = _beams(setup, int(setup["jgraph"].medoid), ts=ts, h=16)
    b = tbeam.beam_search(setup["tgraph"].neighbors, int(setup["jgraph"].medoid),
                          T(setup["luts"]), _fns(setup, False)[1], h=16,
                          tombstones=T(ts.view(np.int32)))
    assert torch.equal(a.ids, b.ids) and torch.equal(a.n_dist, b.n_dist)


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "fs4"])
@pytest.mark.parametrize("mp", [1, 2, 3])
def test_prefix_distance_is_a_lower_bound(setup, packed, mp):
    _, full, _, tq = _fns(setup, packed)
    _, part, _, _ = _fns(setup, packed, mp)
    ids = T(np.random.default_rng(mp).integers(0, N + 1, (Q, 40)).astype(np.int32))
    assert bool((part(tq, ids) <= full(tq, ids)).all())


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "fs4"])
@pytest.mark.parametrize("mp", [1, 2, 3])
def test_make_lb_scale_fn_equals_jax(setup, packed, mp):
    _, _, jq, tq = _fns(setup, packed)
    want = jax.vmap(jbeam.make_lb_scale_fn(packed=packed, m_prefix=mp))(jq)
    got = tbeam.make_lb_scale_fn(packed=packed, m_prefix=mp)(tq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "fs4"])
@pytest.mark.parametrize("prune,expand", [((1, 0.1, False), 1), ((2, 0.5, False), 4),
                                          ((1, 0.2, True), 4), ((3, 0.05, True), 1)])
def test_pruned_search_equals_jax(setup, packed, prune, expand):
    t_res, j_res = _beams(setup, int(setup["jgraph"].medoid), packed=packed,
                          prune=prune, h=16, expand=expand)
    _assert_same(t_res, j_res)
    t_set, j_set = _beams(setup, _entry_sets(setup, seed=7), packed=packed, prune=prune,
                          h=16, expand=expand)
    _assert_same(t_set, j_set)


def test_pruning_cuts_distance_work(setup):
    plain, _ = _beams(setup, int(setup["jgraph"].medoid), h=16)
    pruned, _ = _beams(setup, int(setup["jgraph"].medoid), prune=(1, 0.1, True), h=16)
    assert float(pruned.n_dist.float().mean()) < float(plain.n_dist.float().mean())


@pytest.mark.parametrize("budget", [dict(max_rounds=1), dict(max_rounds=7),
                                    dict(max_n_dist=20), dict(max_rounds=4, max_n_dist=40)])
@pytest.mark.parametrize("prune", [None, (2, 0.2, True)])
def test_budgets_equal_jax(setup, budget, prune):
    t_res, j_res = _beams(setup, int(setup["jgraph"].medoid), prune=prune, h=16,
                          expand=2, **budget)
    _assert_same(t_res, j_res)
    if "max_rounds" in budget:
        assert int(t_res.rounds.max()) <= budget["max_rounds"]
    if budget.get("max_rounds") == 1:
        assert bool(t_res.truncated.any())


@pytest.mark.parametrize("prune", [None, (2, 0.2, False)])
def test_budget_none_is_a_huge_budget(setup, prune):
    med = int(setup["jgraph"].medoid)
    none, _ = _beams(setup, med, prune=prune, h=16)
    huge, _ = _beams(setup, med, prune=prune, h=16, max_rounds=10**6, max_n_dist=10**6)
    for name in ("ids", "dists", "hops", "n_dist", "rounds", "truncated"):
        assert torch.equal(getattr(none, name), getattr(huge, name)), name
    assert not bool(none.truncated.any())


@pytest.mark.parametrize("trace_len", [3, 40])
def test_trace_with_budget_and_pruning_equals_jax(setup, trace_len):
    jfn, tfn, jq, tq = _fns(setup, False)
    jlb, tlb, _, _ = _fns(setup, False, 2)
    kw = dict(h=16, trace_len=trace_len, m_prefix=2, m_total=M, prune_eps=0.2,
              max_rounds=5)
    j_tr = jbeam.beam_search_trace(setup["jgraph"].neighbors, jnp.asarray(_entry_sets(setup)),
                                   jq, jfn, lb_dist_fn=jlb, **kw)
    t_tr = tbeam.beam_search_trace(setup["tgraph"].neighbors, T(_entry_sets(setup)),
                                   tq, tfn, lb_dist_fn=tlb, **kw)
    _assert_same(t_tr.result, j_tr.result)
    for name in ("beam_ids", "beam_dists", "hop_valid"):
        np.testing.assert_array_equal(getattr(t_tr, name).numpy(),
                                      np.asarray(getattr(j_tr, name)), err_msg=name)


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,m,n,kw", [(16, 4, N, {}), (256, 16, 3000, {}),
                                      (16, 4, 5000, dict(bucket_cap=4, n_pivots=7)),
                                      (64, 8, 777, dict(m_hash=1))])
def test_build_seed_index_equals_jax(k, m, n, kw):
    codes = np.random.default_rng(k + m).integers(0, k, (n, m)).astype(np.uint8)
    j_ix = jseed.build_seed_index(codes, **kw)
    t_ix = tseed.build_seed_index(codes, device="cpu", **kw)
    np.testing.assert_array_equal(t_ix.table.numpy(), np.asarray(j_ix.table))
    np.testing.assert_array_equal(t_ix.pivots.numpy(), np.asarray(j_ix.pivots))
    assert (t_ix.k, t_ix.m_hash, t_ix.n_candidates) == (j_ix.k, j_ix.m_hash,
                                                         j_ix.n_candidates)
    assert tseed.auto_m_hash(m, k) == jseed.auto_m_hash(m, k)


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "fs4"])
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("dead", [False, True])
def test_seed_entries_from_equals_jax(setup, packed, s, dead):
    j_ix = jseed.build_seed_index(setup["codes"], bucket_cap=4, n_pivots=8)
    t_ix = tseed.build_seed_index(setup["codes"], bucket_cap=4, n_pivots=8, device="cpu")
    _, _, jq, tq = _fns(setup, packed)
    ts = _tombstones(range(0, N, 3)) if dead else None
    j_codes = jnp.asarray(setup["codes"].astype(np.int32))
    want = jseed.seed_entries_from(j_ix.table, j_ix.pivots, j_codes, jq,
                                   None if ts is None else jnp.asarray(ts),
                                   k=j_ix.k, m_hash=j_ix.m_hash, s=s)
    scodes = T(setup["packed"]) if packed else t_ix.codes
    got = tseed.seed_entries_from(t_ix.table, t_ix.pivots, scodes, tq, ts,
                                  k=t_ix.k, m_hash=t_ix.m_hash, s=s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _engines(setup, packed: bool):
    """JAX and port InMemory/Hybrid engines over the same codes and graph,
    with a lut_fn that hands back the fixture's tables for the batch; built
    once per layout (the JAX engines cache their jitted dist fns)."""
    key = ("engines", packed)
    if key not in _CACHE:
        _CACHE[key] = _make_engines(setup, packed)
    return _CACHE[key]


def _make_engines(setup, packed: bool):
    if packed:
        codes = setup["packed"]
        jl = jpack.QuantizedLUT(*(jnp.asarray(a) for a in setup["ql"]))
        tl = QuantizedLUT(*(T(a) for a in setup["ql"]))
    else:
        codes = setup["codes"]
        jl, tl = jnp.asarray(setup["luts"]), T(setup["luts"])
    jx = jnp.asarray(setup["x"])
    j = (JInMemory(setup["jgraph"], jnp.asarray(codes), lambda q: jl),
         JHybrid(setup["jgraph"], jnp.asarray(codes), lambda q: jl, vectors=jx))
    t = (InMemoryEngine(setup["tgraph"], T(codes), lambda q: tl, device="cpu"),
         HybridEngine(setup["tgraph"], T(codes), lambda q: tl, vectors=T(setup["x"]),
                      device="cpu"))
    return j, t


def _assert_engine_same(t_res, j_res, exact_dists=True):
    np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(j_res.ids))
    for name in ("hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(getattr(t_res, name).numpy(),
                                      np.asarray(getattr(j_res, name)), err_msg=name)
    if exact_dists:
        np.testing.assert_array_equal(t_res.dists.numpy(), np.asarray(j_res.dists))
    else:
        np.testing.assert_allclose(t_res.dists.numpy(), np.asarray(j_res.dists), rtol=RTOL)


ENGINE_KW = [dict(), dict(entries=8), dict(prune_eps=0.2, m_prefix=2),
             dict(entries=8, prune_eps=0.2, m_prefix=2, expand=4),
             dict(prune_eps=0.5, max_rounds=3), dict(max_n_dist=40, entries=4)]


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "fs4"])
@pytest.mark.parametrize("kw", ENGINE_KW, ids=lambda kw: ",".join(kw) or "default")
def test_inmemory_engine_knobs_equal_jax(setup, packed, kw):
    (jm, _), (tm, _) = _engines(setup, packed)
    _assert_engine_same(tm.search(T(setup["q"]), k=10, h=16, **kw),
                        jm.search(jnp.asarray(setup["q"]), k=10, h=16, **kw))


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "fs4"])
@pytest.mark.parametrize("rerank", [0, 12, -1])
@pytest.mark.parametrize("kw", [dict(), dict(entries=8, prune_eps=0.2, m_prefix=2,
                                             max_rounds=4)], ids=["default", "adaptive"])
def test_hybrid_engine_rerank_and_knobs_equal_jax(setup, packed, rerank, kw):
    (_, jh), (_, th) = _engines(setup, packed)
    t_res = th.search(T(setup["q"]), k=10, h=16, rerank=rerank, **kw)
    j_res = jh.search(jnp.asarray(setup["q"]), k=10, h=16, rerank=rerank, **kw)
    _assert_engine_same(t_res, j_res, exact_dists=rerank < 0)
    assert t_res.ids.shape[1] == min(10, 12 if rerank == 12 else 16)


def test_hybrid_skip_rerank_answers_from_the_beam(setup):
    (_, _), (tm, th) = _engines(setup, False)
    a = th.search(T(setup["q"]), k=10, h=16, rerank=-1)
    b = tm.search(T(setup["q"]), k=10, h=16)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


@pytest.mark.parametrize("kw", [dict(), dict(entries=8), dict(expand=4, entries=4),
                                dict(io_fault_p=0.1, retry="policy"),
                                dict(io_fault_p=0.5, retry="policy", entries=8),
                                dict(io_fault_p=0.1), dict(measured_io_s=0.0123)])
def test_hybrid_io_time_equals_jax(setup, kw):
    (_, jh), (_, th) = _engines(setup, False)
    s = dict(entries=kw.get("entries", 1), expand=kw.get("expand", 1))
    t_res = th.search(T(setup["q"]), k=10, h=16, **s)
    j_res = jh.search(jnp.asarray(setup["q"]), k=10, h=16, **s)
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("retry") == "policy":
        tkw["retry"], jkw["retry"] = TRetry(), JRetry()
    np.testing.assert_allclose(th.io_time(t_res, **tkw).numpy(),
                               np.asarray(jh.io_time(j_res, **jkw)), rtol=RTOL)
    # a result without rounds falls back to the ceil(hops / E) model
    t_res.rounds = None
    j_res = j_res._replace(rounds=None)
    np.testing.assert_allclose(th.io_time(t_res, **tkw).numpy(),
                               np.asarray(jh.io_time(j_res, **jkw)), rtol=RTOL)


def test_seed_index_is_lazy_and_scores_on_the_engine_codes(setup):
    (_, _), (tm, _) = _make_engines(setup, True)
    assert tm._seedix is None
    res = tm.search(T(setup["q"]), k=10, h=16, entries=8)
    ix = tm._seedix
    assert ix is not None and ix.codes is tm.codes
    np.testing.assert_array_equal(
        ix.table.numpy(), np.asarray(jseed.build_seed_index(setup["codes"]).table))
    assert bool((res.n_dist >= ix.n_candidates).all())


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_level", [0, 2, 4, 5])
@pytest.mark.parametrize("level", [-1, 0, 1, 2, 3, 4, 5, 9])
def test_degradation_overrides_equal_jax(max_level, level):
    t = tdegrade.DegradationPolicy(max_level=max_level, prune_eps=0.4)
    j = jdegrade.DegradationPolicy(max_level=max_level, prune_eps=0.4)
    assert t.overrides(level) == j.overrides(level)
    assert t.clamp(level) == j.clamp(level)


def test_degradation_policy_validates_like_jax():
    for mod in (tdegrade, jdegrade):
        with pytest.raises(ValueError):
            mod.DegradationPolicy(max_level=mod.MAX_LEVEL + 1)
    assert tdegrade.MAX_LEVEL == jdegrade.MAX_LEVEL
    assert tdegrade.AGGRESSIVE_PRUNE_EPS == jdegrade.AGGRESSIVE_PRUNE_EPS


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, 5])
def test_degradation_apply_per_engine_equals_jax(setup, level):
    """One policy, every engine: the overrides an engine's ``search`` cannot
    take are filtered the same way on both sides, and the port engines
    run the resulting kwargs."""
    (jm, jh), (tm, th) = _engines(setup, False)
    js = JSharded(jnp.asarray(setup["codes"]), lambda q: jnp.asarray(setup["luts"]))
    ts_ = ShardedEngine(T(setup["codes"]), lambda q: T(setup["luts"]), device="cpu")
    base = dict(h=16, expand=4, entries=8, prune_eps=0.1)
    for t_eng, j_eng in ((tm, jm), (th, jh), (ts_, js)):
        t_kw = tdegrade.DegradationPolicy().apply(t_eng, level, **base)
        j_kw = jdegrade.DegradationPolicy().apply(j_eng, level, **base)
        assert t_kw == j_kw, type(t_eng).__name__
        t_res = tdegrade.DegradationPolicy().search(t_eng, T(setup["q"]), level=level,
                                                    k=10, **base)
        if not isinstance(t_eng, ShardedEngine):
            j_res = j_eng.search(jnp.asarray(setup["q"]), k=10, **j_kw)
            _assert_engine_same(t_res, j_res, exact_dists=not isinstance(t_eng, HybridEngine)
                                or level >= 4)


@pytest.mark.parametrize("observed,current", [(0.02, 0), (0.02, 5), (0.005, 3),
                                              (0.009, 3), (0.0099, 0), (0.5, 4)])
def test_recommend_level_equals_jax(observed, current):
    for max_level in (3, 5):
        t = tdegrade.recommend_level(tdegrade.DegradationPolicy(max_level=max_level),
                                     observed_s=observed, deadline_s=0.01, current=current)
        j = jdegrade.recommend_level(jdegrade.DegradationPolicy(max_level=max_level),
                                     observed_s=observed, deadline_s=0.01, current=current)
        assert t == j


def test_live_ground_truth_equals_jax(setup):
    live = np.flatnonzero(np.random.default_rng(2).random(N) < 0.6)
    want = j_live_gt(setup["x"], live, setup["q"], 10)
    got = t_live_gt(T(setup["x"]), live, T(setup["q"]), 10)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.isin(got, live).all()
    # the reference's own knn agrees on the whole corpus
    full = t_live_gt(setup["x"], np.arange(N), setup["q"], 10)
    np.testing.assert_array_equal(full, np.asarray(j_knn_ids(jnp.asarray(setup["x"]),
                                                             jnp.asarray(setup["q"]), 10)[0]))
