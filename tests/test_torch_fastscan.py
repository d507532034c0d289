"""Port fs4 fast-scan layout vs the JAX package, on the CPU: packing and LUT
quantization bit for bit, the int32 accumulators of the two fs4 kernels'
plain versions against the Pallas kernels in interpret mode, the dequant,
the one-shard scan engine and ``partial_merge``, and the fs4 engines on
the ``clustered_data`` fixture. The CUDA kernels themselves are held
against these plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``)."""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.dist.fault import partial_merge as j_partial_merge
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.pq import base as jbase
from repro.pq import pack as jpack
from repro.pq import train_pq_fs4 as j_train_pq_fs4
from repro.search.engine import HybridEngine as JHybrid
from repro.search.engine import InMemoryEngine as JInMemory
from repro.search.engine import ShardedEngine as JSharded
from repro.search.metrics import recall_at_k as j_recall
from repro_torch import convert
from repro_torch.dist.fault import partial_merge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.pq import base as tbase
from repro_torch.pq import pack as tpack
from repro_torch.search.engine import (HybridEngine, InMemoryEngine,
                                       ShardedEngine, topk_lower)
from repro_torch.search.metrics import recall_at_k


# the kernel MODULES (repro.kernels re-exports same-named functions)
j_adcfs = importlib.import_module("repro.kernels.adc_scan_fs")
j_hop = importlib.import_module("repro.kernels.hop_adc")


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _fs_inputs(rng, n, m, q):
    """Packed codes with a zero sentinel row at n, u8 LUTs and a per-query
    affine (bias ≥ 0, as quantize_luts anchors it at the LUT minimum)."""
    codes = rng.integers(0, 16, (n + 1, m)).astype(np.uint8)
    codes[n] = 0
    packed = np.asarray(jpack.pack_codes(jnp.asarray(codes)))
    luts = rng.integers(0, 256, (q, m, 16)).astype(np.uint8)
    scale = rng.uniform(0.01, 3.0, q).astype(np.float32)
    bias = rng.uniform(0.0, 5.0, q).astype(np.float32)
    return codes, packed, luts, scale, bias


# --------------------------------------------------------------------------
# pq/pack.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 7, 8, 16])
def test_pack_unpack_bit_exact_vs_jax(m):
    rng = np.random.default_rng(m)
    codes = rng.integers(0, 16, (37, m)).astype(np.uint8)
    want = np.asarray(jpack.pack_codes(jnp.asarray(codes)))
    got = tpack.pack_codes(T(codes))
    assert got.dtype == torch.uint8 and got.shape == (37, tpack.packed_width(m))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tpack.unpack_codes(got, m)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpack.unpack_codes(jnp.asarray(want), m)))


def test_pack_masks_values_beyond_four_bits_like_jax():
    codes = np.array([[17, 255, 3], [16, 0, 31]], np.int32)
    np.testing.assert_array_equal(
        tpack.pack_codes(T(codes)).numpy(),
        np.asarray(jpack.pack_codes(jnp.asarray(codes))))


@pytest.mark.parametrize("shape", [(5, 8, 16), (3, 7, 10), (4, 16, 16)])
def test_quantize_luts_bit_exact_vs_jax(shape):
    rng = np.random.default_rng(sum(shape))
    luts = (rng.random(shape) * 40.0).astype(np.float32)
    luts[0] = 2.5                       # a constant table: scale 1, all zeros
    luts[1, 0, :4] = [0.5, 1.5, 2.5, 3.5]   # exact halves: round half to even
    want = jpack.quantize_luts(jnp.asarray(luts))
    got = tpack.quantize_luts(T(luts))
    assert isinstance(got, tpack.QuantizedLUT)
    assert got.lut.dtype == torch.uint8 and got.lut.shape == (shape[0], shape[1], 16)
    for name in ("lut", "scale", "bias"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert float(got.scale[0]) == 1.0 and int(got.lut[0].max()) == 0
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


def test_quantize_luts_rejects_k_beyond_16():
    with pytest.raises(ValueError, match="K <= 16"):
        tpack.quantize_luts(torch.zeros((1, 2, 17)))


# --------------------------------------------------------------------------
# kernels: plain versions vs the JAX oracles and Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", [7, 8])
def test_pair_lut_matches_jax(m):
    luts = np.random.default_rng(m).integers(0, 256, (3, m, 16)).astype(np.uint8)
    np.testing.assert_array_equal(tref._pair_lut(T(luts)).numpy(),
                                  np.asarray(jref._pair_lut(jnp.asarray(luts))))


@pytest.mark.parametrize("n,m,q", [(300, 8, 5), (257, 7, 3), (129, 16, 9)])
def test_adc_scan_fs_acc_matches_jax_interpret(n, m, q):
    """int32 accumulators, bit for bit: ragged N, odd M, Q off the tile."""
    rng = np.random.default_rng(n + m + q)
    _, packed, luts, scale, bias = _fs_inputs(rng, n, m, q)
    want = j_adcfs.adc_scan_fs(jnp.asarray(packed), jnp.asarray(luts),
                               block_n=128, block_q=8, interpret=True)
    got = tref.adc_scan_fs_acc(T(packed), T(luts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the f32 oracle: the same eager dequant op sequence on both sides
    np.testing.assert_array_equal(
        tref.adc_scan_fs_ref(T(packed), T(luts), T(scale), T(bias)).numpy(),
        np.asarray(jref.adc_scan_fs_ref(packed, luts, scale, bias)))


@pytest.mark.parametrize("r", [1, 64, 200])
@pytest.mark.parametrize("m,m_prefix", [(8, 0), (8, 3), (7, 0), (7, 5)])
def test_hop_adc_fs_acc_matches_jax_interpret(r, m, m_prefix):
    """int32 accumulators, bit for bit, with duplicates, row 0 and the
    sentinel row; odd M and odd m_prefix."""
    rng = np.random.default_rng(10 * r + m + m_prefix)
    n, q = 211, 5
    _, packed, luts, scale, bias = _fs_inputs(rng, n, m, q)
    ids = rng.integers(0, n + 1, (q, r)).astype(np.int32)
    if r > 1:
        ids[:, : r // 4] = ids[:, r // 4: 2 * (r // 4)]    # duplicates
        ids[0, 0], ids[0, -1] = 0, n                       # boundaries
    want = j_hop.hop_adc_fs(jnp.asarray(packed), jnp.asarray(ids),
                            jnp.asarray(luts), m=m, interpret=True,
                            m_prefix=m_prefix)
    mp = m_prefix or m
    got = tref.hop_adc_fs_acc(T(packed[:, :(mp + 1) // 2]), T(ids), T(luts[:, :mp]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not m_prefix:
        np.testing.assert_array_equal(
            tref.hop_adc_fs_ref(T(packed), T(ids), T(luts), T(scale), T(bias)).numpy(),
            np.asarray(jref.hop_adc_fs_ref(packed, ids, luts, scale, bias)))


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("m_prefix", [0, 3])
def test_ops_fs_dequantized_match_jax(backend, m_prefix):
    """ops.hop_adc_fs / ops.adc_scan_fs in f32: the JAX ops dequantize with
    the same eager op sequence, so the values are equal, not just close."""
    rng = np.random.default_rng(40 + m_prefix)
    n, m, q, r = 150, 7, 4, 48
    _, packed, luts, scale, bias = _fs_inputs(rng, n, m, q)
    ids = rng.integers(0, n + 1, (q, r)).astype(np.int32)
    want = jops.hop_adc_fs(packed, ids, luts, scale, bias, backend=backend,
                           m_prefix=m_prefix)
    got = tops.hop_adc_fs(T(packed), T(ids), T(luts), T(scale), T(bias),
                          m_prefix=m_prefix)
    assert got.dtype == torch.float32 and got.shape == (q, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jops.adc_scan_fs(packed, luts, scale, bias, backend=backend,
                            block_n=128, block_q=8)
    got = tops.adc_scan_fs(T(packed), T(luts), T(scale), T(bias))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ops_fs_dtype_boundary():
    """ops casts int32 packed codes, int64 ids and int32 LUTs once; the
    result is unchanged."""
    rng = np.random.default_rng(6)
    _, packed, luts, scale, bias = _fs_inputs(rng, 40, 6, 3)
    ids = rng.integers(0, 41, (3, 16)).astype(np.int32)
    base = tops.hop_adc_fs(T(packed), T(ids), T(luts), T(scale), T(bias))
    wide = tops.hop_adc_fs(T(packed.astype(np.int32)), T(ids.astype(np.int64)),
                           T(luts.astype(np.int32)), T(scale), T(bias))
    np.testing.assert_array_equal(base.numpy(), wide.numpy())
    np.testing.assert_array_equal(
        tops.adc_scan_fs(T(packed.astype(np.int64)), T(luts), T(scale), T(bias)).numpy(),
        tops.adc_scan_fs(T(packed), T(luts), T(scale), T(bias)).numpy())


# --------------------------------------------------------------------------
# dist/fault.py and the scan engine's top-k
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alive", [(True, True, True), (True, False, True),
                                   (False, False, False), (False, True, False)])
def test_partial_merge_matches_jax(alive):
    rng = np.random.default_rng(sum(alive))
    q, k = 6, 10
    ids = [rng.integers(0, 1000, (q, ks)).astype(np.int32) for ks in (4, 3, 2)]
    dists = [np.sort(rng.integers(0, 5, (q, ks)).astype(np.float32), axis=1)
             for ks in (4, 3, 2)]                          # ties across shards
    want = j_partial_merge(ids, dists, list(alive), k)
    got = partial_merge([T(i) for i in ids], [T(d) for d in dists], alive, k)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids)
    np.testing.assert_array_equal(got.dists.numpy(), want.dists)
    assert got.ids.dtype == torch.int32 and got.degraded == want.degraded


@pytest.mark.parametrize("k", [1, 7, 40])
def test_topk_lower_breaks_ties_like_lax_top_k(k):
    d = np.random.default_rng(k).integers(0, 6, (9, 300)).astype(np.float32)
    neg, want = jax.lax.top_k(-jnp.asarray(d), k)
    vals, idx = topk_lower(T(d), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


# --------------------------------------------------------------------------
# engines on the clustered_data fixture
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fs4(clustered_data, small_graph):
    """The JAX fs4 model of tests/test_fastscan.py, its codes and quantized
    LUTs, carried across to the port."""
    x, q, gt = clustered_data
    jm = j_train_pq_fs4(jax.random.PRNGKey(3), x, 8, iters=8)
    codes = np.asarray(jbase.encode(jm, x))
    packed = np.asarray(jpack.pack_codes(jnp.asarray(codes)))
    jql = jbase.build_lut(jm, q, quantize=True)
    jluts = np.asarray(jbase.build_lut(jm, q))
    tm = convert.quantizer_from_numpy(np.asarray(jm.r), np.asarray(jm.codebooks),
                                      device="cpu")
    tgraph = convert.graph_from_numpy(np.asarray(small_graph.neighbors),
                                      np.asarray(small_graph.medoid), device="cpu")
    tql = convert.quantized_lut_from_numpy(jql.lut, jql.scale, jql.bias, device="cpu")
    return dict(x=np.asarray(x), q=np.asarray(q), gt=np.asarray(gt), jm=jm, tm=tm,
                codes=codes, packed=packed, jql=jql, tql=tql, jluts=jluts,
                tgraph=tgraph)


def _same_ids_and_counters(t_res, j_res):
    np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(j_res.ids))
    for name in ("hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(getattr(t_res, name).numpy(),
                                      np.asarray(getattr(j_res, name)), err_msg=name)
    np.testing.assert_allclose(t_res.dists.numpy(), np.asarray(j_res.dists),
                               rtol=1e-5, atol=1e-4)


def test_fs4_graph_engines_match_jax(fs4, small_graph):
    """The same quantized LUTs into both packages: the fs4 beam's ids and
    counters equal JAX's, natural ties included (equal int32 sums give
    equal distances on both sides, and both break ties to the lower
    index)."""
    packed = fs4["packed"]
    jm = JInMemory(small_graph, jnp.asarray(packed), lambda qq: fs4["jql"])
    tm = InMemoryEngine(fs4["tgraph"], T(packed), lambda qq: fs4["tql"], device="cpu")
    _same_ids_and_counters(tm.search(T(fs4["q"]), k=10, h=32),
                           jm.search(jnp.asarray(fs4["q"]), k=10, h=32))
    assert tm.memory_bytes() == jm.memory_bytes()
    jh = JHybrid(small_graph, jnp.asarray(packed), lambda qq: fs4["jql"],
                 vectors=jnp.asarray(fs4["x"]))
    th = HybridEngine(fs4["tgraph"], T(packed), lambda qq: fs4["tql"],
                      vectors=T(fs4["x"]), device="cpu")
    for kw in ({}, {"expand": 4}):
        _same_ids_and_counters(th.search(T(fs4["q"]), k=10, h=32, **kw),
                               jh.search(jnp.asarray(fs4["q"]), k=10, h=32, **kw))
    assert th.memory_bytes() == jh.memory_bytes()


def test_fs4_engines_own_luts_recall_vs_jax(fs4, small_graph):
    """With each package building its own quantized LUTs (f32 tables that
    differ in the last bits can round to other bytes), recall@10 stays
    within 0.01 of JAX's."""
    jlut = lambda qq: jbase.build_lut(fs4["jm"], qq, quantize=True)
    tlut = lambda qq: tbase.build_lut(fs4["tm"], qq, quantize=True)
    packed = fs4["packed"]
    jr = j_recall(JInMemory(small_graph, jnp.asarray(packed), jlut)
                  .search(jnp.asarray(fs4["q"]), k=10, h=32).ids, fs4["gt"], 10)
    tr = recall_at_k(InMemoryEngine(fs4["tgraph"], T(packed), tlut, device="cpu")
                     .search(T(fs4["q"]), k=10, h=32).ids, fs4["gt"], 10)
    assert abs(tr - jr) <= 0.01, (tr, jr)


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("layout", ["u8", "fs4"])
def test_sharded_engine_one_shard_vs_jax(fs4, layout, rerank):
    """The one-shard scan engine against JAX's on a one-device mesh. fs4
    distances are exact integers dequantized by the same ops, so the ids
    are equal; u8 sums the f32 LUT in another order, so near-ties may
    swap: recall within 0.01 and distances allclose."""
    if layout == "fs4":
        codes, jl, tl = fs4["packed"], fs4["jql"], fs4["tql"]
    else:
        codes, jl, tl = fs4["codes"], jnp.asarray(fs4["jluts"]), T(fs4["jluts"])
    vec = dict(vectors=fs4["x"]) if rerank else {}
    je = JSharded(jnp.asarray(codes), lambda qq: jl,
                  **{k: jnp.asarray(v) for k, v in vec.items()})
    te = ShardedEngine(T(codes), lambda qq: tl,
                       **{k: T(v) for k, v in vec.items()}, device="cpu")
    j_res = je.search(jnp.asarray(fs4["q"]), k=10)
    t_res = te.search(T(fs4["q"]), k=10)
    if layout == "fs4":
        np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(j_res.ids))
    else:
        assert abs(recall_at_k(t_res.ids, fs4["gt"], 10)
                   - j_recall(j_res.ids, fs4["gt"], 10)) <= 0.01
    np.testing.assert_allclose(t_res.dists.numpy(), np.asarray(j_res.dists),
                               rtol=1e-5, atol=1e-3)
    for name in ("n_dist", "hops", "rounds", "truncated"):
        np.testing.assert_array_equal(getattr(t_res, name).numpy(),
                                      np.asarray(getattr(j_res, name)), err_msg=name)
    assert t_res.degraded == j_res.degraded is False
    assert te.memory_bytes() == je.memory_bytes()


def test_sharded_engine_dead_shard_answers_sentinels(fs4):
    te = ShardedEngine(T(fs4["packed"]), lambda qq: fs4["tql"], device="cpu")
    res = te.search(T(fs4["q"]), k=10, alive=[False])
    assert res.degraded and bool((res.ids == -1).all())
    assert bool(torch.isinf(res.dists).all()) and int(res.n_dist.max()) == 0


def test_fs4_recall_within_two_points_of_u8(fs4):
    """JAX's own property (tests/test_fastscan.py), on the port: the same
    K=16 model served u8 vs fs4 through every engine."""
    tm, q, gt = fs4["tm"], T(fs4["q"]), fs4["gt"]
    u8 = lambda qq: tbase.build_lut(tm, qq)
    f4 = lambda qq: tbase.build_lut(tm, qq, quantize=True)
    codes, packed = T(fs4["codes"]), T(fs4["packed"])
    pairs = [(InMemoryEngine(fs4["tgraph"], codes, u8, device="cpu"),
              InMemoryEngine(fs4["tgraph"], packed, f4, device="cpu"), {"h": 32}),
             (HybridEngine(fs4["tgraph"], codes, u8, vectors=T(fs4["x"]), device="cpu"),
              HybridEngine(fs4["tgraph"], packed, f4, vectors=T(fs4["x"]), device="cpu"),
              {"h": 32}),
             (ShardedEngine(codes, u8, device="cpu"),
              ShardedEngine(packed, f4, device="cpu"), {})]
    for e_u8, e_fs, kw in pairs:
        r_u8 = recall_at_k(e_u8.search(q, k=10, **kw).ids, gt, 10)
        r_fs = recall_at_k(e_fs.search(q, k=10, **kw).ids, gt, 10)
        assert abs(r_u8 - r_fs) <= 0.02, (type(e_u8).__name__, r_u8, r_fs)
        assert e_fs.memory_bytes() < e_u8.memory_bytes()


def test_fs4_bulk_adc_within_m_scale_of_f32(fs4):
    """Engine-level distances: the fs4 bulk scan stays within M·scale of
    the f32 ADC of the same model (the bound of tests/test_fastscan.py)."""
    tm, q = fs4["tm"], T(fs4["q"][:8])
    ql = tbase.build_lut(tm, q, quantize=True)
    fs = tops.adc_scan_fs(T(fs4["packed"]), ql.lut, ql.scale, ql.bias)
    f32 = tops.adc_scan_batch(T(fs4["codes"]), tbase.build_lut(tm, q))
    bound = tm.m * ql.scale[:, None] + 1e-4
    assert bool(((fs - f32).abs() <= bound).all())
