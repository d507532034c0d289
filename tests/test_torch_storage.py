"""The port's all-in-storage tier (``repro_torch/storage``) vs the JAX
package's (``repro/storage``), on the CPU.

Both packages get the same numpy-seeded inputs: the reference conftest's
clustered data and Vamana graph, and PQ models (u8 M=8, K=32; fs4 M=8)
trained by the JAX package, their arrays handed to the port. Then:

* each test of ``tests/test_storage.py`` is mirrored on the port (layout
  pairs as parametrised cases);
* segment files are byte-identical across packages, each package reads the
  other's, the sidecar model loads equal, and codes above 255 are refused
  (the reference narrows them to uint8 without a word);
* the serial ``DiskEngine`` equals the JAX package's exactly — ids, dists,
  ``hops``, ``rounds``, ``n_dist`` and ``truncated`` — on both layouts,
  with injected LUTs whose every sum is exact in any order (integer f32
  for u8: the reference's numpy ``sum`` is pairwise, the port's kernels
  and plain versions sum in subspace order; uint8 tables with a
  power-of-two scale and a bias on a 1/64 grid for fs4), over the default
  search, ``entries=4``, hop pruning (fs4 prefixes dequantized with the
  full ``M · bias``, odd prefixes too), tombstones with a dead medoid, and
  both budgets; unfilled slots hold ``-1``;
* with the real ``build_lut`` of each package the distances agree at rtol
  1e-5 and the ids on ≥ 99% of queries;
* the overlapped mode, whose stale rounds depend on thread timing, is held
  to recall within 0.01 of serial and to the search's invariants;
* ``serve --scenario disk --device cpu`` and the example twin run as
  subprocesses.
"""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.index import BaseSegment as JBase
from repro.pq import base as jbase
from repro.pq import pack as jpack
from repro.pq import train_pq as j_train_pq
from repro.pq import train_pq_fs4 as j_train_pq_fs4
from repro.index.segment import encode_codes as j_encode_codes
from repro.storage import AsyncSegmentReader as JReader
from repro.storage import DiskEngine as JDisk
from repro.storage import open_segment as j_open_segment
from repro.storage import write_segment as j_write_segment
from repro_torch import convert
from repro_torch.dist.fault import ChaosPlan
from repro_torch.dist.retry import RetryPolicy, TransientIOError
from repro_torch.index import BaseSegment, StreamingEngine
from repro_torch.index.segment import load_segment, save_segment
from repro_torch.kernels import ops
from repro_torch.pq import base as tbase
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.search.engine import HybridEngine
from repro_torch.search.metrics import recall_at_k
from repro_torch.storage import (AsyncSegmentReader, DiskEngine,
                                 FrontierPrefetcher, HotVertexCache,
                                 SegmentFormatError, all_generations,
                                 corrupt_header, corrupt_record, open_segment,
                                 read_header, record_bytes_for, segment_path,
                                 write_segment)
from repro_torch.storage import format as segfmt

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, K = 8, 32
LAYOUTS = ["u8", "fs4"]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def S(clustered_data, small_graph):
    """The reference conftest's data and graph, JAX-trained PQ models and
    JAX-encoded codes, as numpy arrays and as each package's objects."""
    x, q, gt = clustered_data
    jmodels = {"u8": j_train_pq(jax.random.PRNGKey(3), x, M, K, iters=8),
               "fs4": j_train_pq_fs4(jax.random.PRNGKey(3), x, M, iters=8)}
    models = {k: convert.quantizer_from_numpy(np.asarray(v.r), np.asarray(v.codebooks),
                                              device="cpu")
              for k, v in jmodels.items()}
    codes = {k: np.array(j_encode_codes(jmodels[k], x, k)) for k in LAYOUTS}
    tgraph = convert.graph_from_numpy(np.asarray(small_graph.neighbors),
                                      int(small_graph.medoid), device="cpu")
    return dict(x=np.array(x), q=np.array(q), gt=np.asarray(gt), jgraph=small_graph,
                tgraph=tgraph, jmodels=jmodels, models=models, codes=codes)


def port_segment(S, layout, **kw):
    return BaseSegment(graph=S["tgraph"], codes=torch.from_numpy(S["codes"][layout]),
                       vectors=torch.from_numpy(S["x"]), layout=layout, **kw)


def jax_segment(S, layout):
    return JBase(graph=S["jgraph"], codes=jnp.asarray(S["codes"][layout]),
                 vectors=jnp.asarray(S["x"]), layout=layout)


@pytest.fixture(scope="module")
def segs(S, tmp_path_factory):
    """layout -> (directory with the port's gen 0 on disk, BaseSegment, model)."""
    out = {}
    for layout in LAYOUTS:
        seg, model = port_segment(S, layout), S["models"][layout]
        d = str(tmp_path_factory.mktemp(f"tseg_{layout}"))
        write_segment(d, seg, model=model)
        out[layout] = (d, seg, model)
    return out


def reader_for(d, **kw):
    path, header = open_segment(d)
    return AsyncSegmentReader(path, header, **kw)


def disk(d, **kw):
    return DiskEngine.open(d, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_storage.py: format, corruption, generation fallback
# ---------------------------------------------------------------------------

def test_record_bytes_alignment():
    for r, w in [(16, 8), (16, 4), (24, 8), (7, 3), (1, 1)]:
        rb = record_bytes_for(r, w)
        assert rb % 8 == 0 and rb >= 4 * r + w and rb < 4 * r + w + 8


@pytest.mark.parametrize("layout", LAYOUTS)
def test_segment_roundtrip_bit_identical(segs, layout):
    d, seg, _ = segs[layout]
    path, header = open_segment(d)
    assert (header.n, header.layout) == (seg.n, layout)
    assert header.medoid == int(seg.graph.medoid)
    assert header.dim == seg.dim
    with AsyncSegmentReader(path, header) as rd:
        adj, codes = rd.read_records(np.arange(header.n))
    np.testing.assert_array_equal(adj, _np(seg.graph.neighbors))
    np.testing.assert_array_equal(codes, _np(seg.codes))
    header.verify_data(path)


def test_header_corruption_detected(segs, tmp_path):
    d, _, _ = segs["u8"]
    p = str(tmp_path / "gen_00000000.seg")
    shutil.copy(segment_path(d, 0), p)
    corrupt_header(p, seed=1)
    with pytest.raises(SegmentFormatError, match="crc32|corrupt"):
        read_header(p)
    shutil.copy(segment_path(d, 0), p)
    os.truncate(p, read_header(p).file_bytes - 1)
    with pytest.raises(SegmentFormatError, match="truncated"):
        read_header(p)
    with open(p, "r+b") as f:
        f.write(b"NOTASEG!")
    with pytest.raises(SegmentFormatError, match="magic"):
        read_header(p)


def test_corrupt_record_is_silent_until_audited(segs, tmp_path):
    d, _, _ = segs["u8"]
    p = str(tmp_path / "gen_00000000.seg")
    shutil.copy(segment_path(d, 0), p)
    vid = corrupt_record(p, seed=2)
    hdr = read_header(p)
    assert 0 <= vid < hdr.n
    with pytest.raises(SegmentFormatError, match="data is corrupt"):
        hdr.verify_data(p)


def test_generation_fallback(segs, tmp_path):
    _, seg, model = segs["u8"]
    d = str(tmp_path)
    for g in (0, 1, 2):
        write_segment(d, dataclasses.replace(seg, generation=g), model=model)
    corrupt_header(segment_path(d, 2), seed=4)
    assert all_generations(d) == [0, 1, 2]
    falls = []
    path, header = open_segment(d, on_fallback=lambda g, e: falls.append(g))
    assert header.generation == 1 and falls == [2]
    assert path == segment_path(d, 1)
    with pytest.raises(SegmentFormatError):
        open_segment(d, generation=2)
    falls = []
    with disk(d, cache_records=64, seed_cache=False,
              on_fallback=lambda g, e: falls.append(g)) as eng:
        assert eng.generation == 1 and falls == [2]
    corrupt_header(segment_path(d, 1), seed=4)
    corrupt_header(segment_path(d, 0), seed=4)
    with pytest.raises(RuntimeError, match="every generation"):
        open_segment(d)


# ---------------------------------------------------------------------------
# Mirrors: reader, cache, prefetch
# ---------------------------------------------------------------------------

def test_reader_counters_and_chunk_split(segs):
    d, _, _ = segs["u8"]
    with reader_for(d, io_threads=4) as rd:
        adj, codes = rd.read_records(np.arange(100))
        assert adj.shape == (100, rd.header.r)
        st = rd.stats()
        assert st["n_reads"] == 100
        assert st["bytes_read"] == 100 * rd.header.record_bytes
        assert st["n_batches"] == 1
        assert rd._n_chunks(100) == 2 and rd._n_chunks(1) == 1
        a, c = rd.submit(np.zeros((0,), np.int64)).result()
        assert a.shape == (0, rd.header.r) and c.shape[0] == 0
        with pytest.raises(ValueError, match="out of range"):
            rd.submit([rd.header.n])
        with pytest.raises(ValueError, match="out of range"):
            rd.read_records([-1])


def test_reader_retries_transient_faults(segs):
    d, _, _ = segs["u8"]
    calls = {"n": 0}

    def hook(path):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise TransientIOError("injected")

    with reader_for(d, io_threads=2, fault_hook=hook,
                    retry=RetryPolicy(max_attempts=5, base_delay_s=1e-4,
                                      max_delay_s=1e-3)) as rd:
        adj, _ = rd.read_records(np.arange(8))
        assert adj.shape[0] == 8
        assert rd.stats()["n_retries"] == 2
    calls["n"] = 0
    with reader_for(d, fault_hook=hook) as rd:
        with pytest.raises(TransientIOError):
            rd.read_records(np.arange(8))


def test_cache_lru_eviction():
    cache = HotVertexCache(4)
    a = np.zeros((1, 2), np.int32)
    c = np.zeros((1, 3), np.uint8)
    for vid in range(6):
        cache.put_many([vid], a, c)
    assert len(cache) == 4 and cache.evictions == 2
    assert 0 not in cache and 1 not in cache and 5 in cache
    cache.get_many([2])
    cache.put_many([6], a, c)
    assert 2 in cache and 3 not in cache
    found, missing = cache.get_many([2, 3])
    assert set(found) == {2} and list(missing) == [3]
    assert cache.stats()["hits"] == 2 and cache.stats()["misses"] == 1


def test_cache_pinned_seeds_survive_scans(segs):
    d, _, _ = segs["u8"]
    with reader_for(d) as rd:
        cache = HotVertexCache(64)
        order = cache.seed_bfs(rd, rd.header.medoid)
        assert order.size == 32 and order[0] == rd.header.medoid
        assert cache.stats()["pinned"] == 32
        ids = np.arange(rd.header.n)
        adj, codes = rd.read_records(ids)
        cache.put_many(ids, adj, codes)
        assert len(cache) == 64
        found, missing = cache.get_many(order)
        assert missing.size == 0
        sadj, scodes = rd.read_records(order)
        for j, vid in enumerate(order):
            np.testing.assert_array_equal(found[int(vid)][0], sadj[j])
            np.testing.assert_array_equal(found[int(vid)][1], scodes[j])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefetch_equals_fetch(segs, layout):
    d, _, _ = segs[layout]
    with reader_for(d) as rd:
        pf = FrontierPrefetcher(rd, HotVertexCache(16))
        ids = np.asarray([7, 3, 11, 200, 3, 7])
        want = np.unique(ids)
        got_ids, adj, codes = pf.collect(pf.prefetch(ids))
        np.testing.assert_array_equal(got_ids, want)
        radj, rcodes = rd.read_records(want)
        np.testing.assert_array_equal(adj, radj)
        np.testing.assert_array_equal(codes, rcodes)
        st0 = pf.stats()
        _, adj2, _ = pf.fetch(ids)
        st1 = pf.stats()
        np.testing.assert_array_equal(adj2, adj)
        assert st1["n_reads"] == st0["n_reads"]
        assert st1["cache_hits"] - st0["cache_hits"] == want.size


# ---------------------------------------------------------------------------
# Mirrors: DiskEngine's protocol parity with the resident engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", [8, 32])
def test_disk_recall_matches_streaming(S, segs, h):
    q = torch.from_numpy(S["q"])
    d, seg, model = segs["u8"]
    sref = StreamingEngine(seg, model, delta_capacity=64, device="cpu")
    rec_mem = recall_at_k(sref.search(q, k=10, h=h).ids, S["gt"], 10)
    with disk(d, cache_records=512) as eng:
        rec_disk = recall_at_k(eng.search(q, k=10, h=h).ids, S["gt"], 10)
    assert rec_disk >= rec_mem - 0.01, (rec_disk, rec_mem)
    io = eng.last_io
    assert io["cache_hit_rate"] > 0.0
    assert io["bytes_read"] == io["n_reads"] * eng.header.record_bytes


@pytest.mark.parametrize("layout", LAYOUTS)
def test_disk_overlap_matches_serial(S, segs, layout):
    d, _, _ = segs[layout]
    q = torch.from_numpy(S["q"])
    with disk(d, cache_records=256) as eng:
        rec_s = recall_at_k(eng.search(q, k=10, h=32, overlap=False).ids, S["gt"], 10)
        assert eng.last_io["overlap"] is False
        rec_p = recall_at_k(eng.search(q, k=10, h=32, overlap=True).ids, S["gt"], 10)
        assert eng.last_io["overlap"] is True
        assert eng.last_io["rounds_total"] > 0
    assert abs(rec_p - rec_s) <= 0.01, (rec_p, rec_s)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_disk_tombstones_never_returned(S, segs, layout):
    d, _, _ = segs[layout]
    dead = np.unique(S["gt"][:, 0])
    with disk(d, cache_records=256) as eng:
        assert eng.delete(dead) == dead.size
        ids = _np(eng.search(torch.from_numpy(S["q"]), k=10, h=32).ids)
    assert not np.isin(ids, dead).any()
    assert (ids >= 0).any(axis=1).all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_disk_budgets_truncate_honestly(S, segs, layout):
    d, _, _ = segs[layout]
    q = torch.from_numpy(S["q"][:16])
    with disk(d, cache_records=256) as eng:
        free = eng.search(q, k=10, h=32)
        assert not free.truncated.any()
        capped = eng.search(q, k=10, h=32, max_rounds=2)
        assert int(capped.rounds.max()) <= 2
        assert bool(capped.truncated.all())
        assert bool((capped.ids[:, 0] >= 0).all())
        dcap = eng.search(q, k=10, h=32, max_n_dist=64)
        assert bool(dcap.truncated.any())
        assert int(dcap.n_dist.max()) <= 64 + 2 * eng.header.r


def test_vector_free_restore_roundtrip(segs, tmp_path):
    _, seg, model = segs["u8"]
    ck = str(tmp_path / "ckpt")
    save_segment(ck, seg, model=model)
    lean = load_segment(ck, with_vectors=False, device="cpu")
    assert lean.vectors is None and lean.dim_hint == seg.dim and lean.dim == seg.dim
    assert torch.equal(lean.codes, seg.codes)
    out = str(tmp_path / "segdir")
    write_segment(out, lean, model=model)
    with disk(out, cache_records=64) as eng:
        assert eng.n == seg.n and eng.header.dim == seg.dim


def test_io_time_measured_adapter(S, segs):
    d, seg, model = segs["u8"]
    q = torch.from_numpy(S["q"][:8])
    with disk(d, cache_records=256, slow_read_ms=0.5) as eng:
        res = eng.search(q, k=10, h=16, overlap=False)
        io_wait = eng.last_io["io_wait_s"]
    assert io_wait > 0.0
    hyb = HybridEngine(seg.graph, seg.codes, lambda qq: tbase.build_lut(model, qq),
                       vectors=seg.vectors, io_latency_s=5e-4, device="cpu")
    model_t = _np(hyb.io_time(res))
    meas_t = _np(hyb.io_time(res, measured_io_s=io_wait))
    assert model_t.shape == meas_t.shape == (8,)
    assert (model_t > 0).all()
    np.testing.assert_allclose(meas_t, io_wait / 8, rtol=1e-6)


def test_chaos_plan_storage_tokens():
    plan = ChaosPlan.parse("io=0.5,corrupt_record,slow_read=3,seed=2")
    assert plan.io_fault_p == 0.5
    assert plan.corrupt_record is True
    assert plan.slow_read_ms == 3.0
    assert plan.seed == 2
    off = ChaosPlan.parse("slow_read=0")
    assert off.slow_read_ms == 0.0 and off.corrupt_record is False


# ---------------------------------------------------------------------------
# Across packages: the same bytes, either package reads the other's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_segment_bytes_identical_across_packages(S, tmp_path, layout):
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tpath = write_segment(tdir, port_segment(S, layout), model=S["models"][layout])
    jpath = j_write_segment(jdir, jax_segment(S, layout), model=S["jmodels"][layout])
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    want_adj, want_codes = np.asarray(S["jgraph"].neighbors), S["codes"][layout]
    ids = np.arange(S["x"].shape[0])
    p, h = open_segment(jdir)           # the port reads the JAX package's file
    with AsyncSegmentReader(p, h) as rd:
        adj, codes = rd.read_records(ids)
    np.testing.assert_array_equal(adj, want_adj)
    np.testing.assert_array_equal(codes, want_codes)
    p, h = j_open_segment(tdir)         # and the JAX package the port's
    with JReader(p, h) as rd:
        adj, codes = rd.read_records(ids)
    np.testing.assert_array_equal(adj, want_adj)
    np.testing.assert_array_equal(codes, want_codes)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sidecar_model_loads_equal(S, tmp_path, layout):
    """Both sidecars hold the same f32 arrays, and the port's sidecar route
    on the JAX package's directory builds the port's own LUTs."""
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    write_segment(tdir, port_segment(S, layout), model=S["models"][layout])
    j_write_segment(jdir, jax_segment(S, layout), model=S["jmodels"][layout])
    with np.load(segfmt.model_path(tdir, 0)) as zt, np.load(segfmt.model_path(jdir, 0)) as zj:
        for name in ("r", "codebooks"):
            assert zt[name].dtype == zj[name].dtype == np.float32
            np.testing.assert_array_equal(zt[name], zj[name])
    q = torch.from_numpy(S["q"][:4])
    want = tbase.build_lut(S["models"][layout], q, quantize=layout == "fs4")
    with disk(jdir, cache_records=0) as eng:
        got = eng.lut_fn(q)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(a, b)


def test_write_segment_refuses_codes_above_255(S, tmp_path):
    codes = S["codes"]["u8"].astype(np.int32)
    codes[5, 3] = 300                   # K = 512 codebook
    seg = BaseSegment(graph=S["tgraph"], codes=torch.from_numpy(codes),
                      vectors=None, layout="u8", dim_hint=32)
    with pytest.raises(ValueError, match="one byte"):
        write_segment(str(tmp_path), seg)
    assert not os.listdir(tmp_path)
    codes[5, 3] = 255                   # int32 codes that fit are written
    seg = dataclasses.replace(seg, codes=torch.from_numpy(codes))
    write_segment(str(tmp_path), seg)
    with AsyncSegmentReader(*open_segment(str(tmp_path))) as rd:
        assert rd.read_records([5])[1][0, 3] == 255


# ---------------------------------------------------------------------------
# Across packages: the serial search, decision for decision
# ---------------------------------------------------------------------------

def _int_luts(layout, nq, seed=5):
    """LUTs whose sums are exact in any order: integer f32 (u8); uint8
    tables, a power-of-two scale and a bias on a 1/64 grid (fs4)."""
    r = np.random.default_rng(seed)
    if layout == "u8":
        return r.integers(0, 64, (nq, M, K)).astype(np.float32)
    return (r.integers(0, 256, (nq, M, 16)).astype(np.uint8),
            (2.0 ** -r.integers(0, 4, nq)).astype(np.float32),
            (r.integers(0, 64, nq) / 64).astype(np.float32))


def _lut_fns(luts, layout):
    """(port lut_fn, JAX lut_fn) returning the same numpy LUTs."""
    if layout == "u8":
        return (lambda q: torch.from_numpy(luts)), (lambda q: jnp.asarray(luts))
    return (lambda q: QuantizedLUT(*(torch.from_numpy(a) for a in luts)),
            lambda q: jpack.QuantizedLUT(*(jnp.asarray(a) for a in luts)))


def _assert_same(t_res, j_res, *, exact=True):
    np.testing.assert_array_equal(_np(t_res.ids), np.asarray(j_res.ids))
    if exact:
        np.testing.assert_array_equal(_np(t_res.dists), np.asarray(j_res.dists))
    for name in ("hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(_np(getattr(t_res, name)),
                                      np.asarray(getattr(j_res, name)), err_msg=name)


SERIAL_CASES = {
    "default": {},
    "entries4": {"entries": 4},
    "prune": {"prune_eps": 0.2},
    "prune_odd_prefix": {"prune_eps": 0.2, "m_prefix": 3, "expand": 2},
    "tombstones": {},
    "max_rounds": {"max_rounds": 3},
    "max_n_dist": {"max_n_dist": 64},
}


@pytest.mark.parametrize("case", list(SERIAL_CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_serial_search_equals_jax(S, segs, layout, case):
    d, _, _ = segs[layout]
    q = S["q"]
    tfn, jfn = _lut_fns(_int_luts(layout, q.shape[0]), layout)
    with disk(d, lut_fn=tfn, cache_records=256) as eng, \
            JDisk.open(d, lut_fn=jfn, cache_records=256) as jeng:
        if case == "tombstones":        # the medoid too: entries re-anchor
            dead = np.concatenate([np.unique(S["gt"][:, 0]), [eng.header.medoid]])
            assert eng.delete(dead) == jeng.delete(dead)
        kw = dict(k=10, h=32, overlap=False, **SERIAL_CASES[case])
        res, jres = eng.search(torch.from_numpy(q), **kw), jeng.search(jnp.asarray(q), **kw)
        assert eng.last_io["n_reads"] == jeng.last_io["n_reads"]
        assert eng.last_io["cache_hits"] == jeng.last_io["cache_hits"]
    _assert_same(res, jres)
    if case == "max_rounds":
        assert bool(res.truncated.all()) and int(res.rounds.max()) <= 3
    if case.startswith("prune"):
        assert int(res.n_dist.sum()) < int(res.hops.sum()) * eng.header.r


@pytest.mark.parametrize("layout", LAYOUTS)
def test_unfilled_slots_hold_minus_one(S, segs, layout):
    """Zero rounds leave only the entry vertex scored: every other slot is
    id -1 at distance inf, as in the reference."""
    d, _, _ = segs[layout]
    q = S["q"][:8]
    tfn, jfn = _lut_fns(_int_luts(layout, q.shape[0]), layout)
    with disk(d, lut_fn=tfn, cache_records=64) as eng, \
            JDisk.open(d, lut_fn=jfn, cache_records=64) as jeng:
        res = eng.search(torch.from_numpy(q), k=10, h=32, max_rounds=0, overlap=False)
        jres = jeng.search(jnp.asarray(q), k=10, h=32, max_rounds=0, overlap=False)
    ids = _np(res.ids)
    assert (ids[:, 0] == eng.header.medoid).all() and (ids[:, 1:] == -1).all()
    assert np.isinf(_np(res.dists)[:, 1:]).all() and res.ids.dtype == torch.int32
    _assert_same(res, jres)


def test_real_luts_close_to_jax(S, segs):
    """Each package's own ``build_lut`` (f32 tables that differ in the last
    bits): distances at rtol 1e-5, ids equal on ≥ 99% of queries."""
    d, _, model = segs["u8"]
    q = S["q"]
    with disk(d, cache_records=256) as eng:
        res = eng.search(torch.from_numpy(q), k=10, h=32, overlap=False)
    with JDisk.open(d, lut_fn=lambda qq: jbase.build_lut(S["jmodels"]["u8"], qq),
                    cache_records=256) as jeng:
        jres = jeng.search(jnp.asarray(q), k=10, h=32, overlap=False)
    same = (_np(res.ids) == np.asarray(jres.ids)).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(_np(res.dists)[same], np.asarray(jres.dists)[same],
                               rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_overlap_holds_invariants_near_jax_serial(S, segs, layout):
    """The pipelined mode with modeled read latency (so rounds do go stale):
    recall within 0.01 of the reference's serial search; sorted distances,
    distinct ids, -1 exactly at inf, hops ≥ rounds ≥ 1."""
    d, _, _ = segs[layout]
    q = S["q"]
    tfn, jfn = _lut_fns(_int_luts(layout, q.shape[0]), layout)
    with disk(d, lut_fn=tfn, cache_records=256, slow_read_ms=0.5) as eng:
        res = eng.search(torch.from_numpy(q), k=10, h=32, overlap=True)
    with JDisk.open(d, lut_fn=jfn, cache_records=256) as jeng:
        jres = jeng.search(jnp.asarray(q), k=10, h=32, overlap=False)
    gt = S["gt"]
    assert abs(recall_at_k(res.ids, gt, 10) - recall_at_k(np.asarray(jres.ids), gt, 10)) <= 0.01
    ids, dists = _np(res.ids), _np(res.dists)
    assert (np.diff(dists, axis=1) >= 0).all()
    assert ((ids == -1) == np.isinf(dists)).all()
    for row in ids:
        live = row[row >= 0]
        assert np.unique(live).size == live.size
    hops, rounds = _np(res.hops), _np(res.rounds)
    assert (rounds >= 1).all() and (hops >= rounds).all()
    assert not res.truncated.any()


@pytest.mark.parametrize("m_prefix", [0, 1, 3, 7])
def test_hop_adc_fs_acc_is_the_exact_prefix_sum(m_prefix):
    """``ops.hop_adc_fs_acc`` on the CPU: the int32 sum of the first
    ``m_prefix`` sub-codes' uint8 entries (all M at 0), odd prefixes and
    sentinel-padded ids included."""
    r = np.random.default_rng(7)
    m, n, q, rr = 8, 50, 5, 9
    sub = r.integers(0, 16, (n + 1, m)).astype(np.uint8)
    sub[n] = 0                                       # the sentinel row
    packed = (sub[:, 0::2] | (sub[:, 1::2] << 4)).astype(np.uint8)
    luts = r.integers(0, 256, (q, m, 16)).astype(np.uint8)
    ids = r.integers(0, n + 1, (q, rr)).astype(np.int32)
    got = ops.hop_adc_fs_acc(torch.from_numpy(packed), torch.from_numpy(ids),
                             torch.from_numpy(luts), m_prefix=m_prefix)
    mp = m_prefix or m
    want = luts[np.arange(q)[:, None, None], np.arange(mp)[None, None, :],
                sub[ids][:, :, :mp]].astype(np.int64).sum(axis=2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


# ---------------------------------------------------------------------------
# The command line and the example twin, as subprocesses
# ---------------------------------------------------------------------------

def _port_env():
    """Without PYTHONPATH (src/sitecustomize.py would import JAX); the
    module path goes in through ``-c``."""
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from repro_torch.launch import train as ttrain

    d = str(tmp_path_factory.mktemp("disk_ckpt"))
    ttrain.main(["--dataset", "unit-test", "--steps", "2", "--m", "4", "--k", "16",
                 "--batch", "32", "--routing-queries", "8", "--graph-r", "8",
                 "--graph-l", "16", "--beam", "16", "--checkpoint-every", "2",
                 "--quiet", "--device", "cpu", "--ckpt-dir", d])
    return d


@pytest.mark.parametrize("chaos", ["", "slow_read=2,corrupt_record,io=0.05"])
def test_serve_disk_scenario_subprocess(tiny_ckpt, chaos):
    argv = ["--ckpt-dir", tiny_ckpt, "--scenario", "disk", "--graph-r", "8",
            "--graph-l", "16", "--cache-mb", "0.02", "--io-threads", "2",
            "--device", "cpu"] + (["--chaos", chaos] if chaos else [])
    code = ("import sys, runpy; sys.path.insert(0, 'src'); "
            "sys.argv = ['serve'] + sys.argv[1:]; "
            "runpy.run_module('repro_torch.launch.serve', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT, env=_port_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    gen = [l for l in lines if l.startswith("[serve] disk: gen 0 segment ")]
    assert len(gen) == 1 and "2 io threads" in gen[0]
    res = [l for l in lines if l.startswith("[serve] disk: recall@10=")]
    io = [l for l in lines if l.startswith("[serve] disk io: cache_hit_rate=")]
    assert len(res) == 1 and len(io) == 1
    fields = dict(kv.split("=") for kv in io[0].split(": ", 1)[1].split())
    assert int(fields["n_reads"]) > 0
    assert int(fields["bytes_read"]) > 0
    if chaos:
        assert "[serve] chaos: silently corrupted record" in out.stdout
        assert "[serve] chaos: transient read fault p=0.05 injected on segment reads" in out.stdout
    else:
        assert fields["retries"] == "0"


def test_disk_serving_twin_dry_run_on_cpu():
    out = subprocess.run([sys.executable, "examples/disk_serving_torch.py", "--dry-run",
                          "--device", "cpu"], cwd=ROOT, env=_port_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("segment: ") and "for 600 records" in lines[0]
    assert [l[:9] for l in lines[2:4]] == ["serial   ", "prefetch "]
    assert lines[-1].startswith("gen 1 corrupted on disk -> fell back past [1] "
                                "to generation 0")
