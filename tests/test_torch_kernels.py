"""Port kernel modules vs the JAX package: the plain PyTorch versions that
the port runs on CPU tensors, fed the same numpy inputs as the JAX kernels
(Pallas in interpret mode, or its jnp oracle). The CUDA kernels themselves
are held against these plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import adc_scan as t_adc
from repro_torch.kernels import adc_scan_fs as t_adcfs
from repro_torch.kernels import hop_adc as t_hop
from repro_torch.kernels import hop_adc_fs as t_hopfs
from repro_torch.kernels import hop_gather as t_hopg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pq_pairwise as t_pqp
from repro_torch.kernels import ref as tref
from repro_torch.pq import base as t_base


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _hop_inputs(rng, n, m, k, q, r):
    """Sentinel-padded codes, ids with duplicates and both boundary rows
    (0 and the sentinel n), and non-negative LUTs (squared distances)."""
    codes = rng.integers(0, k, (n + 1, m)).astype(np.uint8)
    codes[n] = 0
    ids = rng.integers(0, n + 1, (q, r)).astype(np.int32)
    ids[:, : r // 4] = ids[:, r // 4: 2 * (r // 4)]          # duplicates
    ids[0, 0], ids[0, -1] = 0, n                             # boundaries
    luts = (rng.random((q, m, k)) * 4.0).astype(np.float32)
    return codes, ids, luts


@pytest.mark.parametrize("r", [16, 64, 200])
@pytest.mark.parametrize("m_prefix", [0, 3])
def test_hop_adc_matches_jax_interpret(r, m_prefix):
    rng = np.random.default_rng(100 + r + m_prefix)
    codes, ids, luts = _hop_inputs(rng, n=301, m=8, k=64, q=5, r=r)
    want = jops.hop_adc(codes, ids, luts, backend="interpret",
                        m_prefix=m_prefix)
    got = tops.hop_adc(T(codes), T(ids), T(luts), m_prefix=m_prefix)
    assert got.dtype == torch.float32 and got.shape == (5, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_hop_adc_dtype_boundary():
    """ops casts int64 ids and int32 codes once; the result is unchanged."""
    rng = np.random.default_rng(3)
    codes, ids, luts = _hop_inputs(rng, n=50, m=4, k=16, q=3, r=16)
    base = tops.hop_adc(T(codes), T(ids), T(luts))
    wide = tops.hop_adc(T(codes.astype(np.int32)), T(ids.astype(np.int64)),
                        T(luts))
    np.testing.assert_array_equal(base.numpy(), wide.numpy())
    want = jref.hop_adc_ref(codes.astype(np.int32), ids, luts)
    np.testing.assert_allclose(base.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("shape", [(17, 4, 16, 4), (256, 8, 256, 16),
                                   (1000, 8, 64, 8), (129, 16, 256, 8)])
def test_pq_pairwise_matches_jax_interpret(shape):
    # rtol 1e-5 / atol 1e-4: the Pallas kernel's MXU dot vs the plain
    # version's einsum reduce in another order; x² − 2x·c + c² cancels.
    n, m, k, dsub = shape
    rng = np.random.default_rng(n + m)
    x = rng.normal(size=(n, m, dsub)).astype(np.float32)
    cb = rng.normal(size=(m, k, dsub)).astype(np.float32)
    want = jops.pq_pairwise(x, cb, backend="interpret", block_n=128)
    got = tops.pq_pairwise(T(x), T(cb))
    assert got.shape == (n, m, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_kmeans_assign_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 12)).astype(np.float32)
    c = rng.normal(size=(20, 12)).astype(np.float32)
    ji, jd = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c), backend="ref")
    ti, td = tops.kmeans_assign(T(x), T(c))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(17, 4, 16), (1000, 8, 64), (2049, 16, 256)])
@pytest.mark.parametrize("q", [1, 5])
def test_adc_scan_batch_matches_jax(shape, q):
    n, m, k = shape
    rng = np.random.default_rng(n * q)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    luts = (rng.random((q, m, k)) * 4.0).astype(np.float32)
    got = tops.adc_scan_batch(T(codes), T(luts)).numpy()
    # the f32 oracle: same function, summed in another order
    np.testing.assert_allclose(got, np.asarray(jref.adc_scan_batch_ref(codes, luts)),
                               rtol=1e-6)
    # the TPU kernel itself casts the LUT to bf16 for its one-hot GEMM
    interp = jops.adc_scan_batch(codes, luts, backend="interpret",
                                 block_n=128, block_q=4)
    np.testing.assert_allclose(got, np.asarray(interp), rtol=2e-2,
                               atol=2e-2 * m)


def test_hop_gather_ref_matches_jax():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 64, (6, 24, 8)).astype(np.uint8)
    luts = (rng.random((6, 8, 64)) * 4.0).astype(np.float32)
    got = tref.hop_gather_ref(T(codes), T(luts))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.hop_gather_ref(codes, luts)),
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [(17, 4, 16), (1000, 8, 64), (2049, 16, 256),
                                   (333, 5, 200)])
def test_adc_scan_matches_jax(shape):
    """One-query scan: the JAX oracle and the Pallas kernel in interpret
    mode (its VPU compare-and-sum runs in f32, so it agrees as closely)."""
    n, m, k = shape
    rng = np.random.default_rng(n + m)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    lut = (rng.random((m, k)) * 4.0).astype(np.float32)
    got = tops.adc_scan(T(codes), T(lut))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.adc_scan_ref(codes, lut)),
                               rtol=1e-6)
    interp = jops.adc_scan(codes, lut, backend="interpret", block_n=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), rtol=1e-6)
    # the same LUT as row q of the batched scan
    luts = np.stack([lut * 0.5, lut])
    np.testing.assert_allclose(tops.adc_scan_batch(T(codes), T(luts))[1].numpy(),
                               got.numpy(), rtol=1e-6)


@pytest.mark.parametrize("q,r,m,k", [(6, 24, 8, 64), (1, 64, 16, 256), (9, 1, 5, 16)])
def test_hop_gather_matches_jax(q, r, m, k):
    rng = np.random.default_rng(q * r + m)
    codes = rng.integers(0, k, (q, r, m)).astype(np.uint8)
    luts = (rng.random((q, m, k)) * 4.0).astype(np.float32)
    got = tops.hop_gather(T(codes), T(luts))
    assert got.dtype == torch.float32 and got.shape == (q, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.hop_gather_ref(codes, luts)),
                               rtol=1e-6)
    interp = jops.hop_gather(codes, luts, backend="interpret", block_q=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), rtol=1e-6)


def test_hop_gather_of_gathered_rows_is_hop_adc():
    rng = np.random.default_rng(12)
    codes, ids, luts = _hop_inputs(rng, n=301, m=8, k=64, q=5, r=64)
    np.testing.assert_array_equal(
        tops.hop_gather(T(codes)[T(ids).long()], T(luts)).numpy(),
        tops.hop_adc(T(codes), T(ids), T(luts)).numpy())


def test_pad_sentinel_row_matches_jax():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = tops.pad_sentinel_row(T(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.pad_sentinel_row(jnp.asarray(x))))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper only ever launches its kernel: CPU tensors are refused
    there (ops sends them to the plain version instead)."""
    rng = np.random.default_rng(1)
    codes, ids, luts = _hop_inputs(rng, n=20, m=4, k=16, q=2, r=8)
    with pytest.raises(ValueError, match="CUDA"):
        t_hop.hop_adc(T(codes), T(ids), T(luts))
    with pytest.raises(ValueError, match="CUDA"):
        t_adc.adc_scan_batch(T(codes), T(luts))
    with pytest.raises(ValueError, match="CUDA"):
        t_pqp.pq_pairwise(T(luts[:, :, :4].copy()), T(luts[0][:, :, None].copy()))
    with pytest.raises(ValueError, match="CUDA"):
        t_adc.adc_scan(T(codes), T(luts[0]))
    with pytest.raises(ValueError, match="CUDA"):
        t_hopg.hop_gather(T(codes[ids]), T(luts))


def test_fs_kernel_wrappers_refuse_cpu_tensors():
    packed = torch.zeros((21, 4), dtype=torch.uint8)
    luts = torch.zeros((2, 8, 16), dtype=torch.uint8)
    ids = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        t_hopfs.hop_adc_fs(packed, ids, luts)
    with pytest.raises(ValueError, match="CUDA"):
        t_adcfs.adc_scan_fs(packed, luts)


def test_ops_reject_codes_beyond_uint8():
    """Codes beyond uint8 are no longer refused (fault C1): int32 codes at
    K=300 are read unnarrowed, so a code of 299 scores LUT column 299."""
    codes = torch.tensor([[299, 0], [256, 255]], dtype=torch.int32)
    luts = torch.arange(600, dtype=torch.float32).reshape(1, 2, 300)
    got = tops.adc_scan_batch(codes, luts)
    assert got.tolist() == [[299.0 + 300.0, 256.0 + 555.0]]


def test_launch_counts_reset_and_cpu_path_launches_nothing():
    tops.reset_launch_counts()
    rng = np.random.default_rng(2)
    codes, ids, luts = _hop_inputs(rng, n=20, m=4, k=16, q=2, r=8)
    tops.hop_adc(T(codes), T(ids), T(luts))
    tops.adc_scan_batch(T(codes), T(luts))
    packed = torch.zeros((21, 2), dtype=torch.uint8)
    luts_u8 = torch.ones((2, 4, 16), dtype=torch.uint8)
    scale, bias = torch.ones(2), torch.zeros(2)
    tops.hop_adc_fs(packed, T(ids), luts_u8, scale, bias)
    tops.adc_scan_fs(packed, luts_u8, scale, bias)
    tops.adc_scan(T(codes), T(luts[0]))
    tops.hop_gather(T(codes[ids]), T(luts))
    assert tops.launch_counts() == {"pq_pairwise": 0, "hop_adc": 0,
                                    "adc_scan_batch": 0, "hop_adc_fs": 0,
                                    "adc_scan_fs": 0, "adc_scan": 0,
                                    "hop_gather": 0, "beam_expand": 0,
                                    "beam_merge": 0, "hop_adc_i32": 0,
                                    "adc_scan_batch_i32": 0, "adc_scan_i32": 0,
                                    "hop_gather_i32": 0}


@pytest.mark.parametrize("m,k", [(16, 256), (7, 100), (32, 256), (200, 256),
                                 (1, 1), (51200, 1), (3, 256)])
def test_adc_scan_batch_query_tile_fits(m, k):
    tq = t_adc.query_tile(m, k)
    assert tq in (1, 2, 4, 8)
    assert tq * m * k * 4 <= t_adc.MAX_TILE_BYTES
    if tq < t_adc.MAX_QUERY_TILE:   # the next tile up would not fit
        assert 2 * tq * m * k * 4 > t_adc.MAX_TILE_BYTES
    if (m, k) == (16, 256):
        assert tq == 8 and t_adc.rows_per_pass(tq) == 384


def test_adc_scan_batch_query_tile_fits_every_accepted_shape():
    """Every (M, K) the wrapper accepts (K <= 256, one LUT <= 200 KB) gets a
    tile of at least one query within the 227 KB a block may take."""
    for k in range(1, 257):
        for m in range(1, t_adc.MAX_LUT_BYTES // (4 * k) + 1):
            tq = t_adc.query_tile(m, k)
            assert tq >= 1 and tq * m * k * 4 <= 227 * 1024, (m, k)


@pytest.mark.parametrize("n,q,tq,resident", [
    (1_000_000, 1000, 8, 132), (4099, 13, 8, 132), (1, 37, 8, 132),
    (4099, 37, 4, 264), (5, 3, 2, 528), (10007, 1, 1, 528),
    (777, 1000, 8, 7), (3, 1, 8, 132)])
def test_adc_scan_batch_work_covers_each_output_once(n, q, tq, resident):
    """The blocks' ranges of the flat (tile, row) space cover every (query,
    row) exactly once, ragged row and query edges included."""
    blocks = t_adc.grid_blocks(n, q, tq, resident)
    assert 1 <= blocks <= resident
    tiles = -(-q // tq)
    hits = np.zeros((q, n), dtype=np.int32) if q * n <= 10**7 else None
    rows_done = 0
    for b in range(blocks):
        for tile, r0, r1 in t_adc.block_work(n, q, tq, blocks, b):
            assert 0 <= tile < tiles and 0 <= r0 < r1 <= n
            rows_done += r1 - r0
            if hits is not None:
                hits[tile * tq: tile * tq + tq, r0:r1] += 1
    assert rows_done == tiles * n
    if hits is not None:
        assert (hits == 1).all()


@pytest.mark.parametrize("n,q,k,resident", [
    (1_000_000, 1000, 512, 132),   # the timed int32 shape
    (50_000, 1000, 512, 132),      # the streaming round's delta arm
    (200_003, 13, 512, 132),       # N off the pack group, Q off the tile
    (4099, 37, 512, 132), (3, 2, 512, 132),   # Q below the tile
    (10_007, 1, 1024, 528), (33, 1000, 512, 7)])
def test_adc_scan_batch_int32_plan_covers_each_output_once(n, q, k, resident):
    """The int32 plan at M=16: 4 queries a tile at K=512 (2 at K=1024), the
    blocks' segments cover every (query tile, row) exactly once, counted
    per tile as sorted row intervals (no dense (Q, N) array, so the 1000 x
    1M plan is checked too), and each block stages each of its tiles once."""
    tq = t_adc.query_tile(16, k)
    assert tq == {512: 4, 1024: 2}[k]
    blocks = t_adc.grid_blocks(n, q, tq, resident)
    tiles = -(-q // tq)
    assert 1 <= blocks <= resident
    per_tile = [[] for _ in range(tiles)]
    for b in range(blocks):
        seen = []
        for tile, r0, r1 in t_adc.block_work(n, q, tq, blocks, b):
            assert 0 <= tile < tiles and 0 <= r0 < r1 <= n
            assert not seen or tile == seen[-1] + 1
            seen.append(tile)
            per_tile[tile].append((r0, r1))
    for spans in per_tile:
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    stages = t_adc.lut_stages(n, q, tq, blocks)
    assert tiles <= stages <= tiles + blocks - 1
    if n == 1_000_000:
        assert blocks == 132 and stages <= 250 + 131


@pytest.mark.parametrize("n,m", [(1, 16), (31, 16), (32, 16), (33, 16), (100, 6),
                                 (70, 50), (65, 14), (64, 8), (5, 20)])
def test_adc_scan_batch_packed_layout(n, m):
    """The int32 codes' packed layout: packed_index maps every (row, vector)
    of whole groups of 32 rows onto the scratch's 16-byte vectors one to
    one, and a vector of a group's 32 rows is one contiguous 512-byte run."""
    nv = t_adc.packed_vectors(m)
    assert (nv - 1) * 8 < m <= nv * 8
    groups = -(-n // t_adc.PACK_GROUP)
    assert t_adc.packed_bytes(n, m) == groups * t_adc.PACK_GROUP * nv * 16
    idx = [[t_adc.packed_index(32 * g + i, v, nv) for i in range(32)]
           for g in range(groups) for v in range(nv)]
    assert sorted(x for run in idx for x in run) == list(range(groups * 32 * nv))
    assert all(run == list(range(run[0], run[0] + 32)) for run in idx)


def test_adc_scan_batch_prefetch_plan():
    """uint8 rows read 16-byte vectors only on 16 bytes and whole vectors
    (one vector ahead); packed int32 rows always do, with 1,
    2 or 4 vectors ahead."""
    for ptr, ldc, j0, mc, want in ((0, 16, 0, 16, 1), (1, 16, 0, 16, 0), (0, 8, 0, 8, 0),
                                   (0, 32, 0, 32, 1), (0, 208, 192, 16, 1),
                                   (0, 208, 200, 8, 0), (0, 7, 0, 7, 0)):
        assert t_adc.batch_prefetch(ptr, ldc, j0, mc, 1) == want
    for mc, want in ((16, 2), (8, 1), (4, 1), (20, 4), (24, 4), (32, 4), (64, 4), (50, 4)):
        for ptr in (0, 4, 12):
            assert t_adc.batch_prefetch(ptr, 64, 0, mc, 4) == want


def test_adc_scan_batch_tiles_fit_up_to_k1024():
    """Every per-launch (subspace chunk, K) the wrapper makes for K <= 1024,
    int32 codes included, gets a query tile within the 227 KB a block may
    take, and its packed uint16 codes hold every K it accepts."""
    for k in range(1, 1025):
        per = t_adc.MAX_LUT_BYTES // (4 * k)
        for mc in range(1, per + 1):
            tq = t_adc.query_tile(mc, k)
            assert tq >= 1 and tq * mc * k * 4 <= 227 * 1024, (mc, k)
    assert t_adc.MAX_LUT_BYTES // 4 < 2**16   # one subspace's K fits uint16


@pytest.mark.parametrize("m,k,size", [(16, 256, 1), (16, 512, 4), (208, 256, 1),
                                      (64, 1024, 4), (7, 256, 1), (5, 512, 4),
                                      (32, 256, 1), (8, 512, 4)])
def test_row_vectors_only_on_aligned_rows_within_shared_memory(m, k, size):
    """The 16-byte row path of adc_scan, per subspace chunk of M and of an
    m_prefix, and of hop_adc over the whole m_prefix: taken exactly where
    every row and the chunk's first code start on 16 bytes; its vectors
    cover the chunk's codes and stay inside the row; the registers it
    prefetches are a template instance (1, 2 or 4 vectors); each adc_scan
    launch's LUT slice fits the shared memory a block may take."""
    for base in (0, 1, 4, 8, 16, 4096):
        for mm in (m, max(1, m // 3)):
            for j0, j1 in t_hop.subspace_chunks(mm, k):
                nv = t_hop.row_vectors(base, m, j0, j1 - j0, size)
                aligned = base % 16 == 0 and m * size % 16 == 0 and j0 * size % 16 == 0
                assert (nv > 0) == aligned, (base, mm, j0)
                if nv:
                    assert (nv - 1) * 16 < (j1 - j0) * size <= nv * 16
                    assert j0 * size + nv * 16 <= m * size
                pre = t_hop.prefetch_vectors(nv)
                assert pre in (0, *t_hop.PREFETCH_VECTORS) and (pre == 0) == (nv == 0)
                assert pre >= min(nv, 4)
                assert (j1 - j0) * k * 4 <= 227 * 1024
            nv = t_hop.row_vectors(base, m, 0, mm, size)  # hop_adc: one launch
            assert (nv > 0) == (base % 16 == 0 and m * size % 16 == 0)
            assert not nv or (nv - 1) * 16 < mm * size <= nv * 16 <= m * size
    if (m, k, size) == (16, 256, 1):
        assert t_hop.prefetch_vectors(t_hop.row_vectors(0, 16, 0, 16, 1)) == 1
    if (m, k, size) == (16, 512, 4):
        assert t_hop.prefetch_vectors(t_hop.row_vectors(0, 16, 0, 16, 4)) == 4


@pytest.mark.parametrize("m,k,size,m_prefix", [
    (16, 256, 1, 0), (16, 512, 4, 0), (16, 256, 1, 5), (208, 256, 1, 0),
    (64, 1024, 4, 0), (64, 1024, 4, 61), (7, 256, 1, 0), (5, 512, 4, 3)])
def test_hop_adc_launches_once_over_m_eff(monkeypatch, m, k, size, m_prefix):
    """hop_adc stages no LUT, so one launch covers the first m_eff
    subspaces whatever the LUT's size (past 200 KB too): the codes and LUTs
    from their first entry, ldl = M·K, the 16-byte row path exactly where
    rows start on 16 bytes."""
    calls = []
    monkeypatch.setattr(t_hop, "_entry", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(t_hop._build, "stream_handle", lambda device: None)
    q, r = 3, 5
    dtype = torch.uint8 if size == 1 else torch.int32
    codes = torch.zeros((11, m), dtype=dtype)
    ids = torch.zeros((q, r), dtype=torch.int32)
    luts = torch.zeros((q, m, k), dtype=torch.float32)
    m_eff = m_prefix or m
    before = (t_hop.launches, t_hop.launches_i32)
    t_hop.launch(codes, ids, luts, m_eff, torch.empty((q, r)))
    (c, cb, n_rows, ldc, i, qq, rr, lt, ldl, kk, mc, pre, _, _), = calls
    assert (c, cb, n_rows, ldc, i, qq, rr) == (codes.data_ptr(), size, 11, m,
                                               ids.data_ptr(), q, r)
    assert (lt, ldl, kk, mc) == (luts.data_ptr(), m * k, k, m_eff)
    aligned = codes.data_ptr() % 16 == 0 and m * size % 16 == 0
    assert (pre > 0) == aligned and pre in (0, *t_hop.PREFETCH_VECTORS)
    assert (t_hop.launches, t_hop.launches_i32) == (before[0] + (size == 1),
                                                    before[1] + (size == 4))
    t_hop.launches, t_hop.launches_i32 = before
    calls.clear()
    t_hop.launch(codes, ids[:0], luts[:0], m_eff, torch.empty((0, r)))
    assert not calls


def test_embedding_bag_yardsticks_equal_plain_versions():
    """The library column times one F.embedding_bag call per row; on CPU
    tensors each equals the kernel's plain version exactly."""
    lut_bag = _chip_smoke().lut_bag
    bag = lambda idx, w: torch.nn.functional.embedding_bag(idx, w, mode="sum")
    rng = np.random.default_rng(21)
    codes = T(rng.integers(0, 256, (5000, 16)).astype(np.uint8))
    luts = T((rng.random((7, 16, 256)) * 20.0).astype(np.float32))
    assert torch.equal(bag(*lut_bag(codes, luts)).T, tref.adc_scan_batch_ref(codes, luts))
    assert torch.equal(bag(*lut_bag(codes, luts[3]))[:, 0],
                       tref.adc_scan_ref(codes, luts[3]))
    rows = T(rng.integers(0, 256, (7, 64, 16)).astype(np.uint8))
    assert torch.equal(bag(*lut_bag(rows, luts)).reshape(7, 64),
                       tref.hop_gather_ref(rows, luts))


def test_kmeans_assign_ref_and_pad_rows_to_multiple_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    c = rng.normal(size=(17, 6)).astype(np.float32)
    ji, jd = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    ti, td = tref.kmeans_assign_ref(torch.from_numpy(x), torch.from_numpy(c))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    for n, mult in ((10, 4), (12, 4), (1, 8)):
        a = rng.integers(0, 9, (n, 3)).astype(np.uint8)
        np.testing.assert_array_equal(
            tops.pad_rows_to_multiple(torch.from_numpy(a), mult).numpy(),
            np.asarray(jops.pad_rows_to_multiple(jnp.asarray(a), mult)))


def test_ops_int32_codes_at_k512_equal_jax():
    """Fault C1: JAX's ``ops`` at N=600, M=4, K=512 int32 codes, and the
    port's on the CPU (their plain versions) — every entry point."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 512, (600, 4)).astype(np.int32)
    ids = rng.integers(0, 600, (3, 8)).astype(np.int32)
    luts = (rng.random((3, 4, 512)) * 4.0).astype(np.float32)
    for mp in (0, 2):
        want = jops.hop_adc(codes, ids, luts, m_prefix=mp)
        assert want.shape == (3, 8)
        got = tops.hop_adc(T(codes), T(ids), T(luts), m_prefix=mp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tops.adc_scan_batch(T(codes), T(luts)).numpy(),
                               np.asarray(jops.adc_scan_batch(codes, luts)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tops.adc_scan(T(codes), T(luts[0])).numpy(),
                               np.asarray(jops.adc_scan(codes, luts[0])),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tops.hop_gather(T(codes[ids]), T(luts)).numpy(),
                               np.asarray(jops.hop_gather(codes[ids], luts)),
                               rtol=1e-5, atol=1e-5)
    # codes above 255 survive the port's dtype boundary unnarrowed
    wide = t_base.QuantizerModel(torch.eye(8), T(rng.normal(size=(2, 512, 4)).astype(np.float32)))
    assert int(t_base.encode(wide, T(rng.normal(size=(50, 8)).astype(np.float32))).max()) > 255


@pytest.mark.parametrize("m,k", [(16, 256), (64, 1024), (50, 1024), (51, 1024),
                                 (4, 512), (1, 51200), (300, 16)])
def test_subspace_chunks_cover_m_in_order_within_shared_memory(m, k):
    """Fault C2: the chunks of a LUT beyond 200 KB tile [0, M) in order,
    each within the budget; a LUT that fits is one chunk. ``m_prefix`` is
    chunked as its own first m′ subspaces."""
    chunks = t_hop.subspace_chunks(m, k)
    assert chunks[0][0] == 0 and chunks[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < (j1 - j0) * k * 4 <= t_hop.MAX_LUT_BYTES for j0, j1 in chunks)
    assert (len(chunks) == 1) == (m * k * 4 <= t_hop.MAX_LUT_BYTES)
    mp = max(1, m - 3)
    assert t_hop.subspace_chunks(mp, k)[-1][1] == mp
    with pytest.raises(ValueError, match="shared memory"):
        t_hop.subspace_chunks(1, 51201)


@pytest.mark.parametrize("mb", [8, 50, 51, 64, 101, 128])
def test_adc_scan_fs_byte_chunks_cover_the_row(mb):
    chunks = t_adcfs.byte_chunks(mb)
    assert chunks[0][0] == 0 and chunks[-1][1] == mb
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all((b1 - b0) * 256 * 16 <= t_adcfs.MAX_TABLE_BYTES for b0, b1 in chunks)
    assert (len(chunks) == 1) == (mb <= 50)
