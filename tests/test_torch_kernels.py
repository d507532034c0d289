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
    with pytest.raises(ValueError, match="K=256"):
        tops.adc_scan_batch(torch.zeros((4, 2), dtype=torch.int32),
                            torch.zeros((1, 2, 300)))


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
                                    "hop_gather": 0}


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
