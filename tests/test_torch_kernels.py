"""Port kernel modules vs the JAX package: the plain PyTorch versions that
the port runs on CPU tensors, fed the same numpy inputs as the JAX kernels
(Pallas in interpret mode, or its jnp oracle). The CUDA kernels themselves
are held against these plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import adc_scan as t_adc
from repro_torch.kernels import hop_adc as t_hop
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pq_pairwise as t_pqp
from repro_torch.kernels import ref as tref


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
    assert tops.launch_counts() == {"pq_pairwise": 0, "hop_adc": 0,
                                    "adc_scan_batch": 0}
