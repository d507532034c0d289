"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.graphs.adjacency import Graph
from repro_torch.index.segment import BaseSegment
from repro_torch.kernels import adc_scan_fs as kadcfs
from repro_torch.kernels import hop_adc
from repro_torch.kernels import hop_adc_fs as khopfs
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.pq import pack
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.search import beam
from repro_torch.storage import DiskEngine, write_segment

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, n=1000, m=16, k=256, q=33, r=200, seed=7):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n + 1, m)).astype(np.uint8)
    ids = rng.integers(0, n + 1, (q, r)).astype(np.int32)
    ids[:, : r // 4] = ids[:, r // 4: 2 * (r // 4)]          # duplicates
    ids[0, 0], ids[0, -1] = 0, n                             # boundaries
    luts = (rng.random((q, m, k)) * 4.0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (codes, ids, luts))


@pytest.mark.parametrize("m_prefix", [0, 4])
def test_hop_adc_kernel_matches_plain(dev, m_prefix):
    codes, ids, luts = _inputs(dev)
    got = ops.hop_adc(codes, ids, luts, m_prefix=m_prefix)
    want = (ref.hop_adc_ref(codes[:, :m_prefix], ids, luts[:, :m_prefix])
            if m_prefix else ref.hop_adc_ref(codes, ids, luts))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _hop_exact(dev, codes, ids, luts, m_prefix=0):
    """ops.hop_adc on the card equals the plain version bit for bit."""
    mp = m_prefix or codes.shape[1]
    want = ref.hop_adc_ref(codes[:, :mp], ids, luts[:, :mp])
    got = ops.hop_adc(codes, ids, luts, m_prefix=m_prefix)
    assert got.shape == ids.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _sentinel_ids(rng, n, q, r):
    """(Q, R′) ids over n rows plus the sentinel n: duplicates, row 0 and
    the sentinel row."""
    ids = rng.integers(0, n + 1, (q, r)).astype(np.int32)
    if r > 1:
        ids[:, : r // 4] = ids[:, r // 4: 2 * (r // 4)]
    ids[0, 0], ids[-1, -1] = 0, n
    return ids


@pytest.mark.parametrize("code_dtype,k", [(torch.uint8, 256), (torch.int32, 512)])
@pytest.mark.parametrize("q", [1, 37, 1000])
@pytest.mark.parametrize("r", [1, 31, 64, 200])
def test_hop_adc_kernel_is_exact(dev, code_dtype, k, q, r):
    """Both code types, every frontier width the beam and the seeding call
    use and a ragged one, Q off every warp; with and without m_prefix."""
    rng = np.random.default_rng(q * r + k)
    n, m = 4099, 16
    codes = ops.pad_sentinel_row(torch.from_numpy(rng.integers(0, k, (n, m))).to(code_dtype))
    ids = torch.from_numpy(_sentinel_ids(rng, n, q, r))
    luts = torch.from_numpy((rng.random((q, m, k)) * 4.0).astype(np.float32))
    codes, ids, luts = codes.to(dev), ids.to(dev), luts.to(dev)
    for mp in (0, 5):
        _hop_exact(dev, codes, ids, luts, mp)


@pytest.mark.parametrize("n", [1, 4099, 1_000_003])
def test_hop_adc_kernel_corpus_sizes(dev, n):
    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(0, 256, (n, 16)).astype(np.uint8)).to(dev)
    ids = torch.from_numpy(_sentinel_ids(rng, n, 37, 64)).to(dev)
    luts = torch.rand((37, 16, 256), device=dev)
    _hop_exact(dev, ops.pad_sentinel_row(codes), ids, luts)


@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int32])
def test_hop_adc_kernel_unaligned_rows(dev, code_dtype):
    """Rows off 16 bytes take the code-by-code path, still exact: a view one
    element into its buffer, and rows of 7 (uint8) or 5 (int32) codes."""
    rng = np.random.default_rng(5)
    n, q, r = 2999, 13, 64
    ids = torch.from_numpy(_sentinel_ids(rng, n - 1, q, r)).to(dev)
    for m in (16, 7 if code_dtype == torch.uint8 else 5):
        codes = torch.from_numpy(rng.integers(0, 256, (n, m))).to(code_dtype).to(dev)
        flat = torch.empty(codes.numel() + 1, dtype=code_dtype, device=dev)
        flat[1:] = codes.reshape(-1)
        luts = torch.rand((q, m, 256), device=dev)
        for c in (flat[1:].view(codes.shape), codes):
            if m == 16 and c is codes:
                continue
            assert c.is_contiguous()
            assert hop_adc.row_vectors(c.data_ptr(), m, 0, m, c.element_size()) == 0
            _hop_exact(dev, c, ids, luts)
            _hop_exact(dev, c, ids, luts, 3)


def test_redesigned_kernels_take_empty_inputs(dev):
    """No query, no frontier lane, no code row: empty outputs, no launch."""
    ops.reset_launch_counts()
    for code_dtype, k in ((torch.uint8, 256), (torch.int32, 512)):
        codes = torch.zeros((11, 16), dtype=code_dtype, device=dev)
        for q, r in ((0, 64), (5, 0), (0, 0)):
            ids = torch.zeros((q, r), dtype=torch.int32, device=dev)
            got = ops.hop_adc(codes, ids, torch.rand((q, 16, k), device=dev))
            assert got.shape == (q, r) and got.dtype == torch.float32
        got = ops.adc_scan(codes[:0], torch.rand((16, k), device=dev))
        assert got.shape == (0,) and got.dtype == torch.float32
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values()), ops.launch_counts()


def test_hop_adc_kernel_rejects_out_of_range_ids(dev):
    """The ids check is a device-side assert (no host sync per beam round):
    a bad id fails the next synchronization and leaves the CUDA context
    unusable, so it runs in a fresh interpreter. In-range ids pass first."""
    code = ("import sys; sys.path.insert(0, 'src'); import torch; "
            "from repro_torch.kernels import ops; "
            "codes = torch.zeros((11, 16), dtype=torch.uint8, device='cuda'); "
            "luts = torch.ones((2, 16, 256), device='cuda'); "
            "ids = torch.full((2, 8), 10, dtype=torch.int32, device='cuda'); "
            "ops.hop_adc(codes, ids, luts); torch.cuda.synchronize(); "
            "print('in-range ok', flush=True); ids[1, 3] = 11; "
            "ops.hop_adc(codes, ids, luts); torch.cuda.synchronize()")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert "in-range ok" in out.stdout, out.stderr
    assert out.returncode != 0 and "device-side assert" in out.stderr, out.stderr


def test_hop_adc_fs_kernel_rejects_out_of_range_ids(dev):
    """The fs4 twin of the check above: the kernel's device-side assert, in
    both of its paths (R′ a multiple of 32, and R′ = 1)."""
    for r in (32, 1):
        code = ("import sys; sys.path.insert(0, 'src'); import torch; "
                "from repro_torch.kernels import hop_adc_fs as k; "
                "packed = torch.zeros((11, 8), dtype=torch.uint8, device='cuda'); "
                "luts = torch.ones((2, 16, 16), dtype=torch.uint8, device='cuda'); "
                f"ids = torch.full((2, {r}), 10, dtype=torch.int32, device='cuda'); "
                "k.hop_adc_fs(packed, ids, luts); torch.cuda.synchronize(); "
                "print('in-range ok', flush=True); ids[1, 0] = -1; "
                "k.hop_adc_fs(packed, ids, luts); torch.cuda.synchronize()")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert "in-range ok" in out.stdout, out.stderr
        assert out.returncode != 0 and "device-side assert" in out.stderr, out.stderr


@pytest.mark.parametrize("n", [1, 4099])
@pytest.mark.parametrize("q", [1, 13, 37])
@pytest.mark.parametrize("m", [7, 8, 16, 32])
@pytest.mark.parametrize("k", [16, 100, 256])
def test_adc_scan_batch_kernel_matches_plain(dev, k, m, q, n):
    """Bit for bit (j-order f32 sums): K < 256, odd M (byte loads), M = 32
    (a 4-query tile), Q off every query tile, a single row."""
    codes, _, luts = _inputs(dev, n=n - 1, m=m, k=k, q=q, r=8, seed=k * m + q + n)
    got = ops.adc_scan_batch(codes, luts)
    assert got.shape == (q, n)
    torch.testing.assert_close(got, ref.adc_scan_batch_ref(codes, luts), rtol=0, atol=0)


@pytest.mark.parametrize("m", [16, 32])
def test_adc_scan_batch_kernel_unaligned_rows(dev, m):
    """Rows that do not start on 16 bytes (a view one byte into its buffer,
    and a row slice of 8-byte rows) take the byte-load path, still exact."""
    rng = np.random.default_rng(m)
    codes = torch.from_numpy(rng.integers(0, 256, (2999, m)).astype(np.uint8)).to(dev)
    flat = torch.empty(codes.numel() + 1, dtype=torch.uint8, device=dev)
    flat[1:] = codes.reshape(-1)
    view = flat[1:].view(codes.shape)
    rows8 = flat[1:].view(-1, 8)[3:]
    luts = torch.rand((11, m, 256), device=dev)
    for c, lt in ((view, luts), (rows8, luts[:, :8].contiguous())):
        assert c.data_ptr() % 16 and c.is_contiguous()
        torch.testing.assert_close(ops.adc_scan_batch(c, lt),
                                   ref.adc_scan_batch_ref(c, lt), rtol=0, atol=0)


@pytest.mark.parametrize("dsub", [8, 5])
def test_pq_pairwise_kernel_matches_plain(dev, dsub):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((777, 16, dsub), generator=g, device=dev)
    cb = torch.randn((16, 256, dsub), generator=g, device=dev)
    torch.testing.assert_close(ops.pq_pairwise(x, cb), ref.pq_pairwise_ref(x, cb),
                               rtol=1e-5, atol=1e-4)


def _fs_inputs(dev, n, m, q, seed=11):
    """Packed codes with a zero sentinel row at n and u8 LUTs on the card."""
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 16, (n + 1, m)).astype(np.uint8))
    codes[n] = 0
    luts = torch.from_numpy(rng.integers(0, 256, (q, m, 16)).astype(np.uint8))
    return pack.pack_codes(codes).to(dev), luts.to(dev), rng


@pytest.mark.parametrize("r", [1, 64, 200, 256])
@pytest.mark.parametrize("m,m_prefix", [(16, 0), (16, 5), (7, 0), (7, 3)])
def test_hop_adc_fs_kernel_matches_plain(dev, r, m, m_prefix):
    """int32 sums equal bit for bit: odd M, odd m_prefix, duplicates, row 0
    and the sentinel row, Q = 37."""
    n, q = 5003, 37
    packed, luts, rng = _fs_inputs(dev, n, m, q, seed=r + m + m_prefix)
    ids = rng.integers(0, n + 1, (q, r)).astype(np.int32)
    if r > 1:
        ids[:, : r // 4] = ids[:, r // 4: 2 * (r // 4)]
        ids[0, 0], ids[0, -1] = 0, n
    ids = torch.from_numpy(ids).to(dev)
    got = khopfs.hop_adc_fs(packed, ids, luts, m_prefix=m_prefix)
    mp = m_prefix or m
    want = ref.hop_adc_fs_acc(packed[:, :(mp + 1) // 2].contiguous(), ids, luts[:, :mp])
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("r", [1, 64, 256])
def test_hop_adc_fs_kernel_unaligned_rows(dev, r):
    """Packed rows and LUTs that do not start on 8 / 16 bytes take the
    byte-load path: still exact, -1 on no in-range id."""
    n, q = 5003, 37
    packed, luts, rng = _fs_inputs(dev, n, 16, q, seed=r)
    flat = torch.empty(packed.numel() + 3, dtype=torch.uint8, device=dev)
    flat[3:] = packed.reshape(-1)
    view = flat[3:].view(packed.shape)
    lflat = torch.empty(luts.numel() + 1, dtype=torch.uint8, device=dev)
    lflat[1:] = luts.reshape(-1)
    lview = lflat[1:].view(luts.shape)
    assert view.data_ptr() % 8 and lview.data_ptr() % 16
    ids = torch.from_numpy(rng.integers(0, n + 1, (q, r)).astype(np.int32)).to(dev)
    for p, lt in ((view, luts), (packed, lview), (view, lview)):
        for mp in (0, 5):
            got = khopfs.hop_adc_fs(p, ids, lt, m_prefix=mp)
            mm = mp or 16
            want = ref.hop_adc_fs_acc(p[:, :(mm + 1) // 2].contiguous(), ids, lt[:, :mm])
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_hop_adc_fs_empty_kernel_launches(dev):
    khopfs.launch_empty(1000, 64)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,m,q", [(4099, 16, 13), (10007, 7, 8), (3001, 9, 1),
                                   (20000, 32, 21)])
def test_adc_scan_fs_kernel_matches_plain(dev, n, m, q):
    """int32 sums equal bit for bit: ragged N, odd M, a byte width that is
    not a multiple of 4 (M=9), Q off the 8-query tile."""
    packed, luts, _ = _fs_inputs(dev, n - 1, m, q, seed=n)
    got = kadcfs.adc_scan_fs(packed, luts)
    assert got.dtype == torch.int32 and got.shape == (q, n)
    torch.testing.assert_close(got, ref.adc_scan_fs_acc(packed, luts), rtol=0, atol=0)


def test_adc_scan_fs_kernel_unaligned_rows(dev):
    """Packed rows that start at an odd address take the byte-load path of
    the kernel and still agree."""
    packed, luts, _ = _fs_inputs(dev, 999, 8, 5)
    flat = torch.empty(packed.numel() + 1, dtype=torch.uint8, device=dev)
    flat[1:] = packed.reshape(-1)
    view = flat[1:].view(packed.shape)
    assert view.data_ptr() % 4 and view.is_contiguous()
    got = kadcfs.adc_scan_fs(view, luts)
    torch.testing.assert_close(got, ref.adc_scan_fs_acc(view, luts), rtol=0, atol=0)


def test_fs_ops_dequantize_like_plain(dev):
    packed, luts, rng = _fs_inputs(dev, 2000, 16, 9)
    scale = torch.rand(9, device=dev) + 0.1
    bias = torch.rand(9, device=dev)
    ids = torch.from_numpy(rng.integers(0, 2001, (9, 64)).astype(np.int32)).to(dev)
    torch.testing.assert_close(ops.hop_adc_fs(packed, ids, luts, scale, bias),
                               ref.hop_adc_fs_ref(packed, ids, luts, scale, bias),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.adc_scan_fs(packed, luts, scale, bias),
                               ref.adc_scan_fs_ref(packed, luts, scale, bias),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,m,k", [(1_000_003, 16, 256), (4099, 16, 256), (3001, 7, 256),
                                   (777, 8, 16), (1, 16, 256)])
def test_adc_scan_kernel_matches_plain(dev, n, m, k):
    """One-query scan: ragged N, odd M (byte loads), K < 256, one row; the
    same LUT as a row of the batched kernel."""
    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8)).to(dev)
    lut = torch.from_numpy((rng.random((m, k)) * 4.0).astype(np.float32)).to(dev)
    got = ops.adc_scan(codes, lut)
    torch.testing.assert_close(got, ref.adc_scan_ref(codes, lut), rtol=0, atol=0)
    if n < 10**6:
        torch.testing.assert_close(got, ops.adc_scan_batch(codes, lut[None])[0],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n,m", [(1_000_003, 16), (4099, 16), (3001, 7), (1, 16),
                                 (2049, 8)])
def test_adc_scan_int32_kernel_is_exact(dev, n, m):
    """int32 codes at K=512: 16-byte row loads at M=16 and M=8, code by
    code at M=7; ragged N and a single row."""
    g = torch.Generator(device=dev).manual_seed(n + m)
    codes = torch.randint(0, 512, (n, m), generator=g, device=dev, dtype=torch.int32)
    lut = torch.rand((m, 512), generator=g, device=dev) * 4.0
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.adc_scan(codes, lut), ref.adc_scan_ref(codes, lut),
                               rtol=0, atol=0)
    assert ops.launch_counts()["adc_scan_i32"] == 1


def test_adc_scan_kernel_unaligned_rows(dev):
    """Rows that do not start on 16 bytes take the code-by-code path, still
    exact: views one element into their buffers, uint8 and int32."""
    rng = np.random.default_rng(3)
    for dtype, k in ((torch.uint8, 256), (torch.int32, 512)):
        codes = torch.from_numpy(rng.integers(0, k, (999, 16))).to(dtype).to(dev)
        flat = torch.empty(codes.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = codes.reshape(-1)
        view = flat[1:].view(codes.shape)
        lut = torch.rand((16, k), device=dev)
        torch.testing.assert_close(ops.adc_scan(view, lut), ref.adc_scan_ref(view, lut),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("q,r,m,k", [(1000, 64, 16, 256), (37, 200, 7, 256),
                                     (1, 64, 16, 16), (5, 1, 16, 256)])
def test_hop_gather_kernel_matches_plain_and_hop_adc(dev, q, r, m, k):
    codes, ids, luts = _inputs(dev, n=5000, m=m, k=k, q=q, r=r, seed=q + r)
    got = ops.hop_gather(codes[ids.long()], luts)
    torch.testing.assert_close(got, ref.hop_gather_ref(codes[ids.long()], luts),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, ops.hop_adc(codes, ids, luts), rtol=0, atol=0)


def test_pq_pairwise_gradient_on_the_card(dev):
    """The autograd Function (kernel forward, PyTorch backward) against
    autograd of the plain version, both on CUDA tensors."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((9728, 16, 8), generator=g, device=dev)
    cb = torch.randn((16, 256, 8), generator=g, device=dev)
    up = torch.randn((9728, 16, 256), generator=g, device=dev)
    x1, c1 = x.clone().requires_grad_(), cb.clone().requires_grad_()
    x2, c2 = x.clone().requires_grad_(), cb.clone().requires_grad_()
    ops.reset_launch_counts()
    out = ops.pq_pairwise(x1, c1)
    assert ops.launch_counts()["pq_pairwise"] == 1 and out.grad_fn is not None
    out.backward(up)
    ref.pq_pairwise_ref(x2, c2).backward(up)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(c1.grad, c2.grad, rtol=1e-5, atol=1e-2)


# --------------------------------------------------------------------------
# int32 codes (K > 256) and subspace chunking past shared memory
# --------------------------------------------------------------------------

def _wide_inputs(dev, n, m, k, q, seed, dtype=torch.int32):
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, k, (n, m), generator=g, device=dev,
                          dtype=torch.int32).to(dtype)
    luts = torch.rand((q, m, k), generator=g, device=dev) * 4.0
    return codes, luts


@pytest.mark.parametrize("n,m,k,q", [(600, 4, 512, 3), (4099, 16, 1024, 13),
                                     (3001, 64, 1024, 5)])
def test_int32_variants_match_plain(dev, n, m, k, q):
    """The four int32 variants at K > 256 (M=64, K=1024 also chunks):
    adc_scan_batch bit for bit, the others against the plain version."""
    codes, luts = _wide_inputs(dev, n, m, k, q, seed=n + m)
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.adc_scan_batch(codes, luts),
                               ref.adc_scan_batch_ref(codes, luts), rtol=0, atol=0)
    torch.testing.assert_close(ops.adc_scan(codes, luts[0]),
                               ref.adc_scan_ref(codes, luts[0]), rtol=0, atol=0)
    ids = torch.randint(0, n, (q, 64), device=dev, dtype=torch.int32)
    for mp in (0, max(1, m // 2 + 1)):
        want = (ref.hop_adc_ref(codes[:, :mp], ids, luts[:, :mp]) if mp
                else ref.hop_adc_ref(codes, ids, luts))
        torch.testing.assert_close(ops.hop_adc(codes, ids, luts, m_prefix=mp), want,
                                   rtol=0, atol=0)
    torch.testing.assert_close(ops.hop_gather(codes[ids.long()], luts),
                               ref.hop_gather_ref(codes[ids.long()], luts),
                               rtol=1e-5, atol=1e-4)
    counts = ops.launch_counts()
    for name in ("adc_scan_batch", "adc_scan", "hop_adc", "hop_gather"):
        assert counts[f"{name}_i32"] > 0 and counts[name] == 0, counts


@pytest.mark.parametrize("n,q", [(200_003, 13), (4099, 37), (4097, 3), (5, 9), (33, 4),
                                 (900_001, 5)])
def test_adc_scan_batch_int32_ragged_exact(dev, n, q):
    """int32 codes at K=512 (packed, then scanned), bit for bit: N off the
    32-row pack group and off 4, Q off the 4-query tile and below it, a
    group and a row past it, and a code table past the 50 MB L2 (900,001 x
    16 x 4 bytes)."""
    codes, luts = _wide_inputs(dev, n, 16, 512, q, seed=n + q)
    torch.testing.assert_close(ops.adc_scan_batch(codes, luts),
                               ref.adc_scan_batch_ref(codes, luts), rtol=0, atol=0)


@pytest.mark.parametrize("m", [16, 12, 20, 6])
def test_adc_scan_batch_int32_unaligned_rows(dev, m):
    """int32 rows at K=512 on and off 16 bytes (a view one code into its
    buffer; M=6 rows of 24 bytes), packed into rows of 2 or 3 vectors (M=20:
    the third loaded during the sum, its last four codes padding); every
    output bit for bit."""
    codes, luts = _wide_inputs(dev, 2999, m, 512, 11, seed=m)
    flat = torch.empty(codes.numel() + 1, dtype=torch.int32, device=dev)
    flat[1:] = codes.reshape(-1)
    view = flat[1:].view(codes.shape)
    assert view.data_ptr() % 16 and view.is_contiguous()
    for c in (codes, view):
        torch.testing.assert_close(ops.adc_scan_batch(c, luts),
                                   ref.adc_scan_batch_ref(c, luts), rtol=0, atol=0)


@pytest.mark.parametrize("k", [1024, 1600])
def test_adc_scan_batch_int32_subspace_chunks(dev, k):
    """M=64 int32 codes whose LUT passes 200 KB: two launches, the second
    starting from the first's sums (K=1024: chunks of 50 and 14 subspaces,
    the second at an offset of 200 bytes; K=1600: two of 32), each packed
    on its own, bit for bit at ragged N and Q."""
    codes, luts = _wide_inputs(dev, 70_001, 64, k, 6, seed=k)
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.adc_scan_batch(codes, luts),
                               ref.adc_scan_batch_ref(codes, luts), rtol=0, atol=0)
    assert ops.launch_counts()["adc_scan_batch_i32"] == 2


@pytest.mark.parametrize("m,k", [(64, 1024), (208, 256)])
def test_u8_chunked_kernels_match_plain(dev, m, k):
    """uint8 codes whose LUT passes 200 KB go in subspace chunks, each
    launch continuing the sums, in the kernels that stage the LUT; hop_adc
    stages none and takes one launch: every kernel stays bit-exact."""
    codes, luts = _wide_inputs(dev, 2049, m, min(k, 256), 7, seed=m,
                               dtype=torch.uint8)
    luts = torch.rand((7, m, k), device=dev) * 4.0
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.adc_scan_batch(codes, luts),
                               ref.adc_scan_batch_ref(codes, luts), rtol=0, atol=0)
    assert ops.launch_counts()["adc_scan_batch"] == 2
    ids = torch.randint(0, 2049, (7, 64), device=dev, dtype=torch.int32)
    torch.testing.assert_close(ops.hop_adc(codes, ids, luts, m_prefix=m - 3),
                               ref.hop_adc_ref(codes[:, :m - 3], ids, luts[:, :m - 3]),
                               rtol=0, atol=0)
    _hop_exact(dev, codes, ids, luts)
    assert ops.launch_counts()["hop_adc"] == 2  # one a call
    torch.testing.assert_close(ops.adc_scan(codes, luts[0]),
                               ref.adc_scan_ref(codes, luts[0]), rtol=0, atol=0)


@pytest.mark.parametrize("m", [128, 201])
def test_adc_scan_fs_chunked_is_exact(dev, m):
    """M > 100 splits the paired table into byte chunks; int32 sums exact."""
    rng = np.random.default_rng(m)
    codes = torch.from_numpy(rng.integers(0, 16, (3001, m)).astype(np.uint8)).to(dev)
    packed = pack.pack_codes(codes)
    luts = torch.from_numpy(rng.integers(0, 256, (9, m, 16)).astype(np.uint8)).to(dev)
    assert len(kadcfs.byte_chunks(packed.shape[1])) >= 2
    torch.testing.assert_close(kadcfs.adc_scan_fs(packed, luts),
                               ref.adc_scan_fs_acc(packed, luts), rtol=0, atol=0)


@pytest.mark.parametrize("r", [1, 64, 200])
@pytest.mark.parametrize("m,m_prefix", [(16, 0), (16, 5), (7, 3), (8, 1)])
def test_hop_adc_fs_acc_matches_plain(dev, r, m, m_prefix):
    """``ops.hop_adc_fs_acc`` (the disk tier's fs4 route, int32 sums before
    any dequant) on the card equals its CPU route bit for bit: odd M and odd
    prefixes, ragged lanes padded with the sentinel row, one launch."""
    n, q = 3001, 29
    packed, luts, rng = _fs_inputs(dev, n, m, q, seed=3 * r + m + m_prefix)
    ids = np.full((q, r), n, np.int32)
    for i, used in enumerate(rng.integers(0, r + 1, q)):
        ids[i, :used] = rng.integers(0, n, used)
    ids = torch.from_numpy(ids).to(dev)
    ops.reset_launch_counts()
    got = ops.hop_adc_fs_acc(packed, ids, luts, m_prefix=m_prefix)
    assert ops.launch_counts()["hop_adc_fs"] == 1
    want = ops.hop_adc_fs_acc(packed.cpu(), ids.cpu(), luts.cpu(), m_prefix=m_prefix)
    assert got.dtype == want.dtype == torch.int32 and got.is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def _disk_segment(directory, layout, n=3000, m=8, r=16, seed=3):
    """A random R-regular graph (some rows padded with the sentinel n) and
    random codes, written as generation 0 of a segment file."""
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, n, (n, r)).astype(np.int32)
    nbrs[rng.random((n, r)) < 0.1] = n
    codes = torch.from_numpy(rng.integers(0, 16 if layout == "fs4" else 256,
                                          (n, m)).astype(np.uint8))
    if layout == "fs4":
        codes = pack.pack_codes(codes)
    graph = Graph(torch.from_numpy(nbrs), torch.tensor(0))
    write_segment(directory, BaseSegment(graph=graph, codes=codes, vectors=None,
                                         layout=layout, dim_hint=32))
    return rng


@pytest.mark.parametrize("kw", [{}, {"prune_eps": 0.2, "m_prefix": 3},
                                {"entries": 4, "max_rounds": 5, "expand": 2}])
@pytest.mark.parametrize("layout", ["u8", "fs4"])
def test_disk_search_on_the_card_equals_the_cpu_route(dev, tmp_path, layout, kw):
    """A serial ``DiskEngine`` search scored on the card (``hop_adc`` or
    ``hop_adc_fs_acc`` + dequant) equals the same search on the CPU route
    (the plain versions) bit for bit: ids, dists and every counter. Both
    sum in subspace order, so float LUTs need no integer grid."""
    d = str(tmp_path)
    rng = _disk_segment(d, layout)
    q, m = 50, 8
    if layout == "u8":
        luts = torch.from_numpy((rng.random((q, m, 256)) * 4.0).astype(np.float32))
    else:
        luts = QuantizedLUT(torch.from_numpy(rng.integers(0, 256, (q, m, 16)).astype(np.uint8)),
                            torch.from_numpy(rng.random(q).astype(np.float32) * 0.1),
                            torch.from_numpy(rng.random(q).astype(np.float32)))
    on_card = luts.to(dev)
    queries = torch.zeros((q, 32))
    res = {}
    for where, table in ((dev, on_card), (torch.device("cpu"), luts)):
        with DiskEngine.open(d, lut_fn=lambda _q, t=table: t, cache_records=256,
                             device=where) as eng:
            ops.reset_launch_counts()
            res[where.type] = eng.search(queries, k=10, h=32, overlap=False, **kw)
            counts = ops.launch_counts()
        kernel = "hop_adc_fs" if layout == "fs4" else "hop_adc"
        assert (counts[kernel] > 0) == (where.type == "cuda")
    card, host = res["cuda"], res["cpu"]
    assert card.ids.is_cuda
    for name in ("ids", "dists", "hops", "n_dist", "rounds", "truncated"):
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(host, name),
                                   rtol=0, atol=0, msg=name)


def test_hnsw_descent_and_catalyst_serving_on_the_card(dev):
    """An HNSW built on the CPU: its descent on the card picks the CPU's
    entries (exact distances summed in another order: ≥ 98% of queries),
    and an ``entry_fn`` search from the CPU's entries over tie-free codes
    equals the CPU route bit for bit through ``hop_adc``. A small Catalyst
    trained on the CPU: its LUTs through ``pq_pairwise`` on the card within
    1e-5 of the CPU's, its codes equal on ≥ 99% of rows, and ``adc``
    through ``adc_scan_batch`` equal to the plain version on the same LUTs."""
    from repro_torch.graphs import build_hnsw, descend
    from repro_torch.pq import catalyst
    from repro_torch.search.engine import InMemoryEngine

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3000, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    h = build_hnsw(x, generator=torch.Generator().manual_seed(0), m=8, device="cpu")
    entries = descend(h, q, x)
    on_card = descend(h.to(dev), q.to(dev), x.to(dev))
    assert on_card.is_cuda and float((on_card.cpu() == entries).float().mean()) >= 0.98
    codes = rng.integers(0, 256, (3000, 8)).astype(np.uint8)
    while np.unique(codes, axis=0).shape[0] != 3000:  # pragma: no cover
        codes = rng.integers(0, 256, (3000, 8)).astype(np.uint8)
    luts = torch.from_numpy(rng.random((64, 8, 256)).astype(np.float32))
    res = {}
    for where in (dev, torch.device("cpu")):
        eng = InMemoryEngine(h.base, torch.from_numpy(codes), lambda _q, t=luts.to(where): t,
                             device=where, entry_fn=lambda qq: entries.to(qq.device))
        ops.reset_launch_counts()
        res[where.type] = eng.search(q, k=10, h=32)
        assert (ops.launch_counts()["hop_adc"] > 0) == (where.type == "cuda")
    for name in ("ids", "dists", "hops", "n_dist", "rounds", "truncated"):
        torch.testing.assert_close(getattr(res["cuda"], name).cpu(), getattr(res["cpu"], name),
                                   rtol=0, atol=0, msg=name)

    model, _ = catalyst.train_catalyst(x, 4, 64, generator=torch.Generator().manual_seed(1),
                                       d_out=16, steps=5, batch=64, device="cpu")
    card = model.to(dev)
    ops.reset_launch_counts()
    lut_card = catalyst.build_lut(card, q.to(dev))
    torch.testing.assert_close(lut_card.cpu(), catalyst.build_lut(model, q), rtol=1e-5, atol=1e-5)
    c_card = catalyst.encode(card, x.to(dev))
    assert float((c_card.cpu() == catalyst.encode(model, x)).all(dim=1).float().mean()) >= 0.99
    torch.testing.assert_close(catalyst.adc(card, c_card, q.to(dev)),
                               ref.adc_scan_batch_ref(c_card, lut_card), rtol=0, atol=0)
    counts = ops.launch_counts()
    assert counts["pq_pairwise"] > 0 and counts["adc_scan_batch"] > 0


# --------------------------------------------------------------------------
# the model zoo: reduced configs on the card against the CPU route
# --------------------------------------------------------------------------

def _to(tree, where):
    from repro_torch.common.treeutil import tree_map

    return tree_map(lambda t: t.to(where), tree)


def _step_close(a, b, lr):
    """Params after one Adam step: every entry within the step's size
    (lr·g/(|g| + 1e-8) turns on a gradient's last bits where |g| is near
    1e-8), and 99% of them within 1e-4 relative."""
    from repro_torch.common.treeutil import tree_leaves

    near = []
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.cpu().float() - y.float()).abs()
        assert float(d.max()) <= 2 * lr + 1e-5
        near.append((d <= 1e-4 * y.float().abs() + 1e-6).float().mean())
    assert float(torch.stack(near).min()) >= 0.99


@pytest.mark.parametrize("arch", ["granite-3-8b", "granite-moe-1b-a400m", "llama3-405b"])
def test_reduced_lm_on_the_card_equals_the_cpu_route(dev, arch):
    from repro_torch.configs import get_arch
    from repro_torch.device import full_f32_matmul
    from repro_torch.models import transformer as tf

    full_f32_matmul()
    cfg = get_arch(arch).make_reduced()
    fns = tf.make_train_step(cfg, lr=1e-3)
    params = fns.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    labels = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    out = {}
    for where in (dev, torch.device("cpu")):
        p = _to(params, where)
        p2, _, loss = fns.train_step(p, fns.opt_init(p), toks.to(where), labels.to(where))
        logits, cache = tf.prefill(cfg, p2, toks[:, :-1].to(where), max_len=20)
        dec, cache = tf.decode_step(cfg, p2, cache, toks[:, -1].to(where))
        out[where.type] = (p2, loss, logits, dec)
    gp, gl, glog, gdec = out["cuda"]
    cp, cl, clog, cdec = out["cpu"]
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-5, atol=1e-5)
    _step_close(gp, cp, 1e-3)
    torch.testing.assert_close(glog.cpu(), clog, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(gdec.cpu(), cdec, rtol=1e-3, atol=1e-3)


def test_reduced_gat_and_recsys_on_the_card_equal_the_cpu_route(dev):
    """GAT's segment sums run through ``index_add`` (atomic order on the
    card), so its loss is held to 1e-5 relative, not bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.device import full_f32_matmul
    from repro_torch.models import gnn, recsys

    full_f32_matmul()
    rng = np.random.default_rng(3)
    gcfg = get_arch("gat-cora").make_reduced()
    n, e = 64, 256
    gin = [torch.from_numpy(a) for a in (
        rng.normal(size=(n, gcfg.d_in)).astype(np.float32),
        rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, gcfg.n_classes, n).astype(np.int32), rng.random(n) < 0.7)]
    _, gstep, ginit = gnn.make_train_step(gcfg)
    gparams = gnn.init_gat(torch.Generator().manual_seed(0), gcfg, device="cpu")
    dcfg = get_arch("dlrm-mlperf").make_reduced()
    dparams = recsys.init_dlrm(torch.Generator().manual_seed(1), dcfg, device="cpu")
    batch = {"dense": torch.from_numpy(rng.normal(size=(32, 13)).astype(np.float32)),
             "sparse": torch.from_numpy(rng.integers(0, 100, (32, 6)).astype(np.int32)),
             "label": torch.from_numpy((rng.random(32) < 0.3).astype(np.float32))}
    fwd = lambda p, b: recsys.dlrm_forward(dcfg, p, b["dense"], b["sparse"])
    _, dstep, dinit = recsys.make_bce_train_step(fwd, None)
    bcfg = get_arch("bert4rec").make_reduced()
    bparams = recsys.init_bert4rec(torch.Generator().manual_seed(2), bcfg, device="cpu")
    items = torch.from_numpy(rng.integers(0, bcfg.n_items, (8, bcfg.seq_len)).astype(np.int32))
    pad = torch.ones_like(items, dtype=torch.bool)
    pos = torch.from_numpy(rng.integers(0, bcfg.seq_len, (8, 4)).astype(np.int32))
    lab = torch.from_numpy(rng.integers(-1, bcfg.n_items, (8, 4)).astype(np.int32))
    out = {}
    for where in (dev, torch.device("cpu")):
        p = _to(gparams, where)
        gp, _, gl = gstep(p, ginit(p), *(t.to(where) for t in gin))
        p = _to(dparams, where)
        dp, _, dl = dstep(p, dinit(p), _to(batch, where))
        bl = recsys.bert4rec_mlm_loss(bcfg, _to(bparams, where), items.to(where),
                                      pad.to(where), pos.to(where), lab.to(where))
        out[where.type] = (gp, gl, dp, dl, bl)
    for i in (1, 3, 4):
        torch.testing.assert_close(out["cuda"][i].cpu(), out["cpu"][i], rtol=1e-5, atol=1e-5)
    _step_close(out["cuda"][0], out["cpu"][0], 5e-3)
    _step_close(out["cuda"][2], out["cpu"][2], 1e-3)


# --------------------------------------------------------------------------
# the classic beam round's kernels (csrc/beam_round.cu) against the op chain
# they replace, run on the card through their plain versions
# --------------------------------------------------------------------------

FIELDS = ("ids", "dists", "hops", "n_dist", "rounds", "truncated")


@contextlib.contextmanager
def _plain_round():
    """Route the beam's classic rounds through the plain versions (the op
    chain) on the card."""
    saved = ops.beam_expand, ops.beam_merge
    ops.beam_expand, ops.beam_merge = ref.beam_expand_ref, ref.beam_merge_ref
    try:
        yield
    finally:
        ops.beam_expand, ops.beam_merge = saved


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(a, b):
    if isinstance(a, beam.Trace):
        for name in ("beam_ids", "beam_dists", "hop_valid"):
            assert torch.equal(_bits(getattr(a, name)), _bits(getattr(b, name))), name
        a, b = a.result, b.result
    for name in FIELDS:
        assert torch.equal(_bits(getattr(a, name)), _bits(getattr(b, name))), name


def _kernel_and_plain(run):
    """``run()`` through the kernels and through the plain versions, both on
    the card; the kernel run's launch counts beside."""
    ops.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with _plain_round():
        want = run()
    _assert_same(got, want)
    return got, counts


def _random_graph(rng, n, r, pad=0.15):
    """A random graph with sentinel-padded rows: ~``pad`` of the slots and a
    few whole rows point at the sentinel n; in-row duplicates happen."""
    nbrs = rng.integers(0, n, (n, r)).astype(np.int32)
    nbrs[rng.random((n, r)) < pad] = n
    nbrs[rng.choice(n, n // 50, replace=False)] = n
    return nbrs


def _u8_case(dev, rng, n=20_000, r=64, q=300, m=16):
    nbrs = torch.from_numpy(_random_graph(rng, n, r)).to(dev)
    codes = ops.pad_sentinel_row(torch.from_numpy(
        rng.integers(0, 256, (n, m)).astype(np.uint8))).to(dev)
    luts = torch.from_numpy((rng.random((q, m, 256)) * 4.0).astype(np.float32)).to(dev)
    entry = torch.from_numpy(rng.integers(0, n, q)).to(dev)
    return nbrs, entry, luts, beam.make_adc_dist_fn(codes), codes


@pytest.mark.parametrize("h,r", [(32, 64), (96, 64), (128, 64), (256, 64), (96, 24),
                                 (96, 128), (1, 32)])
def test_beam_round_kernels_equal_the_op_chain_u8(dev, h, r):
    """``hop_adc`` routing at every beam width of the port's callers up to
    the kernels' 256 (the benchmark's h = 96, R = 64), degrees off and at
    the kernels' limit; rounds equal the launches."""
    nbrs, entry, luts, fn, codes = _u8_case(dev, np.random.default_rng(h * 1000 + r), r=r)
    res, counts = _kernel_and_plain(
        lambda: beam.beam_search(nbrs, entry, luts, fn, h=h, max_steps=300))
    rounds = int(res.rounds.max())
    assert rounds > 1 and counts["beam_expand"] == counts["beam_merge"] == rounds
    assert counts["hop_adc"] == rounds + 1


def test_beam_round_kernels_equal_the_op_chain_fs4_ties(dev):
    """``hop_adc_fs`` with uint8 LUTs of four levels: distances tie all the
    time, so the merge's tie order decides the beam."""
    rng = np.random.default_rng(4)
    n, r, q, m = 20_000, 64, 300, 32
    nbrs = torch.from_numpy(_random_graph(rng, n, r)).to(dev)
    packed = ops.pad_sentinel_row(pack.pack_codes(torch.from_numpy(
        rng.integers(0, 16, (n, m)).astype(np.uint8)))).to(dev)
    ql = QuantizedLUT(torch.from_numpy(rng.integers(0, 4, (q, m, 16)).astype(np.uint8)),
                      torch.from_numpy(rng.random(q).astype(np.float32) * 0.1),
                      torch.from_numpy(rng.random(q).astype(np.float32))).to(dev)
    entry = torch.from_numpy(rng.integers(0, n, q)).to(dev)
    fn = beam.make_adc_dist_fn(packed, packed=True)
    res, counts = _kernel_and_plain(lambda: beam.beam_search(nbrs, entry, ql, fn, h=96))
    d = res.dists
    assert bool((d[:, 1:] == d[:, :-1]).any())
    assert counts["beam_expand"] == int(res.rounds.max())


def test_beam_round_kernels_build_the_same_vamana_graph(dev):
    """Exact ``dist_fn`` (a torch op, not a kernel) through a small Vamana
    build on the card: the adjacency is identical."""
    from repro_torch.graphs.vamana import build_vamana

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4000, 24)).astype(np.float32))
    ops.reset_launch_counts()
    got = build_vamana(x, generator=torch.Generator().manual_seed(0), r=32, l=64,
                       batch=512, device=dev)
    assert ops.launch_counts()["beam_expand"] > 0
    with _plain_round():
        want = build_vamana(x, generator=torch.Generator().manual_seed(0), r=32, l=64,
                            batch=512, device=dev)
    assert torch.equal(got.neighbors, want.neighbors) and int(got.medoid) == int(want.medoid)


def test_beam_round_kernels_tombstones_and_a_dead_entry(dev):
    rng = np.random.default_rng(6)
    nbrs, entry, luts, fn, codes = _u8_case(dev, rng)
    n = nbrs.shape[0]
    dead = rng.random(n) < 0.2
    dead[int(entry[0])] = True                                 # a dead entry
    words = np.zeros((n + 31) // 32, np.uint32)
    np.bitwise_or.at(words, np.flatnonzero(dead) >> 5,
                     (1 << (np.flatnonzero(dead) & 31)).astype(np.uint32))
    res, _ = _kernel_and_plain(lambda: beam.beam_search(nbrs, entry, luts, fn, h=96,
                                                        tombstones=words))
    ids = res.ids[res.ids < n].long().cpu().numpy()
    assert not dead[ids].any() and int(res.hops[0]) > 1


@pytest.mark.parametrize("budget", [{"max_rounds": 7}, {"max_n_dist": 400},
                                    {"max_rounds": 30, "max_n_dist": 900},
                                    {"max_steps": 9}])
def test_beam_round_kernels_budgets(dev, budget):
    nbrs, entry, luts, fn, codes = _u8_case(dev, np.random.default_rng(7))
    res, _ = _kernel_and_plain(lambda: beam.beam_search(nbrs, entry, luts, fn, h=96,
                                                        **budget))
    assert bool(res.truncated.any())


def test_beam_round_kernels_lanes_per_query_and_entry_sets(dev):
    """Four lanes a query (the sharded engines' shards), then (Q, S) entry
    sets with padding and repeats."""
    rng = np.random.default_rng(8)
    nbrs, _, luts, fn, codes = _u8_case(dev, rng)
    n, q = nbrs.shape[0], luts.shape[0]
    lanes = torch.from_numpy(rng.integers(0, n, 4 * q)).to(dev)
    res, counts = _kernel_and_plain(lambda: beam.beam_search(
        nbrs, lanes, luts, fn, h=64, lanes_per_query=4))
    assert res.ids.shape == (4 * q, 64) and counts["beam_expand"] == int(res.rounds.max())
    sets = torch.from_numpy(rng.integers(-1, n, (q, 8))).to(dev)
    sets[:, 1] = sets[:, 0]
    _kernel_and_plain(lambda: beam.beam_search(nbrs, sets, luts, fn, h=96))


def test_beam_round_kernels_trace(dev):
    nbrs, entry, luts, fn, codes = _u8_case(dev, np.random.default_rng(9), q=200)
    tr, counts = _kernel_and_plain(lambda: beam.beam_search_trace(
        nbrs, entry, luts, fn, h=96, trace_len=16, max_rounds=40))
    assert bool(tr.hop_valid[:, -1].any()) and bool(tr.hop_valid[:, 0].all())
    assert counts["beam_merge"] == int(tr.result.rounds.max())


def test_beam_round_counts_one_sync_a_round(dev):
    """With spans on, ``sync`` reads one a round plus one, and every round is
    a ``beam.fused`` one."""
    from repro_torch.common import spans

    nbrs, entry, luts, fn, codes = _u8_case(dev, np.random.default_rng(10))
    beam.beam_search(nbrs, entry, luts, fn, h=96)
    spans.enable(False)
    spans.drain()
    spans.enable(True)
    try:
        res = beam.beam_search(nbrs, entry, luts, fn, h=96)
    finally:
        spans.enable(False)
    got, counts = spans.drain()
    rounds = int(res.rounds.max())
    assert sum(s.name == "beam.round" for s in got) == rounds
    assert sum(v for (k, _), v in counts.items() if k == "sync") == rounds + 1
    assert sum(v for (k, _), v in counts.items() if k == "beam.fused") == rounds


@pytest.mark.parametrize("kw", [{"expand": 4},
                                {"prune_eps": 0.3, "m_prefix": 4}])
def test_expand_and_pruned_beams_keep_the_op_chain(dev, kw):
    """``expand > 1`` and hop pruning launch neither round kernel and return
    what the CPU route returns."""
    nbrs, entry, luts, _, codes = _u8_case(dev, np.random.default_rng(11))
    res = {}
    for where in (dev, torch.device("cpu")):
        c = codes.to(where)
        extra = {"expand": kw.get("expand", 1)}
        if "m_prefix" in kw:
            extra.update(m_prefix=kw["m_prefix"], m_total=c.shape[1],
                         prune_eps=kw["prune_eps"],
                         lb_dist_fn=beam.make_adc_dist_fn(c, m_prefix=kw["m_prefix"]))
        ops.reset_launch_counts()
        res[where.type] = beam.beam_search(nbrs.to(where), entry.to(where), luts.to(where),
                                           beam.make_adc_dist_fn(c), h=96, **extra)
        counts = ops.launch_counts()
        assert counts["beam_expand"] == counts["beam_merge"] == 0
    for name in FIELDS:
        assert torch.equal(_bits(getattr(res["cuda"], name).cpu()),
                           _bits(getattr(res["cpu"], name))), name
