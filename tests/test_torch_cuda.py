"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import adc_scan_fs as kadcfs
from repro_torch.kernels import hop_adc_fs as khopfs
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.pq import pack

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
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


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
    torch.testing.assert_close(got, ref.adc_scan_ref(codes, lut), rtol=1e-6, atol=1e-6)
    if n < 10**6:
        torch.testing.assert_close(got, ops.adc_scan_batch(codes, lut[None])[0],
                                   rtol=1e-6, atol=1e-6)


def test_adc_scan_kernel_unaligned_rows(dev):
    """Rows that do not start on 16 bytes take the byte-load path."""
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 256, (999, 16)).astype(np.uint8)).to(dev)
    flat = torch.empty(codes.numel() + 1, dtype=torch.uint8, device=dev)
    flat[1:] = codes.reshape(-1)
    view = flat[1:].view(codes.shape)
    lut = torch.rand((16, 256), device=dev)
    torch.testing.assert_close(ops.adc_scan(view, lut), ref.adc_scan_ref(view, lut),
                               rtol=1e-6, atol=1e-6)


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
