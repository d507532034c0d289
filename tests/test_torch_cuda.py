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

from repro_torch.kernels import ops
from repro_torch.kernels import ref

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


@pytest.mark.parametrize("m", [8, 16])
def test_adc_scan_batch_kernel_matches_plain(dev, m):
    codes, _, luts = _inputs(dev, n=4099, m=m, q=13)
    torch.testing.assert_close(ops.adc_scan_batch(codes, luts),
                               ref.adc_scan_batch_ref(codes, luts),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dsub", [8, 5])
def test_pq_pairwise_kernel_matches_plain(dev, dsub):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((777, 16, dsub), generator=g, device=dev)
    cb = torch.randn((16, 256, dsub), generator=g, device=dev)
    torch.testing.assert_close(ops.pq_pairwise(x, cb), ref.pq_pairwise_ref(x, cb),
                               rtol=1e-5, atol=1e-4)
