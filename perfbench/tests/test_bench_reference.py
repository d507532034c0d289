"""The plain reference against NumPy and against the program's own
functions (the reference imports nothing of the program; the test may)."""

import numpy as np
import pytest
import torch

from perfbench import reference as ref


def brute_topk(base, q, k):
    d = ((q[:, None, :].astype(np.float64) - base[None].astype(np.float64)) ** 2).sum(-1)
    # ties to the lower id: lexsort by (id, distance)
    return np.stack([np.lexsort((np.arange(len(row)), row))[:k] for row in d])


@pytest.mark.parametrize("kind", ["gauss", "integer"])
def test_exact_topk_matches_numpy(kind):
    g = torch.Generator().manual_seed(1)
    base = torch.randn(5000, 24, generator=g)
    q = torch.randn(300, 24, generator=g)
    if kind == "integer":      # many exact ties between rows
        base, q = torch.round(base * 2), torch.round(q * 2)
    got = ref.exact_topk(base, q, 10).numpy()
    want = brute_topk(base.numpy(), q.numpy(), 10)
    d = ((q.numpy()[:, None].astype(np.float64) - base.numpy()[None]) ** 2).sum(-1)
    # the same distances at every rank; the same ids wherever there is no tie
    assert np.array_equal(np.take_along_axis(d, got, 1), np.take_along_axis(d, want, 1))
    if kind == "gauss":
        assert np.array_equal(got, want)


def test_exact_topk_falls_back_when_the_shortlist_is_unsure(monkeypatch):
    monkeypatch.setattr(ref, "SHORTLIST", 10)       # k-th = last: never certain
    g = torch.Generator().manual_seed(2)
    base, q = torch.randn(3000, 16, generator=g), torch.randn(50, 16, generator=g)
    assert np.array_equal(ref.exact_topk(base, q, 10).numpy(),
                          brute_topk(base.numpy(), q.numpy(), 10))


def test_rotation_encode_luts_match_the_program():
    from repro_torch.core.rotation import rotation_from_params
    from repro_torch.pq import base as pqbase
    from repro_torch.pq.pack import pack_codes, quantize_luts

    g = torch.Generator().manual_seed(3)
    dim, m, k = 32, 8, 16
    theta = 0.05 * torch.randn(dim * (dim - 1) // 2, generator=g)
    r_prog = rotation_from_params(theta, dim)
    r = ref.rotation(theta, dim)
    assert torch.allclose(r, r_prog, atol=1e-5)
    assert torch.allclose(r @ r.T, torch.eye(dim), atol=1e-5)
    cb = torch.randn(m, k, dim // m, generator=g)
    x, q = torch.randn(2000, dim, generator=g), torch.randn(40, dim, generator=g)
    model = pqbase.QuantizerModel(r=r, codebooks=cb)
    assert (ref.encode(x, r, cb) == pqbase.encode(model, x)).float().mean() > 0.999
    lut = ref.luts(q, r, cb)
    assert torch.allclose(lut, pqbase.build_lut(model, q), rtol=1e-5, atol=1e-5)
    u8, scale, bias = ref.quantize_u8(lut)
    want = quantize_luts(lut)
    assert torch.equal(u8, want.lut) and torch.equal(scale, want.scale)
    codes = ref.encode(x, r, cb)
    assert torch.equal(ref.pack_nibbles(codes), pack_codes(codes))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, 255.0, -3.3])
    t = ref.to_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2 ** -10
    assert t[2] == 1.0 + 2 ** -10            # half way rounds away from zero
    assert t[3] == 1.0 and t[4] == 255.0
    assert abs(float(t[5]) + 3.3) <= 3.3 * 2 ** -11
    # integers of up to 11 bits pass exactly: a control at TF32 cannot move
    # a distance between SIFT's 0-255 integer vectors
    ints = torch.arange(0, 2048, dtype=torch.float32)
    assert torch.equal(ref.to_tf32(ints), ints)


def test_pair_distances_control_differs_only_by_tf32():
    g = torch.Generator().manual_seed(4)
    q, v = torch.randn(64, 96, generator=g), torch.randn(64, 10, 96, generator=g)
    exact = ref.pair_distances(q, v)
    ctl = ref.pair_distances(q, v, tf32=True)
    gap = (exact - ctl).abs().max() / exact.median()
    assert 1e-5 < gap < 1e-2
