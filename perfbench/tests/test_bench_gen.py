"""The benchmark's generator: deterministic, and on data it draws PQ
resolves neighbours far better than on ``data/synth.py``'s blobs."""

import numpy as np
import torch

from perfbench import gen

SPEC = {"kind": "uint8", "seed": 1, "latent_dim": 12, "n_clusters": 1000,
        "center_std": 1.0, "cluster_std": 0.35, "noise_std": 0.05,
        "offset": 40.0, "scale": 40.0, "dim": 128, "n_base": 20000}


def test_base_is_fixed_by_the_data_seed_and_queries_by_the_run_seed():
    a, b = gen.base(SPEC, "cpu"), gen.base(SPEC, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, gen.base(dict(SPEC, seed=2), "cpu"))
    assert torch.all(a == torch.round(a)) and a.min() >= 0 and a.max() <= 255
    s1 = gen.QueryStream(SPEC, 2**33 + 5, "cpu")
    s2 = gen.QueryStream(SPEC, 2**33 + 5, "cpu")
    assert torch.equal(torch.cat([s1.take(10), s1.take(20)]),
                       torch.cat([s2.take(10), s2.take(20)]))
    assert not torch.equal(gen.QueryStream(SPEC, 6, "cpu").take(30), s1.take(30))
    unit = gen.base(dict(SPEC, kind="unit", dim=96), "cpu")
    assert torch.allclose(unit.norm(dim=1), torch.ones(unit.shape[0]), atol=1e-5)


def test_arrivals_are_the_same_gaps_in_another_order():
    a = gen.arrivals(500.0, 2000, 11, 1)
    b = gen.arrivals(500.0, 2000, 11, 2)
    assert np.all(np.diff(a) > 0)
    assert np.allclose(np.sort(np.diff(np.r_[0, a])), np.sort(np.diff(np.r_[0, b])))
    assert not np.allclose(a, b)
    assert abs(a[-1] / 2000 - 1 / 500) < 0.1 / 500
    assert np.array_equal(a, gen.arrivals(500.0, 2000, 11, 1))


def _adc_recall(x, q):
    from repro_torch.pq import base as pqbase
    from repro_torch.pq.pq import train_pq

    model = train_pq(x, 16, 64, generator=torch.Generator().manual_seed(0), iters=8,
                     device="cpu")
    adc = pqbase.adc(model, pqbase.encode(model, x), q)
    got = adc.topk(10, largest=False).indices
    want = torch.cdist(q.double(), x.double()).topk(10, largest=False).indices
    return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got.tolist(), want.tolist())])


def test_pq_resolves_neighbours_on_this_data_unlike_synth():
    from repro_torch.data.synth import SPECS, synth

    x = gen.base(SPEC, "cpu")
    q = gen.QueryStream(SPEC, 3, "cpu").take(200)
    ours = _adc_recall(x, q)
    ds = synth(SPECS["sift"], scale=SPEC["n_base"] / SPECS["sift"].n_base, device="cpu")
    blobs = _adc_recall(ds.base, ds.queries[:200])
    assert ours > 0.4 and ours > 3 * blobs, (ours, blobs)
