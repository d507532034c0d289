"""The search path's spans and counters (``repro_torch.common.spans``): one
span tree per engine call, one ``beam.round`` per round, one ``sync`` per
wait for the card, and the same results with the recorder on and off.

A small random graph and random codebooks, no graph build, so the file runs
in seconds on the CPU. The ``cuda`` test holds the ``sync`` counter to the
synchronizing operations that ``torch.cuda.set_sync_debug_mode`` reports;
on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_spans.py
"""

import warnings

import pytest
import torch

from repro_torch.common import spans
from repro_torch.graphs.adjacency import Graph
from repro_torch.pq import base as pqbase
from repro_torch.search import beam
from repro_torch.search.engine import HybridEngine, InMemoryEngine

N, R, D, M, K, Q = 300, 8, 16, 4, 16, 24
CHILDREN = {"hybrid": ["search.lut", "search.route", "search.rerank"],
            "inmemory": ["search.lut", "search.route"]}
OPTS = [{}, {"expand": 2}, {"prune_eps": 0.3}, {"entries": 4}]
FIELDS = ("ids", "dists", "hops", "n_dist", "rounds", "truncated")


def _engine(kind, dev="cpu"):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, D, generator=g)
    neighbors = torch.randint(0, N, (N, R), generator=g, dtype=torch.int32)
    neighbors[:, -1] = N                                   # a padded slot
    model = pqbase.QuantizerModel(torch.eye(D), torch.randn(M, K, D // M, generator=g))
    codes = pqbase.encode(model, x)
    model = model.to(dev)

    def lut_fn(q):
        return pqbase.build_lut(model, q)

    graph = Graph(neighbors, torch.tensor(0))
    if kind == "hybrid":
        return HybridEngine(graph, codes, lut_fn, vectors=x, device=dev)
    return InMemoryEngine(graph, codes, lut_fn, device=dev)


def _queries(dev="cpu"):
    return torch.randn(Q, D, generator=torch.Generator().manual_seed(1)).to(dev)


@pytest.fixture
def recorder():
    spans.enable(False)
    spans.drain()
    yield
    spans.enable(False)
    spans.drain()


def _syncs(counts, call):
    return counts.get(("sync", call), 0)


def _pruned_beam(eng, luts):
    """The hop-pruned beam called without ``lb_scale_fn``, so that it builds
    its default scale M/m′ from three scalars copied to the device."""
    return beam.beam_search(
        eng.graph.neighbors, eng.graph.medoid, luts,
        beam.make_adc_dist_fn(eng._codes_p), h=16,
        lb_dist_fn=beam.make_adc_dist_fn(eng._codes_p, m_prefix=1),
        m_prefix=1, m_total=M, prune_eps=0.3)


@pytest.mark.parametrize("kind", ["hybrid", "inmemory"])
def test_one_span_tree_per_call(recorder, kind):
    eng, q = _engine(kind), _queries()
    spans.enable(True)
    results = [eng.search(q[:n], k=5, h=16) for n in (Q, 7)]
    spans.enable(False)
    got, counts = spans.drain()
    roots = [i for i, s in enumerate(got) if s.parent == -1]
    assert [got[i].name for i in roots] == ["search", "search"]
    assert len({got[i].call for i in roots}) == 2
    for root, res in zip(roots, results):
        call = got[root].call
        mine = [i for i, s in enumerate(got) if s.call == call]
        for i in mine:
            s, p = got[i], got[got[i].parent] if got[i].parent >= 0 else None
            assert 0 < s.start_ns <= s.end_ns
            if p is not None:
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        kids = [got[i].name for i in mine if got[i].parent == root]
        assert kids == CHILDREN[kind]
        route = next(i for i in mine if got[i].name == "search.route")
        inner = [got[i].name for i in mine if got[i].parent == route]
        rounds = int(res.rounds.max())
        assert inner == ["beam.init"] + ["beam.round"] * rounds
        assert _syncs(counts, call) == rounds + 1
        assert counts[("beam.fused", call)] == rounds     # every round classic
    assert {name for name, _ in counts} == {"sync", "beam.fused"}


@pytest.mark.parametrize("opts", OPTS, ids=lambda o: ",".join(o) or "classic")
def test_recorder_off_records_nothing_and_changes_nothing(recorder, opts):
    eng, q = _engine("hybrid"), _queries()
    eng.search(q, k=5, h=16, **opts)              # any lazy set-up (the seed index)
    off = eng.search(q, k=5, h=16, **opts)
    assert spans.drain() == ([], {})
    spans.enable(True)
    on = eng.search(q, k=5, h=16, **opts)
    spans.enable(False)
    for f in FIELDS:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    got, counts = spans.drain()
    call = got[0].call
    prune_copies = 1 if opts.get("prune_eps") else 0
    assert _syncs(counts, call) == int(on.rounds.max()) + 1 + prune_copies
    assert sum(s.name == "beam.round" for s in got) == int(on.rounds.max())
    classic = not (opts.get("expand", 1) > 1 or opts.get("prune_eps"))
    assert counts.get(("beam.fused", call), 0) == (int(on.rounds.max()) if classic else 0)


def test_pruned_beam_without_scale_counts_each_copy(recorder):
    eng = _engine("hybrid")
    luts = eng.lut_fn(_queries())
    off = _pruned_beam(eng, luts)
    spans.enable(True)
    on = _pruned_beam(eng, luts)
    spans.enable(False)
    for f in FIELDS:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    got, counts = spans.drain()
    assert got[0].name == "beam.init" and got[0].parent == -1
    # no engine call around the beam: each of its spans is a root of its own
    assert sum(counts.values()) == counts[("sync", got[0].call)] + int(on.rounds.max())
    assert sum(counts.values()) == int(on.rounds.max()) + 1 + 3


def test_drain_clears_and_an_exception_closes_its_spans(recorder):
    eng, q = _engine("hybrid"), _queries()
    inner = eng.lut_fn

    def failing(qq):
        raise RuntimeError("lut")

    spans.enable(True)
    eng.lut_fn = failing
    with pytest.raises(RuntimeError):
        eng.search(q, k=5, h=16)
    eng.lut_fn = inner
    eng.search(q, k=5, h=16)
    spans.count("outside")
    spans.end(0)                                  # no longer open: ignored
    spans.enable(False)
    got, counts = spans.drain()
    assert [s.name for s in got if s.parent == -1] == ["search", "search"]
    assert all(s.end_ns >= s.start_ns > 0 for s in got)
    assert got[1].name == "search.lut" and got[1].end_ns == got[0].end_ns
    assert counts[("outside", -1)] == 1
    assert spans.drain() == ([], {})


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["classic", "prune", "prune_unscaled"])
def test_sync_counter_matches_sync_debug_mode(recorder, how):
    """Every operation that makes the host wait for the card, as the sync
    debug mode reports them, is counted, and nothing else is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng, q = _engine("hybrid", "cuda"), _queries("cuda")
    if how == "prune_unscaled":
        luts = eng.lut_fn(q)

        def run():
            return _pruned_beam(eng, luts)
    else:
        opts = {"prune_eps": 0.3} if how == "prune" else {}

        def run():
            return eng.search(q, k=5, h=16, **opts)
    run()                                         # kernels built, caches warm
    torch.cuda.synchronize()
    spans.enable(True)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    spans.enable(False)
    _, counts = spans.drain()
    reported = sum("synchroniz" in str(w.message) for w in caught)
    syncs = sum(v for (name, _), v in counts.items() if name == "sync")
    assert {name for name, _ in counts} <= {"sync", "beam.fused"}
    assert reported == syncs > int(res.rounds.max())
