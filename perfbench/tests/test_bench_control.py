"""``correct`` comes out true on a sound run and false where it must: the
control (the reference at TF32 in the program's place) fails the
comparison, and so does a run whose timed path is broken underneath, once
for each fault a search cell can have. The harness's look for a card is
skipped (``device="cpu"``); the rest of a run is driven as it is."""

import dataclasses

import pytest
import torch

from perfbench import checks, gen, harness, reference
from perfbench.tests.conftest import TINY, run_cpu, tiny_args

CELLS = ("sift1m-u8.offline", "deep1m-fs4.online")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, index_cache):
    rc, res = run_cpu(tiny_args(cell))
    assert rc == 0 and res["correct"], res
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, index_cache):
    bench = harness.load_benchmark()
    st = harness.setup(harness.find_cell(bench, cell), "cpu", TINY)
    win, _, _, _, taps, _ = harness.run_window(st, 5, 1.0)
    out = harness.outputs(st, [win], taps)
    assert out.adc, "no routing launch was sampled"
    theta, cb = st.idx.theta, st.idx.codebooks
    rec = harness.window_recall(out, st.x, 5, st.cfg["k"])
    got = checks.readings(out, st.x, theta, cb, st.cfg, rec)
    ok, table = checks.verdict(got, st.cfg["checks"])
    assert ok, table
    ctl = checks.control(out, st.x, theta, cb, st.cfg)
    got_ctl = checks.readings(ctl, st.x, theta, cb, st.cfg, rec)
    ok, table = checks.verdict(got_ctl, st.cfg["checks"])
    assert not ok, table
    # the control's routing distances are not the program's
    adc = "adc_flips" if st.cfg["layout"] == "fs4" else "adc_err"
    assert got_ctl[adc] > got[adc], (got_ctl[adc], got[adc])


def _altered(search):
    """One answer altered where it is produced: the first query's best id
    replaced by another row, its distance kept."""
    def broken(self, queries, **kw):
        res = search(self, queries, **kw)
        res.ids[0, 0] = (res.ids[0, 0] + 1) % self.codes.shape[0]
        return res
    return broken


def _answers_replaced(search):
    """Every answer replaced where it is produced by valid answers that are
    not the neighbours: each id moved to the next row, its true distance
    given, the row sorted."""
    def broken(self, queries, **kw):
        res = search(self, queries, **kw)
        n = self.codes.shape[0]
        ids = (res.ids.long() + 1) % n
        d = ((self.vectors[ids] - queries[:, None, :]) ** 2).sum(-1)
        d, order = torch.sort(d, dim=1, stable=True)
        res.ids, res.dists = ids.gather(1, order).to(res.ids.dtype), d
        return res
    return broken


def _half_batch(search):
    """Half of the batch left out: only the first half of the queries is
    searched; the rest come back empty (sentinel ids, infinite distances)."""
    def broken(self, queries, **kw):
        half = max(1, queries.shape[0] // 2)
        res = search(self, queries[:half], **kw)
        pad = queries.shape[0] - half
        fill = lambda t, v: torch.cat([t, torch.full((pad,) + t.shape[1:], v, dtype=t.dtype)])
        res.ids = fill(res.ids, self.codes.shape[0])
        res.dists = fill(res.dists, float("inf"))
        for f in ("hops", "n_dist", "rounds", "truncated"):
            setattr(res, f, fill(getattr(res, f), 0))
        return res
    return broken


def _unchanged(search):
    """A step that returns its state unchanged: every call after the first
    returns the first call's answers."""
    first = {}

    def broken(self, queries, **kw):
        res = search(self, queries, **kw)
        n = queries.shape[0]
        if "res" in first and first["res"].ids.shape[0] >= n:
            old = first["res"]
            res.ids, res.dists = old.ids[:n].clone(), old.dists[:n].clone()
        elif n > 1:
            first["res"] = res
        return res
    return broken


@pytest.mark.parametrize("fault", [_altered, _answers_replaced, _half_batch, _unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, index_cache, monkeypatch):
    from repro_torch.search.engine import HybridEngine

    rc, _ = run_cpu(tiny_args(cell))          # build (or load) outside the fault
    monkeypatch.setattr(HybridEngine, "search", fault(HybridEngine.search))
    rc, res = run_cpu(tiny_args(cell, seed=8))
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_routing_at_lower_precision_is_not_correct(cell, index_cache, monkeypatch):
    """The routing kernel's distances rounded to bfloat16 underneath the
    search: the answers stay valid with exact distances, and the sampled
    launches' comparison with the reference's sums fails."""
    import importlib

    layout = "fs4" if "fs4" in cell else "u8"
    module, name = checks.ROUTING[layout]
    rc, _ = run_cpu(tiny_args(cell))
    orig = getattr(importlib.import_module(module), name)
    monkeypatch.setattr(importlib.import_module(module), name,
                        lambda *a, **kw: orig(*a, **kw).bfloat16().float())
    rc, res = run_cpu(tiny_args(cell, seed=9))
    adc = "adc_flips" if layout == "fs4" else "adc_err"
    assert rc == 0 and res["correct"] is False, res["checks"]
    assert res["checks"][adc]["value"] > res["checks"][adc]["limit"], res["checks"]


def _whole_base_id_faults(ids, dists, n, k):
    """The read-only comparison as it stood before write logs: an id
    outside [0, n) is a fault."""
    bad = (ids < 0).any(1) | (ids >= n).any(1) | ~torch.isfinite(dists).all(1)
    if ids.shape[1] != k:
        return ids.shape[0]
    s, _ = torch.sort(ids.long(), dim=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(1)
    bad |= (dists[:, 1:] < dists[:, :-1]).any(1)
    return int(bad.sum())


def _whole_base_dist_err(out, x):
    n, worst, scales = x.shape[0], 0.0, []
    for s in range(0, out.ids.shape[0], checks.BLOCK):
        ids = out.ids[s:s + checks.BLOCK].to(x.device).long()
        d = out.dists[s:s + checks.BLOCK].to(x.device).float()
        ok = (ids >= 0) & (ids < n)
        d_ref = reference.pair_distances(out.queries[s:s + checks.BLOCK], x[torch.where(ok, ids, 0)])
        gap = torch.where(ok & torch.isfinite(d), (d - d_ref).abs(), 0.0)
        worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
        scales.append(d_ref[ok])
    scale = float(torch.cat(scales).median()) if scales else 1.0
    return worst / max(scale, 1e-30)


@pytest.mark.parametrize("cell", CELLS)
def test_read_only_path_judges_against_the_whole_base(cell, index_cache):
    """A mix that writes nothing leaves the log empty: the live set is the
    base and ids are keys, so the check table, the control's answers and
    the recall are the numbers of the comparison over the whole base, with
    ``reference.exact_topk`` over the whole base as the recall's yardstick."""
    st = harness.setup(harness.find_cell(harness.load_benchmark(), cell), "cpu", TINY)
    win, _, _, _, taps, _ = harness.run_window(st, 3, 1.0)
    out = harness.outputs(st, [win], taps)
    assert out.writes is None and out.pos.shape[0] == out.ids.shape[0] and not out.pos.any()
    k, n = st.cfg["k"], st.x.shape[0]
    pick = torch.randperm(out.ids.shape[0],
                          generator=gen.generator("cpu", 3, gen.SAMPLE))[:harness.RECALL_MAX]
    truth = reference.exact_topk(st.x, out.queries[pick], k)
    rec = harness.window_recall(out, st.x, 3, k)
    assert rec == checks.recall(out.ids[pick], truth, k)
    theta, cb = st.idx.theta, st.idx.codebooks
    got = checks.readings(out, st.x, theta, cb, st.cfg, rec)
    assert got["id_faults"] == out.unanswered + _whole_base_id_faults(out.ids, out.dists, n, k)
    assert got["dist_err"] == _whole_base_dist_err(out, st.x)
    # ids outside the base, below it and twice: the same faults either way
    ids = out.ids.clone()
    ids[0, 0], ids[1, 1], ids[2, 1] = n, -1, ids[2, 0]
    bad = dataclasses.replace(out, ids=ids)
    assert checks.readings(bad, st.x, theta, cb, st.cfg, rec)["id_faults"] == \
        out.unanswered + _whole_base_id_faults(ids, out.dists, n, k) >= 3
    assert checks.readings(bad, st.x, theta, cb, st.cfg, rec)["dist_err"] == \
        _whole_base_dist_err(bad, st.x)
    ctl = checks.control(out, st.x, theta, cb, st.cfg)
    for s in range(0, out.ids.shape[0], checks.BLOCK):
        blk = out.ids[s:s + checks.BLOCK].long().clamp(0, n - 1)
        d = reference.pair_distances(out.queries[s:s + checks.BLOCK], st.x[blk], tf32=True)
        d, order = torch.sort(d, dim=1, stable=True)
        assert torch.equal(ctl.ids[s:s + checks.BLOCK], blk.gather(1, order).to(ctl.ids.dtype))
        assert torch.equal(ctl.dists[s:s + checks.BLOCK], d)
