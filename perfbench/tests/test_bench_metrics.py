"""The metric arithmetic: the readers on a synthetic run, the idle share
from synthetic intervals, and the roofline counts against hand counts."""

import numpy as np
import pytest
import torch

from perfbench import harness, readers, roofline, trace, traffic


def record(calls, latency=(), trace_=None, recorders=None):
    win = traffic.Window(calls=calls, queries=[], ids=[], dists=[],
                         latency_s=np.asarray(latency, float), attempted=sum(c.n for c in calls),
                         window_s=10.0, answered_in_window=sum(c.n for c in calls))
    return harness.Record("w", {}, {}, 1, 10.0, 3.5, win, recall=0.9, trace=trace_,
                          recorders=recorders or {})


CALLS = [traffic.Call(100, 0.0, 0.5, 50, 2000, 900), traffic.Call(300, 0.5, 2.0, 150, 9000, 3000)]


def test_counter_readers():
    rec = record(CALLS)
    assert readers.beam_rounds(rec) == 100.0
    assert readers.round_ms(rec) == pytest.approx(1e3 * 2.0 / 200)
    assert readers.n_dist_per_query(rec) == pytest.approx(11000 / 400)
    assert readers.batch_queries(rec) == 200.0
    assert harness.load_reader("qps").read(rec) == 40.0
    assert harness.load_reader("setup_s").read(rec) == 3.5
    assert harness.load_reader("recall_at_10").read(rec) == 0.9
    assert readers.beam_rounds(record([])) is None
    assert readers.device_idle(rec) is None            # untraced: nothing to read


def test_traced_run_profiles_a_window_after_the_measured_one(index_cache):
    """The measured window runs with no profiler and no recorder; the
    profiler sees only the traced window that follows it."""
    from perfbench.tests.conftest import TINY

    st = harness.setup(harness.find_cell(harness.load_benchmark(), "sift1m-u8.offline"),
                       "cpu", TINY)
    reader = harness.load_reader("hop_adc_roofline")
    win, traced, t, recorders, _, cost = harness.run_window(st, 3, 1.0, trace_readers=[reader])
    assert win.calls and traced.calls and t is not None and cost["start"] >= 0
    r = recorders[reader.ENTRY]
    # every recorded launch is the traced window's: one per round and call, plus each entry
    assert r.calls == sum(c.rounds + 1 for c in traced.calls)
    assert t.window[0] <= t.spans[0][1] and t.spans[-1][2] <= t.window[1] + 1e-3


def test_set_up_phases_in_order(index_cache):
    """Set-up reports its seconds by phase, in the order they ran, one
    warm-up phase for each shape the mix sends."""
    from perfbench.tests.conftest import TINY

    st = harness.setup(harness.find_cell(harness.load_benchmark(), "deep1m-fs4.online"),
                       "cpu", TINY)
    assert list(st.phases) == ["base", "engine_import", "index_imports", "index_key",
                               "index_load", "index_to_device", "index_encode",
                               "index_engine", f"warm_{TINY['max_batch']}", "warm_1"]
    assert all(v >= 0 for v in st.phases.values())


def test_p95_over_every_query():
    lat = np.arange(1, 101) / 1000.0           # 1..100 ms
    got = harness.load_reader("latency_p95_ms").read(record(CALLS, lat))
    assert got == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert 95.0 <= got <= 96.0


def test_idle_share_from_intervals():
    ops = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("k3", 4.0, 5.0), ("k4", 9.5, 11.0)]
    # many short runtime calls, then a gap whose midpoint only a span covers
    launches = [("cudaLaunchKernel", 5.0 + i * 1e-4, 5.0 + i * 1e-4 + 5e-5) for i in range(500)]
    t = trace.DeviceTrace(ops, [("inner", 2.5, 3.5)] + launches, (0.0, 10.0),
                          [("bench: search call", 2.0, 4.0), ("bench: search call", 5.0, 8.0)])
    assert t.busy_intervals() == [(0.0, 2.0), (4.0, 5.0), (9.5, 10.0)]
    assert t.busy_s() == pytest.approx(3.5)
    assert readers.device_idle(record(CALLS, trace_=t)) == pytest.approx(65.0)
    gaps = dict(t.idle_by_host())
    assert gaps["inner"] == pytest.approx(2.0)          # 2-4: midpoint 3 in "inner"
    assert gaps["bench: search call"] == pytest.approx(4.5)   # 5-9.5: midpoint 7.25
    assert trace.OUTSIDE not in gaps
    assert t.top_ops(2) == [["k2", 1.5], ["k4", 1.5]]


def test_hop_adc_bytes_by_hand():
    # 3 rows of M=2 codes; 2 queries x 3 slots; K=4
    codes = torch.tensor([[0, 1], [0, 2], [3, 1], [0, 0]], dtype=torch.uint8)
    ids = torch.tensor([[0, 1, 1], [2, 2, 3]])
    luts = torch.zeros(2, 2, 4)
    nbytes, ops = roofline.hop_adc_cost(codes, ids, luts)
    rows = 4            # ids 0, 1, 2, 3
    # query 0 reads (j0: code 0) and (j1: codes 1, 2); query 1 (j0: 3, 0), (j1: 1, 0)
    entries = 1 + 2 + 2 + 2
    assert nbytes == 4 * 6 + rows * 2 + 4 * entries + 4 * 6
    assert ops == 6 * 2


def test_hop_adc_fs_bytes_by_hand():
    # M=3 sub-codes packed in 2 bytes per row
    packed = torch.tensor([[0x21, 0x03], [0x21, 0x04], [0x11, 0x01]], dtype=torch.uint8)
    ids = torch.tensor([[0, 1], [2, 2]])
    lut = torch.zeros(2, 3, 16, dtype=torch.uint8)
    nbytes, ops = roofline.hop_adc_fs_cost(packed, ids, lut, None, None)
    # q0: j0 {1}, j1 {2}, j2 {3, 4}; q1: j0 {1}, j1 {1}, j2 {1}
    entries = 1 + 1 + 2 + 3
    assert nbytes == 4 * 4 + 3 * 2 + entries + 4 * 4
    assert ops == 4 * 3


def test_roofline_pairs_launches_with_kernels(monkeypatch):
    from repro_torch.kernels import ops as kops

    r = trace.Recorder("repro_torch.kernels.ops", "hop_adc", 1 << 30)
    try:
        r.on = True
        codes = torch.randint(0, 256, (101, 16), dtype=torch.uint8)
        luts = torch.rand(4, 16, 256)
        for _ in range(3):
            kops.hop_adc(codes, torch.randint(0, 101, (4, 64)), luts)
        r.on = False
    finally:
        r.remove()
    assert kops.hop_adc is r.orig and r.calls == 3 and len(r.launches) == 3
    bound = sum(roofline.bound_s(*roofline.hop_adc_cost(*ln.args)) for ln in r.launches)
    ks = [("void hop_adc_kernel<unsigned char>", i * 1e-3, i * 1e-3 + bound) for i in range(3)]
    t = trace.DeviceTrace(ks + [("other", 0.0, 1.0)], [], (0.0, 1.0))
    rec = record(CALLS, trace_=t, recorders={("repro_torch.kernels.ops", "hop_adc"): r})
    reader = harness.load_reader("hop_adc_roofline")
    assert reader.read(rec) == pytest.approx(100.0 / 3)
    t.device_ops.pop(0)                                  # a kernel missing: no pairing
    assert reader.read(rec) is None
