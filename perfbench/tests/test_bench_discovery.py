"""A cell, a mix, a metric, an engine and a writing mode are found by
name: files added to a copy of the benchmark, and entries added to its
BENCHMARK.json, run with no edit to any file that was there. A streaming
deployment added so is judged against the rows live at each call: an
acknowledged delete still returned, acknowledged inserts dropped, and
answers read by the ids from before a consolidation each fail."""

import dataclasses
import hashlib
import json
import shutil

import pytest

from perfbench.tests.conftest import ROOT, TINY, run_cpu, tiny_args

NEW_METRIC = '''"""calls_in_window: search calls the window made (a test's metric)."""


def read(rec):
    return float(len(rec.window.calls)) or None
'''


def digest(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path, index_cache):
    root = tmp_path / "checkout"
    bench_dir = root / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench_dir,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    before = digest(bench_dir)
    cfg = json.loads((bench_dir / "configs" / "deep1m-rpq-fs4.json").read_text())
    cfg.update(name="deep-test", dim=64)
    (bench_dir / "configs" / "deep-test.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "offline.json").read_text())
    (bench_dir / "traffic" / "small-batches.json").write_text(json.dumps(dict(mix, batch=100)))
    (bench_dir / "metrics" / "calls_in_window.py").write_text(NEW_METRIC)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="deep-test",
                                 file="perfbench/configs/deep-test.json"))
    bench["workloads"].append({"name": "deep-test.small", "config": "deep-test",
                               "traffic": "small-batches", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("deep-test.small")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "harness front",
                               "moves": "qps", "workloads": ["deep-test.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "src").symlink_to(ROOT / "src")
    after = digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before

    argv = tiny_args("deep-test.small")
    argv[argv.index("batch=400")] = "batch=100"
    rc, res = run_cpu(argv, bench_dir=bench_dir, root=root)
    assert rc == 0 and res["correct"], res
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert res["metrics"]["qps"]["unit"] == "queries/s"
    rc, res = run_cpu(tiny_args("deep-test.small", trace=1), bench_dir=bench_dir, root=root)
    assert rc == 0 and res["metrics"]["calls_in_window"]["value"] >= 1
    assert res["metrics"]["calls_in_window"]["unit"] == "calls"


PLUGINS = ROOT / "perfbench" / "tests" / "plugins"
STREAM = "sift-stream.churn"


def stream_args(seed):
    """A tiny run of the streaming cell: calls of 100 queries, 4 s, so
    that the window holds several rounds of writes on the CPU."""
    argv = tiny_args(STREAM, seed=seed, seconds=4.0)
    argv[argv.index("batch=400")] = "batch=100"
    return argv


@pytest.fixture(scope="module")
def stream_copy(tmp_path_factory):
    """A copy of the benchmark with a streaming deployment added as new
    files and entries only: ``engines/streaming.py`` (the program's
    ``StreamingEngine``), ``modes/churn.py`` (deletes, inserts and
    consolidations between search calls), its configuration and its mix,
    all from ``perfbench/tests/plugins``. Returns (checkout, perfbench dir)."""
    root = tmp_path_factory.mktemp("stream") / "checkout"
    bench_dir = root / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench_dir,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    before = digest(bench_dir)
    for src in sorted(p for p in PLUGINS.rglob("*") if p.is_file() and p.suffix in (".py", ".json")):
        dst = bench_dir / src.relative_to(PLUGINS)
        assert not dst.exists(), dst
        dst.parent.mkdir(exist_ok=True)
        shutil.copyfile(src, dst)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="sift-stream",
                                 file="perfbench/configs/sift-stream.json"))
    bench["workloads"].append({"name": STREAM, "config": "sift-stream", "traffic": "churn",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append(STREAM)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "src").symlink_to(ROOT / "src")
    after = digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    assert {"engines/streaming.py", "modes/churn.py"} <= set(after) - set(before)
    return root, bench_dir


def test_streaming_engine_and_writing_mode_are_found_by_name(stream_copy, index_cache):
    root, bench_dir = stream_copy
    rc, res = run_cpu(stream_args(7), bench_dir=bench_dir, root=root)
    assert rc == 0 and res["correct"], res
    assert res["failed"] == 0 and res["attempted"] >= 300
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def _deletes_ignored(engine_cls):
    """(a) A delete acknowledged and not done: the row stays live."""
    return {"delete": lambda self, ids: len(ids)}


def _inserts_dropped(engine_cls):
    """(b) An insert acknowledged and dropped: the rows are tombstoned as
    they land, so no search finds them and a consolidation drops them."""
    insert = engine_cls.insert

    def dropped(self, vectors):
        ids = insert(self, vectors)
        self.tombstones.add(ids)
        self._dirty = True
        return ids
    return {"insert": dropped}


@pytest.mark.parametrize("fault,number", [(_deletes_ignored, "id_faults"),
                                          (_inserts_dropped, "recall_loss")])
def test_write_faults_are_not_correct(fault, number, stream_copy, index_cache, monkeypatch):
    from repro_torch.index import StreamingEngine

    root, bench_dir = stream_copy
    rc, res = run_cpu(stream_args(8), bench_dir=bench_dir, root=root)   # build outside the fault
    assert rc == 0 and res["correct"], res["checks"]
    honest = res["checks"][number]["value"]
    for name, method in fault(StreamingEngine).items():
        monkeypatch.setattr(StreamingEngine, name, method)
    rc, res = run_cpu(stream_args(8), bench_dir=bench_dir, root=root)
    assert rc == 0 and res["correct"] is False, res["checks"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"] >= honest, res["checks"]


def test_stale_map_is_not_correct(stream_copy, index_cache):
    """(c) The answers after a consolidation judged by the ids from before
    it: the log's remaps left out."""
    from perfbench import checks, harness

    root, bench_dir = stream_copy
    st = harness.setup(harness.find_cell(harness.load_benchmark(root), STREAM), "cpu",
                       dict(TINY, batch=100), bench_dir=bench_dir)
    win, _, _, _, taps, _ = harness.run_window(st, 9, 4.0)
    out = harness.outputs(st, [win], taps)
    remapped = [i for i, e in enumerate(out.writes.log) if e[0] == "remap"]
    assert remapped and win.calls[-1].log_pos > remapped[0], "no call after a consolidation"

    def verdict(o):
        rec = harness.window_recall(o, st.x, 9, st.cfg["k"])
        got = checks.readings(o, st.x, st.idx.theta, st.idx.codebooks, st.cfg, rec)
        return checks.verdict(got, st.cfg["checks"])

    ok, table = verdict(out)
    assert ok, table
    stale = dataclasses.replace(out.writes, log=[e for e in out.writes.log if e[0] != "remap"])
    ok, table = verdict(dataclasses.replace(out, writes=stale))
    assert not ok and table["id_faults"]["value"] > 0, table
