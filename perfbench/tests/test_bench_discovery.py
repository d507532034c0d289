"""A cell, a mix and a metric are found by name: files added to a copy of
the benchmark, and entries added to its BENCHMARK.json, run with no edit
to any file that was there."""

import hashlib
import json
import shutil

from perfbench.tests.conftest import ROOT, run_cpu, tiny_args

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
