"""Runs of one cell, one process each, as the benchmark's command runs
them, with the spread of each metric:

    python3 perfbench/tools/series.py --workload <cell> --seeds 1,2,3 \\
        --seconds 30 [--trace 0|1] [--out runs.jsonl]

Prints one JSON line per run (the run's result, its seed, its exit code and
wall seconds; on failure the end of its standard error), then one summary
line: per metric the median and the spread (the distance between the first
and third quartiles by ``statistics.quantiles(values, n=4)``, as a share of
the median). Development only: no cell runs this file.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values)) if statistics.median(values) else None


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--dev-set", action="append", default=[])
    a = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rows = []
    out = open(a.out, "a") if a.out else None
    for seed in a.seeds.split(","):
        cmd = [sys.executable, "-E", "perfbench/run.py", "--workload", a.workload,
               "--seed", seed, "--seconds", str(a.seconds), "--trace", str(a.trace)]
        for d in a.dev_set:
            cmd += ["--dev-set", d]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        row = {"workload": a.workload, "seed": int(seed), "trace": a.trace, "rc": proc.returncode,
               "wall_s": time.perf_counter() - t0, "card": card}
        try:
            row["result"] = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            row["stderr_tail"] = proc.stderr[-3000:]
        if proc.returncode or not row.get("result", {}).get("correct") or a.trace:
            row["stderr_tail"] = proc.stderr[-3000:]
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    metrics = {}
    for r in rows:
        for name, m in r.get("result", {}).get("metrics", {}).items():
            metrics.setdefault(name, []).append(m["value"])
    summary = {name: {"median": statistics.median(v), "spread": spread(v), "n": len(v),
                      "values": v} for name, v in metrics.items()}
    line = json.dumps({"summary": a.workload, "trace": a.trace, "card": card, "metrics": summary,
                       "correct": [r.get("result", {}).get("correct") for r in rows]})
    print(line, flush=True)
    if out:
        out.write(line + "\n")


if __name__ == "__main__":
    main()
