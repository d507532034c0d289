"""What the program's span recorder (``repro_torch.common.spans``) changes in
one cell, in one process after one set-up:

    python3 -E perfbench/tools/spancost.py --workload <cell> --seed <n> \\
        [--pairs 6] [--seconds 10] [--batches 3]

- parity: ``--batches`` calls of the mix's batch, each searched with the
  recorder off and then on; ids, distances, ``hops``, ``n_dist``, ``rounds``
  and ``truncated`` must be equal bit for bit;
- cost (closed mixes): ``--pairs`` pairs of windows of ``--seconds`` each,
  recorder on and off, in turns (which side goes first alternates), with
  ``round_ms`` read from each as ``round_ms.offline`` reads it (host time of
  the calls over their rounds), and the medians of each side, and, from the spans of each window with the recorder on, the mean host
  time of a ``beam.round`` span and the ``sync`` count per round;
- the host time of one round's sites (``beam.round`` begun and ended, one
  ``sync`` counted) with the recorder on and off, over many repetitions.

Prints one JSON line per window and one summary line. Development only: no
cell runs this file.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "perfbench" / ".cache" / sub)
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]

import torch  # noqa: E402

from perfbench import gen, harness, readers, traffic  # noqa: E402
from repro_torch.common import spans  # noqa: E402

FIELDS = ("ids", "dists", "hops", "n_dist", "rounds", "truncated")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def search(st, q):
    res = st.idx.engine.search(q, k=st.cfg["k"], h=st.cfg["beam_h"])
    return {f: getattr(res, f).cpu() for f in FIELDS}


def site_cost_us(reps=200_000):
    """Host microseconds of one round's recorder sites, recorder on and off."""
    out = {}
    for on in (True, False):
        spans.drain()
        spans.enable(on)
        t0 = time.perf_counter()
        for _ in range(reps):
            sp = spans.begin("beam.round") if spans.on else -1
            if spans.on:
                spans.count("sync")
            if sp >= 0:
                spans.end(sp)
        out["on" if on else "off"] = 1e6 * (time.perf_counter() - t0) / reps
        spans.enable(False)
        spans.drain()
    return out


def parity(st, seed, batches):
    stream = gen.QueryStream(st.data, seed, st.device)
    n = st.mix.get("batch", st.mix.get("max_batch"))
    same = True
    for b in range(batches):
        q = stream.take(n)
        off = search(st, q)
        spans.enable(True)
        on = search(st, q)
        spans.enable(False)
        got, counts = spans.drain()
        eq = {f: bool(torch.equal(off[f], on[f])) for f in FIELDS}
        same = same and all(eq.values())
        emit(parity=b, queries=n, equal=eq, spans=len(got), rounds=int(on["rounds"].max()),
             syncs=sum(counts.values()))
    return same


def inside(got, counts):
    """From one window's spans: the mean host time of a ``beam.round``, and
    the ``sync`` count per round."""
    rounds = [s.end_ns - s.start_ns for s in got if s.name == "beam.round"]
    return {"round_host_ms": 1e-6 * statistics.mean(rounds),
            "syncs_per_round": sum(counts.values()) / len(rounds)} if rounds else {}


def cost(st, seed, pairs, seconds):
    stream = gen.QueryStream(st.data, seed, st.device)
    ms = {True: [], False: []}
    for i in range(pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            spans.drain()
            spans.enable(on)
            win = traffic.closed_loop(st.idx.engine, stream, st.mix, st.cfg["k"],
                                      st.cfg["beam_h"], seconds)
            spans.enable(False)
            got, counts = spans.drain()
            rec = harness.Record(st.cfg["name"], st.cfg, st.mix, seed, seconds, 0.0, win)
            ms[on].append(readers.round_ms(rec))
            emit(pair=i, recorder=on, round_ms=ms[on][-1], calls=len(win.calls), spans=len(got),
                 **(inside(got, counts) if on else {}))
    return {"on": statistics.median(ms[True]), "off": statistics.median(ms[False]),
            "on_all": ms[True], "off_all": ms[False]}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=6)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--dev-set", action="append", default=[])
    a = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    overrides = {k: json.loads(v) for k, v in (s.split("=", 1) for s in a.dev_set)}
    st = harness.setup(harness.find_cell(harness.load_benchmark(), a.workload), "cuda", overrides)
    same = parity(st, a.seed, a.batches)
    summary = {"summary": a.workload, "card": card, "parity": same, "site_us": site_cost_us()}
    if st.mix["mode"] == "closed" and a.pairs:
        summary["round_ms"] = cost(st, a.seed, a.pairs, a.seconds)
        summary["on_over_off"] = summary["round_ms"]["on"] / summary["round_ms"]["off"]
    emit(**summary)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
