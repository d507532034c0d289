"""One-time measurements of a cell on the card, in one process after one
set-up (the index is built or loaded once):

    python3 -E perfbench/tools/sweep.py --workload <cell> <what> [...]

- ``probe``: the generator's exhaustive-ADC recall@10 over the whole base
  (the program's scan kernel on its resident codes) and the recall after an
  exact rerank of the ADC top-100, on 1000 queries;
- ``h``: recall@10 of one call of the mix's batch on seed 0 at each beam
  width of ``--hs`` (how the configuration's ``beam_h`` was chosen);
- ``knee``: the cell's window at each rate of ``--rates`` for ``--seconds``:
  queries answered per second, latency and batch size (how the mix's
  ``rate_qps`` was chosen);
- ``readings``: the numbers that decide ``correct`` on each seed of
  ``--seeds`` (a window of ``--seconds`` at the cell's own load; the first
  ``--fresh`` of an open mix with query and gap pools of their own), the
  control's (the reference at TF32 in the program's place) on the first
  ``--control`` of them, and each fault of ``--faults`` planted in the
  timed path on each seed of ``--fault-seeds``.

Each result is one JSON line on standard output. Development only: no
cell runs this file.
"""

import argparse
import contextlib
import importlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "perfbench" / ".cache" / "torch_extensions")
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import checks, gen, harness, reference, traffic  # noqa: E402


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def emit(**kw):
    print(json.dumps(kw), flush=True)


def probe(st, n_q=1000):
    from repro_torch.search.engine import _bulk_adc

    q = gen.QueryStream(st.data, 0, st.device).take(n_q)
    truth = reference.exact_topk(st.x, q, 10)
    luts = st.idx.engine.lut_fn(q)
    d = _bulk_adc(st.idx.codes, luts)
    top = torch.topk(d, 100, dim=1, largest=False).indices
    adc10 = checks.recall(top[:, :10].cpu(), truth, 10)
    exact = reference.pair_distances(q, st.x[top])
    rr = top.gather(1, torch.argsort(exact, dim=1, stable=True)[:, :10])
    emit(what="probe", adc_recall_at_10=adc10, rerank100_recall_at_10=checks.recall(rr.cpu(), truth, 10),
         queries=n_q, n_base=st.x.shape[0])


def sweep_h(st, hs):
    n = st.mix.get("batch", st.mix.get("max_batch"))
    q = gen.QueryStream(st.data, 0, st.device).take(n)
    truth = reference.exact_topk(st.x, q, 10)
    chosen = None
    for h in hs:
        traffic.search(st.idx.engine, q, st.cfg["k"], h)      # warm
        sync()
        t0 = time.perf_counter()
        ids, _, (rounds, nd, hops) = traffic.search(st.idx.engine, q, st.cfg["k"], h)
        dt = time.perf_counter() - t0
        r = checks.recall(ids, truth, 10)
        emit(what="h", h=h, recall_at_10=r, call_s=dt, qps=n / dt, rounds=rounds,
             n_dist_per_query=nd / n)
        if r >= 0.95 and chosen is None:
            chosen = h
    # the smallest h reaching the paper's operating point, else the widest;
    # later steps of this process run at it
    st.cfg["beam_h"] = max(hs) if chosen is None else chosen
    emit(what="h_chosen", h=st.cfg["beam_h"])


def knee(st, rates, seconds, seed):
    """The cell's own window (``harness.run_window``) at each rate in turn;
    the knee is the highest rate sustained: answered in the window at 0.95
    of the rate or more, and the last quarter's queries waiting at most
    1.25 times as long as the first quarter's (the backlog does not grow).
    Later steps of this process run at 0.8 of it."""
    base, sustained = dict(st.mix), []
    for rate in rates:
        st.mix = dict(base, rate_qps=rate, drain_s=10)
        win = harness.run_window(st, seed, seconds)[0]
        lat, q4 = win.latency_s, max(1, len(win.latency_s) // 4)
        first, last = float(np.mean(lat[:q4])), float(np.mean(lat[-q4:]))
        emit(what="knee", rate_qps=rate, answered_in_window_qps=win.answered_in_window / seconds,
             latency_p50_ms=float(np.percentile(lat, 50) * 1e3),
             latency_p95_ms=float(np.percentile(lat, 95) * 1e3),
             mean_batch=float(np.mean([c.n for c in win.calls])), calls=len(win.calls),
             unanswered=win.attempted - win.answered, late_s=win.late_s,
             latency_mean_first_quarter_ms=first * 1e3, latency_mean_last_quarter_ms=last * 1e3,
             h=st.cfg["beam_h"])
        if win.answered_in_window >= 0.95 * rate * seconds and last <= 1.25 * first:
            sustained.append(rate)
    st.mix = dict(base, rate_qps=round(0.8 * max(sustained), -2) if sustained else base["rate_qps"])
    emit(what="knee_chosen", knee_qps=max(sustained) if sustained else None,
         rate_qps=st.mix["rate_qps"])


@contextlib.contextmanager
def planted(st, fault):
    """A fault in the timed path: ``bf16``, the routing kernel's distances
    rounded to bfloat16 (routing at a lower precision); ``h_half``, the
    beam cut to half its width (half the search left out)."""
    if fault == "bf16":
        module, name = checks.ROUTING[st.cfg["layout"]]
        mod = importlib.import_module(module)
        orig = getattr(mod, name)
        setattr(mod, name, lambda *a, **kw: orig(*a, **kw).bfloat16().float())
        try:
            yield
        finally:
            setattr(mod, name, orig)
    elif fault == "h_half":
        h = st.cfg["beam_h"]
        st.cfg["beam_h"] = h // 2
        try:
            yield
        finally:
            st.cfg["beam_h"] = h
    else:
        raise ValueError(fault)


def reading(st, seed, seconds, side, n_control=0):
    """One window at ``seed`` and the numbers compared, with the verdict
    under the configuration's limits; on ``n_control`` > 0 the control's
    numbers for the same window too."""
    theta, cb = st.idx.theta, st.idx.codebooks
    win, _, _, _, taps, _ = harness.run_window(st, seed, seconds)
    out = harness.outputs(st, [win], taps)
    rec = harness.window_recall(out, st.x, seed, st.cfg["k"])
    got = checks.readings(out, st.x, theta, cb, st.cfg, rec)
    ok, _ = checks.verdict(got, st.cfg["checks"])
    emit(what="readings", seed=seed, side=side, correct=ok, answers=out.ids.shape[0],
         adc_launches=len(out.adc), **got)
    if n_control:
        ctl = checks.control(out, st.x, theta, cb, st.cfg)
        got = checks.readings(ctl, st.x, theta, cb, st.cfg, rec)
        ok, _ = checks.verdict(got, st.cfg["checks"])
        emit(what="readings", seed=seed, side="control", correct=ok, **got)


def readings(st, seeds, seconds, n_control, n_fresh, faults, fault_seeds):
    """The program on ``seeds`` (the first ``n_fresh`` of an open mix with
    pools of their own: ``query_seed`` and ``gap_seed`` set to the seed),
    the control on the first ``n_control``, each fault on ``fault_seeds``."""
    base = dict(st.mix)
    for i, seed in enumerate(seeds):
        fresh = i < n_fresh and base["mode"] == "open"
        st.mix = dict(base, query_seed=seed, gap_seed=seed) if fresh else base
        reading(st, seed, seconds, "program, fresh pools" if fresh else "program",
                n_control=int(i < n_control))
    st.mix = base
    for fault in faults:
        for seed in fault_seeds:
            with planted(st, fault):
                reading(st, seed, seconds, f"fault {fault}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("what", choices=("probe", "h", "knee", "readings"), nargs="+")
    p.add_argument("--hs", default="32,48,64,96,128")
    p.add_argument("--rates", default="")
    p.add_argument("--seeds", default="")
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fresh", type=int, default=0)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--dev-set", action="append", default=[])
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal at a small size")
    a = p.parse_args()
    t0 = time.perf_counter()
    cell = harness.find_cell(harness.load_benchmark(), a.workload)
    over = {k: json.loads(v) for k, v in (s.split("=", 1) for s in a.dev_set)}
    st = harness.setup(cell, a.device, over)
    sync()
    emit(what="setup", seconds=time.perf_counter() - t0, built=st.idx.built,
         build_s=st.idx.build_s,
         device=torch.cuda.get_device_name(0) if a.device == "cuda" else a.device)
    for w in a.what:
        if w == "probe":
            probe(st)
        elif w == "h":
            sweep_h(st, [int(h) for h in a.hs.split(",")])
        elif w == "knee":
            knee(st, [float(r) for r in a.rates.split(",")], a.seconds, 0)
        else:
            readings(st, [int(s) for s in a.seeds.split(",")], a.seconds, a.control, a.fresh,
                     [f for f in a.faults.split(",") if f],
                     [int(s) for s in a.fault_seeds.split(",") if s])


if __name__ == "__main__":
    main()
