"""The benchmark of ``repro_torch``: one run of one cell.

``python3 -E perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. The cell's entry in
``BENCHMARK.json`` names its configuration (``perfbench/configs/<name>.json``)
and its traffic mix (``perfbench/traffic/<name>.json``); each metric the
cell reports is read by ``perfbench/metrics/<metric>.py``. A configuration
may name its serving engine (``"engine"``, made by
``perfbench/engines/<engine>.py``; default ``hybrid``), and a mix whose
``mode`` is neither ``closed`` nor ``open`` is driven by
``perfbench/modes/<mode>.py``. Nothing of a configuration, a mix, an
engine, a mode or a metric is written here, so each is added by adding
files and entries.

A run: set-up (the base from the configuration's data seed, the program's
index from the cache or built, the resident codes, the engine, one warm-up
call of each shape), the window (the mix driving the engine's ``search``,
and a writing mode its writes between calls; a traced run then starts the
profiler and runs a short second window of the same mix under it, so the
measured window runs as in an untraced run), then, with the program's state
freed, the comparison with the plain reference. It prints the numbers
compared beside their limits as the last lines of standard error, and one
JSON line as the last line of standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import checks, gen, index, traffic
from perfbench import trace as tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LUT_KEEP_ROWS = 20000      # rows of the routing's lookup tables kept for the check
RECORD_BYTES = 3 << 30     # id tensors a traced run keeps for the roofline counts
RECALL_MAX = 500_000       # answers whose recall is read: all, or this many drawn from the seed
ADC_SAMPLES = 16           # routing launches kept for the check, one in each 16th of the window
TRACE_S = 5.0              # seconds of the traced window that follows the measured one


# ---------------------------------------------------------------- discovery

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_data(kind: str, name: str, bench: Path = BENCH) -> dict:
    """``perfbench/<kind>/<name>.json``: a configuration or a mix."""
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"perfbench: no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def load_module(folder: str, name: str, bench: Path = BENCH):
    """The module ``perfbench/<folder>/<name>.py``."""
    path = bench / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"perfbench: no module {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench: Path = BENCH):
    """The metric reader ``perfbench/metrics/<name>.py``."""
    return load_module("metrics", name, bench)


def load_mode(mix: dict, bench: Path = BENCH):
    """The module that drives a mix whose ``mode`` is neither of
    ``traffic.py``'s ``closed`` and ``open``: ``perfbench/modes/<mode>.py``,
    with ``warm_shapes(mix)``, the query batch sizes its windows send, and
    ``driver(setup, seed, seconds)``, which returns ``window(length)``, a
    function that drives one window and returns its ``traffic.Window``. A
    driver may call the engine's own write methods between search calls,
    never inside one, logs them in a ``traffic.Writes`` that the window
    carries, and records each call's place in that log (``Call.log_pos``).
    None for ``closed`` and ``open``."""
    return None if mix["mode"] in ("closed", "open") else load_module("modes", mix["mode"], bench)


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The entries of ``section`` that the cell reports: those without a
    ``workloads`` list, and those whose list names the cell."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")


# -------------------------------------------------------------------- run

@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""
    workload: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    setup_s: float
    window: traffic.Window
    recall: float = None
    trace: tracing.DeviceTrace = None
    recorders: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Setup:
    cfg: dict
    mix: dict
    data: dict                # the generator's constants with dim and n_base
    x: torch.Tensor
    idx: index.Index
    device: object
    routing: tuple            # (module, entry point) of the routing kernel the check samples
    mode: object = None       # the mix's mode module; None for closed and open
    phases: dict = None       # seconds of set-up by phase


def setup(cell: dict, device, overrides: dict = None, use_cache: bool = True,
          bench_dir: Path = BENCH) -> Setup:
    """The base, the program's index and one warm-up call of each shape
    the mix will send."""
    cfg = load_data("configs", cell["config"], bench_dir)
    mix = load_data("traffic", cell["traffic"], bench_dir)
    for key, val in (overrides or {}).items():
        (cfg if key in cfg else mix if key in mix else cfg["data"])[key] = val
    phases = Phases(device)
    data = data_spec(cfg)
    x = gen.base(data, device)
    phases.mark("base")
    engine_mod = load_module("engines", cfg.get("engine", "hybrid"), bench_dir)
    phases.mark("engine_import")
    idx = index.load_or_build(cfg, x, device, engine_mod.make, use_cache=use_cache,
                              mark=phases.mark)
    mode = load_mode(mix, bench_dir)
    warm = gen.QueryStream(data, data["seed"], device)
    shapes = (mode.warm_shapes(mix) if mode else
              [mix["batch"]] if mix["mode"] == "closed" else [mix["max_batch"], 1])
    for n in shapes:
        traffic.search(idx.engine, warm.take(n), cfg["k"], cfg["beam_h"])
        phases.mark(f"warm_{n}")
    routing = getattr(engine_mod, "ROUTING", None) or checks.ROUTING[cfg["layout"]]
    return Setup(cfg, mix, data, x, idx, device, routing, mode, phases.spent)


class Phases:
    """Seconds of set-up by phase, each closed once the device is done."""

    def __init__(self, device):
        self.device, self.spent, self.t = device, {}, time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.spent[name], self.t = now - self.t, now


def data_spec(cfg: dict) -> dict:
    """The generator's constants: the configuration's ``data`` group with
    its ``dim`` and ``n_base``."""
    return {**cfg["data"], "dim": cfg["dim"], "n_base": cfg["n_base"]}


class Taps:
    """What the check reads of the timed path, kept by reference: the
    lookup tables that the engine's ``lut_fn`` returns (and their queries)
    until ``rows`` rows are kept, and one launch of the routing kernel
    ``entry`` after each of ``marks`` (seconds from the window's start):
    the call's queries, the codes and ids the kernel was given and the
    distances it returned (ids and distances copied). :meth:`remove` puts
    both back."""

    def __init__(self, engine, entry: tuple, rows: int, marks):
        self.engine, self.inner, self.rows = engine, engine.lut_fn, rows
        self.queries, self.luts, self.kept = [], [], 0
        self.spans = []           # ("bench: lut_fn", start, end) on the Unix clock
        self.marks, self.adc, self.t_start, self.q = sorted(marks), [], None, None
        self.module = importlib.import_module(entry[0])
        self.name, self.orig = entry[1], getattr(self.module, entry[1])
        engine.lut_fn = self
        setattr(self.module, self.name, self._kernel)

    def __call__(self, q):
        t0 = time.time()
        self.q = q
        out = self.inner(q)
        self.spans.append(("bench: lut_fn", t0, time.time()))
        if self.kept < self.rows:
            self.queries.append(q)
            self.luts.append(out)
            self.kept += q.shape[0]
        return out

    def _kernel(self, *args, **kwargs):
        out = self.orig(*args, **kwargs)
        if self.t_start is not None and self.marks and not kwargs.get("m_prefix"):
            now = time.perf_counter() - self.t_start
            if now >= self.marks[0]:
                while self.marks and now >= self.marks[0]:
                    self.marks.pop(0)
                self.adc.append((self.q, args[0], args[1].clone(), out.clone()))
        return out

    def remove(self) -> None:
        self.engine.lut_fn = self.inner
        setattr(self.module, self.name, self.orig)

    def tables(self):
        """(queries, tables) of the kept rows, concatenated."""
        q = torch.cat(self.queries)
        if isinstance(self.luts[0], torch.Tensor):
            return q, torch.cat(self.luts)
        return q, tuple(torch.cat(parts) for parts in zip(*self.luts))


def adc_marks(seed: int, seconds: float, n: int = ADC_SAMPLES) -> list:
    """One time in each n-th of the window, drawn from the seed."""
    u = torch.rand(n, generator=gen.generator("cpu", seed, gen.SAMPLE), dtype=torch.float64)
    return [(i + float(u[i])) * seconds / n for i in range(n)]


def run_window(st: Setup, seed: int, seconds: float, *, trace_readers=(),
               lut_rows: int = LUT_KEEP_ROWS):
    """The measured window of the mix at ``seed``. With ``trace_readers``
    (metric modules), the profiler then starts (its first session in a
    process takes seconds, outside both windows) and a traced window of
    TRACE_S seconds (at most ``seconds``) of the same mix follows, with each
    reader's ``ENTRY`` recorded: the open loop sends the first seconds of
    the same arrivals again, the closed loop goes on with its stream.
    Returns (window, traced window or None, trace or None, recorders, taps,
    the profiler's own cost in seconds or None)."""
    cfg, mix, eng = st.cfg, st.mix, st.idx.engine
    if st.mode is not None:
        window = st.mode.driver(st, seed, seconds)
    elif mix["mode"] == "open":
        due = traffic.arrivals(mix, seed, seconds)
        queries = gen.pooled(st.data, len(due), mix["query_seed"], seed, st.device)

        def window(length):
            n = int(np.searchsorted(due, length))
            return traffic.open_loop(eng, queries[:n], due[:n], mix, cfg["k"], cfg["beam_h"],
                                     length)
    else:
        stream = gen.QueryStream(st.data, seed, st.device)

        def window(length):
            return traffic.closed_loop(eng, stream, mix, cfg["k"], cfg["beam_h"], length)

    def sync():
        if st.device != "cpu" and torch.cuda.is_available():
            torch.cuda.synchronize()

    taps = Taps(eng, st.routing, lut_rows, adc_marks(seed, seconds))
    recorders, tracer, traced, trace = {}, None, None, None
    sync()
    gc.collect()
    gc.disable()
    try:
        taps.t_start = time.perf_counter()
        win = window(seconds)
        sync()
        if trace_readers:
            for mod in trace_readers:
                entry = getattr(mod, "ENTRY", None)
                if entry and entry not in recorders:
                    recorders[entry] = tracing.Recorder(*entry, RECORD_BYTES)
            tracer = tracing.Tracer().__enter__()
            for r in recorders.values():
                r.on = True
            epoch0 = time.time()
            traced = window(min(TRACE_S, seconds))
            sync()
            for r in recorders.values():
                r.on = False
            tracer.finish([("bench: search call", epoch0 + c.t0, epoch0 + c.t1)
                           for c in traced.calls] + taps.spans)
            trace = tracer.trace
    finally:
        gc.enable()
        if tracer and trace is None:
            tracer.prof.__exit__(None, None, None)
        for r in reversed(list(recorders.values())):
            r.remove()
        taps.remove()
    return win, traced, trace, recorders, taps, (tracer.cost_s if trace else None)


def outputs(st: Setup, wins: list, taps: Taps) -> checks.Outputs:
    """What the windows ``wins`` (the measured one, and the traced one if
    any) produced, for the comparison."""
    lq, luts = taps.tables()
    qs, ids, dists = ([t for w in wins for t in getattr(w, f)] for f in ("queries", "ids", "dists"))
    calls = [c for w in wins for c in w.calls]
    writes = next((w.writes for w in wins if w.writes is not None), None)
    return checks.Outputs(
        queries=torch.cat(qs) if qs else st.x[:0],
        ids=torch.cat(ids) if ids else torch.zeros((0, st.cfg["k"]), dtype=torch.int32),
        dists=torch.cat(dists) if dists else torch.zeros((0, st.cfg["k"])),
        unanswered=sum(w.attempted - w.answered for w in wins), lut_queries=lq, luts=luts,
        codes=st.idx.codes, adc=taps.adc,
        pos=torch.tensor([c.log_pos for c in calls], dtype=torch.int64).repeat_interleave(
            torch.tensor([c.n for c in calls], dtype=torch.int64)),
        writes=writes)


def window_recall(out: checks.Outputs, x: torch.Tensor, seed: int, k: int) -> float:
    """Recall@k of the window's answers against the reference's exact top-k
    over the rows live at each one's call: every answer, or RECALL_MAX of
    them drawn from the seed."""
    pick = torch.randperm(out.ids.shape[0],
                          generator=gen.generator("cpu", seed, gen.SAMPLE))[:RECALL_MAX]
    got, truth = checks.neighbours(out, x, pick, k)
    return checks.recall(got, truth, k)


def forbidden_modules(names=FORBIDDEN) -> list:
    """The modules of ``names`` loaded in this process, by top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(names))


def device_info(device, count: int) -> dict:
    if device == "cpu" or not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--dev-set", action="append", default=[], metavar="KEY=JSON",
                   help="development only: override a key of the configuration, "
                        "the mix or the data (e.g. n_base=100000); never used by a cell")
    return p.parse_args(argv)


def main(argv=None, *, t_start: float = None, device: str = "cuda",
         bench_dir: Path = BENCH, root: Path = ROOT, forbidden=FORBIDDEN) -> int:
    """One run; returns the exit code. ``device="cpu"`` skips the look for
    a card and ``forbidden=()`` the look for JAX (in-process tests only)."""
    t_start = time.perf_counter() if t_start is None else t_start
    t_main = time.perf_counter()
    args = parse(argv)
    bench = load_benchmark(root)
    cell = find_cell(bench, args.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    if not (root / "src" / "repro_torch").is_dir():
        print("perfbench: no src/repro_torch in this checkout", file=sys.stderr)
        return 3
    overrides = {k: json.loads(v) for k, v in (s.split("=", 1) for s in args.dev_set)}
    e2e = cell_metrics(bench, args.workload, "end_to_end")
    layer = cell_metrics(bench, args.workload, "per_layer")
    chosen = layer if args.trace else e2e
    readers = {m["name"]: load_reader(m["name"], bench_dir) for m in chosen}

    t_setup = time.perf_counter()
    st = setup(cell, device, overrides, bench_dir=bench_dir)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    phases = {"imports": t_main - t_start, "before_setup": t_setup - t_main, **st.phases}
    win, traced, trace, recorders, taps, tracer_cost = run_window(
        st, args.seed, args.seconds,
        trace_readers=list(readers.values()) if args.trace else ())
    dev = device_info(device, cell["chips"])
    rec = Record(args.workload, st.cfg, st.mix, args.seed, args.seconds, setup_s, win,
                 trace=trace, recorders=recorders)
    wins = [win] + ([traced] if traced else [])
    out = outputs(st, wins, taps)
    theta, cb = st.idx.theta, st.idx.codebooks
    index_info = {"built": st.idx.built, "build_s": st.idx.build_s}
    # the program's state goes before the reference runs
    st.idx.engine = taps.engine = taps.inner = None
    rec.recall = window_recall(out, st.x, args.seed, st.cfg["k"])
    metrics = {}
    t_readers = time.perf_counter()
    for m in chosen:
        v = readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    recorders.clear()
    readers_s = time.perf_counter() - t_readers
    got = checks.readings(out, st.x, theta, cb, st.cfg, rec.recall)
    ok, table = checks.verdict(got, st.cfg["checks"])
    bad = forbidden_modules(forbidden)
    if bad:
        print(f"perfbench: the run imported {', '.join(bad)}", file=sys.stderr)
        return 4
    if trace is not None:
        print(f"perfbench: {len(trace.device_ops)} device and {len(trace.host_ops)} host "
              f"operations traced; profiler start {tracer_cost['start']:.2f} s, stop "
              f"{tracer_cost['stop']:.1f} s, read "
              f"{tracer_cost['read']:.1f} s; readers {readers_s:.1f} s", file=sys.stderr)
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
    result = {"correct": ok, "attempted": sum(w.attempted for w in wins),
              "failed": int(got["id_faults"]),
              "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_by_host()}
    # whether this run built the index (a checkout's first run) and how long
    # building or loading it took, inside setup_s
    result["index"] = index_info
    # where set-up's seconds went: the imports before main(), main's own
    # look for the card and the cell, then each phase of setup()
    result["setup_phases"] = phases
    print("perfbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr)
    result["checks"] = table
    for name, v in table.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
