"""ANN serving driver: load a trained RPQ checkpoint and serve queries.

    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir runs/rpq \
        --dataset sift-small [--scenario hybrid|memory|sharded|streaming] \
        [--codes u8|fs4] [--h 32] [--entries 8] [--prune-eps 0.1] \
        [--deadline-ms 20] [--degrade-level 2] [--chaos io=0.05] \
        [--churn 0.1] [--churn-rounds 4] [--refresh-every 2] \
        [--cache-mb 4] [--io-threads 4] [--shards 4] [--port-stdin] \
        [--device cpu]

Port of ``repro/launch/serve.py``; ``--device`` (default ``cuda``; without
CUDA the driver raises unless given ``--device cpu``) is the port's own.
Restores the latest checkpoint written by either package's
``launch/train.py`` (reads retried under ``--chaos io=p`` faults),
re-encodes the base from the checkpointed quantizer, builds the engine and
either runs a one-shot evaluation batch — one ``[serve] …`` line with
recall, QPS, hops, rounds, the truncated share and resident memory — or
answers newline-delimited query vectors on stdin.

Scenarios (``search/engine.py``): ``memory`` (codes + PG resident, ADC
routing only), ``hybrid`` (DiskANN-style: ADC routing + exact rerank from
"SSD" vectors; the default), ``sharded`` (the graph-free exhaustive scan
with a local rerank over ``--shards`` shards; ``--chaos dead=0`` drops
shard 0 from the merge), ``sharded-graph`` (graph-routed over ``--shards``
shards, each with its own Vamana subgraph, cached as
``<ckpt-dir>/graph_part{S}.npz`` in the reference's keys, and a local
exact rerank; ``--chaos dead=1,straggler=2,straggler_ms=50`` with
``--deadline-ms`` drills dead shards and the quorum merge) and
``streaming`` (live serving under churn through
``index.StreamingEngine``: the dataset's tail is held out as an insert
stream, ``--churn-rounds`` rounds of insert / delete / query run against the
mutable index, scored against the LIVE corpus, and a consolidation folds the
delta into the next generation, snapshotted next to the checkpoint;
``--refresh-every N`` retrains the quantizer on the live graph every N
rounds and at the final consolidation; ``--chaos crash=consolidate`` /
``corrupt`` drill a crash mid-consolidation and the restore) and ``disk``
(the all-in-storage tier, ``storage.DiskEngine``: the graph and codes are
written to a segment file under ``<ckpt-dir>/storage`` and every beam
round reads its records from it through a hot-vertex cache of
``--cache-mb`` and ``--io-threads`` reader threads; ``--chaos
slow_read=ms,corrupt_record,io=p`` adds read latency, a silently flipped
record byte and retried transient read faults; a second ``[serve] disk
io:`` line reports the cache hit rate, bytes read, reads, I/O wait and
retries).

``--shards`` (default: the visible CUDA devices) is the reference's mesh
size; on one card the shards are row blocks of the one device.

``--entries S`` / ``--prune-eps ε`` switch on adaptive routing (DESIGN.md
§11); ``--deadline-ms`` becomes a ``max_rounds`` budget through
:func:`calibrate_max_rounds`; ``--degrade-level`` applies the degradation
ladder (``search/degrade.py``) on top of the flags.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import quantizer as Q
from repro_torch.core.trainer import to_model
from repro_torch.data import load_dataset
from repro_torch.device import resolve_device, visible_cuda_devices
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.fault import ChaosPlan, InjectedFailure, corrupt_snapshot
from repro_torch.dist.retry import RetryPolicy
from repro_torch.graphs import knn_ids
from repro_torch.graphs.partition import PartitionedGraph, build_partitioned_vamana
from repro_torch.launch.train import build_or_load_graph
from repro_torch.pq import base as pqbase
from repro_torch.pq import pack
from repro_torch.search.degrade import DegradationPolicy
from repro_torch.search.engine import (HybridEngine, InMemoryEngine, ShardedEngine,
                                       ShardedGraphEngine)
from repro_torch.search.metrics import live_ground_truth, measure_qps, recall_at_k

SCENARIOS = ("hybrid", "memory", "sharded", "sharded-graph", "streaming", "disk")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_or_load_partitioned_graph(generator: torch.Generator, x: torch.Tensor,
                                    cache_path: str, n_shards: int, r: int,
                                    l: int, batch: int = 1024) -> PartitionedGraph:
    """Per-shard Vamana subgraphs over ``x`` (on x's device), read from
    ``cache_path`` when it holds a partition into ``n_shards``, else built
    and written there (the reference's ``.npz`` keys, so either package
    reads the other's file)."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        if int(z["n_shards"]) == n_shards:
            print(f"[serve] partition loaded from {cache_path}")
            return PartitionedGraph(
                neighbors=torch.from_numpy(z["neighbors"].astype(np.int32)).to(x.device),
                medoids=torch.from_numpy(z["medoids"].astype(np.int32)).to(x.device),
                n=int(z["n"]))
    t0 = time.perf_counter()
    pg = build_partitioned_vamana(x, n_shards, generator=generator, r=r, l=l,
                                  batch=batch, device=x.device)
    print(f"[serve] partition built in {time.perf_counter() - t0:.1f} s")
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez(cache_path, neighbors=pg.neighbors.cpu().numpy(),
                 medoids=pg.medoids.cpu().numpy(), n=pg.n, n_shards=n_shards)
    return pg


def calibrate_max_rounds(engine, queries: torch.Tensor, deadline_s: float,
                         **kw) -> int:
    """Turn a wall-clock deadline into a per-call round budget: run one
    warm-up batch (kernel builds, allocator), time a steady-state batch,
    and divide the observed per-round latency into the deadline (DESIGN.md
    §13)."""
    engine.search(queries, **kw)
    _sync(queries.device)
    t0 = time.perf_counter()
    res = engine.search(queries, **kw)
    _sync(queries.device)
    elapsed = time.perf_counter() - t0
    rounds = max(float(res.rounds.max()), 1.0)
    return max(1, int(deadline_s / (elapsed / rounds)))


def restore_model(ckpt_dir: str, dataset: str, device,
                  retry: Optional[RetryPolicy] = None):
    """The latest checkpoint's quantizer and the dataset it was trained on:
    (step, dataset, QuantizerModel, (m, k))."""
    state = ckpt.restore(ckpt_dir, retry=retry, device=device)
    extra = state.get("extra") or {}
    ds = load_dataset(extra.get("dataset", dataset), device=device)
    m, k = extra.get("m", 8), extra.get("k", 64)
    flat = state["params"]
    params = Q.RPQParams(theta=flat["theta"], codebooks=flat["codebooks"],
                         log_alpha=flat["log_alpha"])
    return state["step"], ds, to_model(Q.RPQConfig(dim=ds.dim, m=m, k=k), params), (m, k)


def build_engine(args, ds, model, plan: Optional[ChaosPlan] = None,
                 retry: Optional[RetryPolicy] = None):
    """The scenario's engine over the base set, in the ``--codes`` layout."""
    codes = pqbase.encode(model, ds.base)
    if args.codes == "fs4":
        # fast-scan layout (DESIGN.md §8): every engine dispatches on the
        # QuantizedLUT that build_lut(quantize=True) returns
        codes = pack.pack_codes(codes)
        lut_fn = lambda q: pqbase.build_lut(model, q, quantize=True)
        print(f"[serve] fast-scan fs4 layout: {codes.shape[1]} packed "
              f"bytes/vector, uint8 LUTs")
    else:
        lut_fn = lambda q: pqbase.build_lut(model, q)
    dev = ds.base.device
    shards = args.shards or visible_cuda_devices()
    if args.scenario == "sharded":  # graph-free scatter-gather scan
        engine = ShardedEngine(codes, lut_fn, vectors=ds.base, device=dev,
                               n_shards=shards)
        print(f"[serve] sharded over {engine.n_shards} shard(s)")
        return engine
    if args.scenario == "sharded-graph":  # graph-routed scatter-gather
        pg = build_or_load_partitioned_graph(
            torch.Generator().manual_seed(0), ds.base,
            f"{args.ckpt_dir}/graph_part{shards}.npz", shards, args.graph_r,
            args.graph_l, args.graph_batch)
        engine = ShardedGraphEngine(pg, codes, lut_fn, vectors=ds.base,
                                    device=dev, n_shards=shards)
        print(f"[serve] graph-routed over {engine.n_shards} shard(s), "
              f"{pg.n_local} rows/shard, R={pg.degree}")
        return engine
    graph = build_or_load_graph(torch.Generator().manual_seed(0), ds.base,
                                f"{args.ckpt_dir}/graph_base.npz",
                                args.graph_r, args.graph_l, args.graph_batch)
    if args.scenario == "disk":
        return build_disk_engine(args, ds, model, graph, codes, lut_fn, plan, retry)
    if args.scenario == "hybrid":
        return HybridEngine(graph, codes, lut_fn, vectors=ds.base, device=dev)
    return InMemoryEngine(graph, codes, lut_fn, device=dev)


def build_disk_engine(args, ds, model, graph, codes, lut_fn,
                      plan: Optional[ChaosPlan], retry: Optional[RetryPolicy]):
    """The all-in-storage tier (DESIGN.md §14): write the base as generation
    0 of a segment file under ``<ckpt-dir>/storage`` (vector-free, with the
    quantizer sidecar), apply the chaos plan's storage tokens, and open a
    ``DiskEngine`` on it."""
    from repro_torch.index.segment import BaseSegment
    from repro_torch.storage import DiskEngine, write_segment
    from repro_torch.storage import format as segfmt

    storage_dir = f"{args.ckpt_dir}/storage"
    seg = BaseSegment(graph=graph, codes=codes, vectors=None, layout=args.codes,
                      generation=0, dim_hint=ds.dim)
    seg_path = write_segment(storage_dir, seg, model=model)
    fault_hook, slow_ms = None, 0.0
    if plan is not None:
        slow_ms = plan.slow_read_ms
        if plan.io_fault_p > 0:
            fault_hook = plan.io_fault()
            retry = retry or RetryPolicy()
            print(f"[serve] chaos: transient read fault p={plan.io_fault_p} "
                  f"injected on segment reads")
        if plan.corrupt_record:
            vid = segfmt.corrupt_record(seg_path, seed=plan.seed)
            print(f"[serve] chaos: silently corrupted record {vid} in {seg_path}")
    engine = DiskEngine.open(
        storage_dir, lut_fn=lut_fn, cache_mb=args.cache_mb,
        io_threads=args.io_threads, retry=retry, fault_hook=fault_hook,
        slow_read_ms=slow_ms, device=ds.base.device,
        on_fallback=lambda g, e: print(
            f"[serve] disk: generation {g} failed header verification "
            f"({e}) — falling back"))
    print(f"[serve] disk: gen {engine.generation} segment "
          f"{os.path.getsize(engine.path)/1e6:.1f}MB on storage, "
          f"cache {len(engine.cache)}/{engine.cache.capacity} records "
          f"({args.cache_mb}MB budget), {args.io_threads} io threads")
    return engine


def run_streaming(args, model, ds, plan: Optional[ChaosPlan] = None) -> dict:
    """The churn loop: hold out the dataset tail as an insert stream, then
    interleave insert / delete / query batches through a StreamingEngine
    and consolidate at the end. Returns the engine and each evaluation's
    line values."""
    from repro_torch.index import BaseSegment, StreamingEngine
    from repro_torch.index.segment import encode_codes

    dev = ds.base.device
    n = int(ds.base.shape[0])
    n0 = n - int(n * args.churn)
    base_x, stream = ds.base[:n0], ds.base[n0:]
    graph = build_or_load_graph(torch.Generator().manual_seed(0), base_x,
                                f"{args.ckpt_dir}/graph_stream{n0}.npz",
                                args.graph_r, args.graph_l, args.graph_batch)
    seg = BaseSegment(graph=graph, codes=encode_codes(model, base_x, args.codes),
                      vectors=base_x, layout=args.codes)
    cap = max(len(stream), 1)
    engine = StreamingEngine(seg, model, delta_capacity=cap, device=dev)
    print(f"[serve] streaming: base {n0} rows (gen 0), insert stream "
          f"{len(stream)}, delta capacity {cap}, layout {args.codes}")

    rng = np.random.default_rng(0)
    # gid → vector row for the live-corpus ground truth, written at insert
    # time (consolidation renumbers gids)
    all_x = torch.zeros((n0 + cap, base_x.shape[1]), device=dev)
    all_x[:n0] = base_x
    live = np.zeros(n0 + cap, bool)
    live[:n0] = True
    policy = DegradationPolicy()
    budget = {"max_rounds": None}
    evals = {}

    def evaluate(tag: str) -> None:
        if args.deadline_ms and budget["max_rounds"] is None:
            budget["max_rounds"] = calibrate_max_rounds(
                engine, ds.queries, args.deadline_ms / 1e3, k=args.k, h=args.h)
            print(f"[serve] deadline {args.deadline_ms}ms → "
                  f"max_rounds={budget['max_rounds']}")
        skw = policy.apply(engine, args.degrade_level, h=args.h,
                           expand=args.expand, entries=args.entries,
                           prune_eps=args.prune_eps,
                           max_rounds=budget["max_rounds"])
        gt_g = live_ground_truth(all_x, np.flatnonzero(live), ds.queries, args.k)
        qps, res = measure_qps(lambda q: engine.search(q, k=args.k, **skw),
                               ds.queries)
        rec = recall_at_k(res.ids, gt_g, args.k)
        trunc = f" truncated={float(res.truncated.float().mean()):.2f}"
        print(f"[serve] streaming/{tag}: recall@{args.k}={rec:.4f} "
              f"qps={qps:.1f} live={engine.n_live} gen={engine.generation} "
              f"resident={engine.memory_bytes()/1e6:.1f}MB{trunc}")
        evals[tag] = {"recall": rec, "qps": qps, "live": engine.n_live,
                      "generation": engine.generation}

    snap_dir = f"{args.ckpt_dir}/streaming_index"

    def consolidate_now(refresh, chaos=None) -> dict:
        nonlocal live, all_x
        stats = engine.consolidate(ckpt_dir=snap_dir, keep=3, refresh=refresh,
                                   chaos=chaos)
        # consolidation renumbers: translate the live-corpus bookkeeping
        old_live = np.flatnonzero(live)
        live = np.zeros(stats["n"] + cap, bool)
        live[stats["old2new"][old_live]] = True
        all_x = torch.cat([engine.base.vectors,
                           torch.zeros((cap, base_x.shape[1]), device=dev)])
        extra = ""
        if stats["refreshed"]:
            rep = stats["refresh"]
            extra = (f", codebooks refreshed (live distortion "
                     f"{rep['distortion_before']:.3f} → "
                     f"{rep['distortion_after']:.3f})")
        print(f"[serve] consolidated → generation {stats['generation']}: "
              f"{stats['n']} rows ({stats['dropped']} dropped, "
              f"{stats['folded']} folded in){extra}, snapshot at {snap_dir}")
        return stats

    rounds = max(args.churn_rounds, 1)
    per = -(-max(len(stream), 1) // rounds)
    for i in range(rounds):
        batch = stream[i * per:(i + 1) * per]
        if len(batch):
            gids = engine.insert(batch)
            all_x[torch.from_numpy(gids).to(dev)] = batch
            live[gids] = True
        live_base = np.flatnonzero(live[:engine.base.n])
        dead = rng.choice(live_base, min(len(batch), len(live_base)),
                          replace=False)
        engine.delete(dead)
        live[dead] = False
        evaluate(f"round{i}")
        # mid-stream refreshed consolidations close the learning loop while
        # the stream keeps flowing; the final consolidation covers the tail
        if (args.refresh_every and (i + 1) % args.refresh_every == 0
                and i + 1 < rounds):
            consolidate_now(refresh=True)
            evaluate(f"refreshed{i}")
    if plan is not None and plan.crash_phase is not None:
        # chaos drill: crash mid-consolidation, then show a restart lands on
        # an intact generation — with the newest snapshot corrupted on top
        # when the plan says so. Establish durable intact generations first
        # (two when corruption will eat the newest).
        consolidate_now(refresh=False)
        if plan.corrupt_latest_snapshot:
            consolidate_now(refresh=False)
        try:
            consolidate_now(refresh=bool(args.refresh_every),
                            chaos=plan.consolidate_hook())
        except InjectedFailure as e:
            print(f"[serve] chaos: injected crash during consolidation "
                  f"({e}); restarting from {snap_dir}")
        if plan.corrupt_latest_snapshot:
            step = corrupt_snapshot(snap_dir, seed=plan.seed)
            print(f"[serve] chaos: corrupted snapshot generation {step}")
        engine = StreamingEngine.restore(
            snap_dir, delta_capacity=cap, retry=RetryPolicy(), device=dev,
            on_fallback=lambda g, e: print(
                f"[serve] chaos: generation {g} failed verification "
                f"({type(e).__name__}) — falling back"))
        live = np.zeros(engine.base.n + cap, bool)
        live[:engine.base.n] = True
        all_x = torch.cat([engine.base.vectors,
                           torch.zeros((cap, base_x.shape[1]), device=dev)])
        print(f"[serve] chaos: restored generation {engine.generation} "
              f"({engine.n_live} live rows)")
        evaluate("restored")
        return {"engine": engine, "evals": evals}
    consolidate_now(refresh=bool(args.refresh_every))
    evaluate("consolidated")
    return {"engine": engine, "evals": evals}


def serve_stdin(args, engine, dim: int, device) -> None:
    """The toy request loop: one query of ``dim`` floats per line; a line
    that does not parse prints ``!! expected …`` and the loop goes on."""
    print(f"[serve] reading {dim}-d queries from stdin (one per line; EOF to stop)")
    for line in sys.stdin:
        try:
            vals = np.fromiter(line.split(), dtype=np.float32)
        except ValueError:
            print(f"!! expected {dim} floats, got unparseable input")
            continue
        if vals.size != dim:
            print(f"!! expected {dim} floats, got {vals.size}")
            continue
        t0 = time.perf_counter()
        res = engine.search(torch.from_numpy(vals)[None].to(device), k=args.k,
                            h=args.h, expand=args.expand, entries=args.entries,
                            prune_eps=args.prune_eps)
        ids = res.ids[0].cpu().numpy().tolist()
        dists = res.dists[0].cpu().numpy().round(3).tolist()
        dt = (time.perf_counter() - t0) * 1e3
        print(f"ids={ids} dists={dists} ({dt:.1f} ms, {int(res.hops[0])} hops)")


def run(args) -> dict:
    """The one-shot evaluation (or the stdin loop). Returns the engine, its
    search kwargs and the timed result."""
    dev = resolve_device(args.device)
    plan = ChaosPlan.parse(args.chaos) if args.chaos else None
    retry = None
    if plan is not None and plan.io_fault_p > 0:
        # every checkpoint read in this process now fails transiently with
        # probability io_fault_p — and retries through the backoff policy
        ckpt.set_io_fault_hook(plan.io_fault())
        retry = RetryPolicy()
        print(f"[serve] chaos: transient I/O fault p={plan.io_fault_p} "
              f"injected on checkpoint reads (retry up to "
              f"{retry.max_attempts} attempts)")

    step, ds, model, (m, k) = restore_model(args.ckpt_dir, args.dataset, dev, retry)
    print(f"[serve] restored step {step} quantizer (M={m}, K={k}) from {args.ckpt_dir}")
    if args.codes == "fs4" and k > 16:
        raise SystemExit(
            f"--codes fs4 needs 4-bit sub-codes (K <= 16); this checkpoint "
            f"was trained with K={k}. Re-train with --k 16 (double M to keep "
            f"the byte budget).")
    if args.scenario == "streaming":  # live mutable index under churn
        if args.port_stdin:
            raise SystemExit(
                "--port-stdin is not available with --scenario streaming: "
                "the scenario runs a fixed churn loop, not a query port")
        return run_streaming(args, model, ds, plan)
    engine = build_engine(args, ds, model, plan, retry)
    if args.port_stdin:
        serve_stdin(args, engine, ds.dim, dev)
        return {"engine": engine}

    policy = DegradationPolicy()
    skw = policy.apply(engine, args.degrade_level, h=args.h, expand=args.expand,
                       entries=args.entries, prune_eps=args.prune_eps)
    if args.deadline_ms and not isinstance(engine, ShardedEngine):
        # the graph-free scan has no rounds to budget
        mr = calibrate_max_rounds(engine, ds.queries, args.deadline_ms / 1e3,
                                  k=args.k, **skw)
        skw["max_rounds"] = mr
        print(f"[serve] deadline {args.deadline_ms}ms → max_rounds={mr}")
    if plan is not None and isinstance(engine, (ShardedEngine,
                                                ShardedGraphEngine)):
        skw["alive"] = list(plan.alive(engine.n_shards))
        dead = engine.n_shards - sum(skw["alive"])
        msg = f"[serve] chaos: {dead}/{engine.n_shards} shard(s) dead"
        if isinstance(engine, ShardedGraphEngine):
            skw["shard_latency_s"] = list(plan.latencies(engine.n_shards))
            if args.deadline_ms:
                skw["deadline_s"] = args.deadline_ms / 1e3
                msg += (f", stragglers {list(plan.straggler_shards)} at "
                        f"{plan.straggler_latency_s*1e3:.0f}ms vs "
                        f"{args.deadline_ms}ms deadline quorum")
        print(msg)

    gt, _ = knn_ids(ds.base, ds.queries, args.k)
    qps, res = measure_qps(lambda q: engine.search(q, k=args.k, **skw), ds.queries)
    rec = recall_at_k(res.ids, gt, args.k)
    degr = "DEGRADED " if res.degraded else ""
    print(f"[serve] {args.scenario}: recall@{args.k}={rec:.4f} qps={qps:.1f} "
          f"hops={float(res.hops.float().mean()):.1f} "
          f"rounds={float(res.rounds.float().mean()):.1f} "
          f"truncated={float(res.truncated.float().mean()):.2f} {degr}"
          f"resident={engine.memory_bytes()/1e6:.1f}MB")
    if args.scenario == "disk":
        io = engine.last_io
        print(f"[serve] disk io: cache_hit_rate={io['cache_hit_rate']:.3f} "
              f"bytes_read={io['bytes_read']} n_reads={io['n_reads']} "
              f"io_wait={io['io_wait_s']*1e3:.1f}ms retries={io['n_retries']}")
    return {"engine": engine, "search_kwargs": skw, "result": res, "recall": rec,
            "qps": qps}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--dataset", default="sift-small")
    ap.add_argument("--scenario", choices=SCENARIOS, default="hybrid")
    ap.add_argument("--codes", choices=("u8", "fs4"), default="u8",
                    help="serving layout: u8 = 1 byte/sub-code + f32 LUTs; "
                    "fs4 = fast-scan 4-bit packed codes + quantized uint8 "
                    "LUTs (requires a checkpoint trained with K <= 16)")
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--expand", type=int, default=1,
                    help="frontier batch size E (DESIGN.md §9): nodes "
                    "expanded per beam round (the sharded scan ignores it)")
    ap.add_argument("--entries", type=int, default=1,
                    help="adaptive routing (DESIGN.md §11): seed each beam "
                    "with S entry points from the PQ-hash coarse index; 1 = "
                    "classic routing from the medoid (bit-identical)")
    ap.add_argument("--prune-eps", type=float, default=0.0,
                    help="adaptive routing (DESIGN.md §11): hop-pruning "
                    "margin ε; 0 = off (bit-identical)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--graph-r", type=int, default=24)
    ap.add_argument("--graph-l", type=int, default=48)
    ap.add_argument("--graph-batch", type=int, default=1024,
                    help="nodes per batched Vamana insert round of a graph built "
                    "here (the reference builder's 1024)")
    ap.add_argument("--churn", type=float, default=0.1,
                    help="streaming scenario: fraction of the dataset held "
                    "out as the insert stream (an equal count of base rows "
                    "is deleted over the churn rounds)")
    ap.add_argument("--churn-rounds", type=int, default=4,
                    help="streaming scenario: interleaved insert/delete/"
                    "query rounds before consolidation")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="streaming scenario: a codebook-REFRESHED "
                    "consolidation every N churn rounds (the quantizer "
                    "retrains on the live graph; the final consolidation "
                    "refreshes too); 0 = codebooks frozen across generations")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-batch serving deadline (DESIGN.md §13): a "
                    "warm-up batch calibrates the per-round latency and the "
                    "beam gets the max_rounds budget that fits; 0 = none")
    ap.add_argument("--degrade-level", type=int, default=0,
                    help="degradation ladder rung (DESIGN.md §13): 0 = full "
                    "config; L1 expand, L2 entries, L3 aggressive prune, L4 "
                    "rerank, L5 the streaming delta scan")
    ap.add_argument("--chaos", default="",
                    help="fault-injection plan (DESIGN.md §13), e.g. "
                    "'io=0.05,dead=0,corrupt,crash=consolidate,seed=7': "
                    "transient checkpoint-read faults (retried), dead shards "
                    "dropped from the merge, a corrupted newest snapshot and "
                    "a crash mid-consolidation (streaming); disk: "
                    "'slow_read=ms,corrupt_record' (modeled read latency, a "
                    "silently flipped record byte)")
    ap.add_argument("--cache-mb", type=float, default=4.0,
                    help="disk scenario: DRAM budget of the hot-vertex cache "
                    "(half BFS-pinned from the medoid, half LRU)")
    ap.add_argument("--io-threads", type=int, default=4,
                    help="disk scenario: segment reader threads")
    ap.add_argument("--shards", type=int, default=0,
                    help="sharded scenarios: shard count, the reference's "
                    "mesh size (default 0: the visible CUDA devices); on one "
                    "card the shards are row blocks of the one device")
    ap.add_argument("--port-stdin", action="store_true",
                    help="read whitespace-separated query vectors on stdin")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without CUDA pass --device cpu")
    return ap


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
