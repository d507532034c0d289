#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # full width: 1M x 128, M=16, K=256
    python3 chip_smoke.py --scale 1       # the sift spec's registered 100k base
    python3 chip_smoke.py --vamana-batch 1024   # the JAX builder's batch

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: the card's ``nvidia-smi`` name and power limit, torch's name;
2. build: the three CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source, all at once;
3. parity: each kernel against its plain PyTorch version on CUDA tensors, at
   the main path's shapes and at edge shapes, then CUDA-event times of the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (``hop_adc``, shorter than its Python launch, is
   timed by replaying a captured CUDA graph of many launches);
4. small reference: the unit-test dataset served on the card and on the CPU
   (the plain versions) from the same graph and quantizer must agree;
5. main path at full width: ``load_dataset("sift", scale=10)``, ``knn_ids``
   ground truth, ``train_pq(M=16, K=256)``, ``build_vamana(r=64, l=128)``,
   the graph's own recall@10 under exact-distance routing, ``encode``,
   ``InMemoryEngine`` / ``HybridEngine`` search (k=10, h=32) and the
   exhaustive ADC of ``pq.base.adc``, with every kernel's launch count read
   around this phase alone.

The last three lines are the kernels JSON, the ``nvidia-smi`` line, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or run outside the repository, it exits non-zero and prints no
result. It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores; bound_ms is the larger of bytes / HBM and ops / F32.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
# Nodes per batched Vamana insert round on the main path (the JAX default is
# 1024): 8x fewer sequential beam rounds at 1M. The graph's exact-routed
# recall, checked below, shows what the staler batch costs.
VAMANA_BATCH = 8192
# Least recall@10 of the graph under exact-distance routing at h=32 (see
# main_path). An H100 read 0.7298 at 1M (batch 8192; 0.7193 at batch 1024)
# and 0.9996 at 100k; a graph that routes nowhere scores near 0.
MIN_EXACT_RECALL = 0.65


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, *, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` untimed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, *, iters: int, replays: int = 5) -> float:
    """Mean device time of one ``fn()`` replayed from a captured CUDA graph
    of ``iters`` calls: the host issues one graph launch per replay, so a
    kernel shorter than its Python launch is timed by the device."""
    import torch

    fn()  # first call outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, want, *, rtol: float, atol: float) -> float:
    """Max abs error of ``got`` vs ``want``; fails beyond atol + rtol·|want|."""
    import torch

    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got - want).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want.abs().clamp(min=1e-30)).max()) if err.numel() else 0.0
    ok = bool((err <= atol + rtol * want.abs()).all())
    log(f"[parity] {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
        f"tol=atol {atol:g} + rtol {rtol:g}*|ref| -> {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return max_abs


# --------------------------------------------------------------------------
# phase 3: kernels vs plain versions, and their times
# --------------------------------------------------------------------------

def parity_and_timing(n_base: int, n_query: int) -> dict:
    import torch

    from repro_torch.kernels import adc_scan as kadc
    from repro_torch.kernels import hop_adc as khop
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_pairwise as kpqp
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    m, k, dsub = 16, 256, 8
    errs = {"pq_pairwise": 0.0, "hop_adc": 0.0, "adc_scan_batch": 0.0}

    def note(kernel, e):
        errs[kernel] = max(errs[kernel], e)

    def rand_codes(n, mm, kk=k):
        return torch.randint(0, kk, (n, mm), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    def rand_luts(q, mm, kk=k):  # non-negative, like squared distances
        return torch.rand((q, mm, kk), generator=g, device=dev) * 20.0

    # pq_pairwise: encode chunk, LUT build, k-means block; ragged N, M=8,
    # a dsub without a compile-time specialization, K=16
    for n, mm, kk, ds in ((65536, m, k, dsub), (n_query, m, k, dsub),
                          (8192, m, k, dsub), (1001, m, k, dsub),
                          (777, 8, k, 16), (333, 16, 256, 5), (129, 4, 16, 4)):
        x = torch.randn((n, mm, ds), generator=g, device=dev) * 3.0
        cb = torch.randn((mm, kk, ds), generator=g, device=dev) * 3.0
        note("pq_pairwise", compare(f"pq_pairwise N={n} M={mm} K={kk} dsub={ds}",
                                    ops.pq_pairwise(x, cb),
                                    ref.pq_pairwise_ref(x, cb),
                                    rtol=1e-5, atol=1e-4))

    # hop_adc over the sentinel-padded full-width corpus: R'=64 (one beam
    # round), the entry call R'=1, ragged 200 and 256, duplicates and the
    # sentinel, m_prefix=4 of 16, M=8
    codes_p = ops.pad_sentinel_row(rand_codes(n_base, m))
    cases = []
    for r, mp in ((64, 0), (1, 0), (200, 0), (256, 0), (64, 4)):
        ids = torch.randint(0, n_base + 1, (n_query, r), generator=g,
                            device=dev, dtype=torch.int32)
        if r >= 8:
            ids[:, : r // 4] = ids[:, r // 4: 2 * (r // 4)]   # duplicates
            ids[:, -1] = n_base                               # sentinel row
            ids[0, 0] = 0
        cases.append((codes_p, ids, rand_luts(n_query, m), mp))
    codes8 = ops.pad_sentinel_row(rand_codes(5003, 8))
    cases.append((codes8, torch.randint(0, 5004, (37, 72), generator=g, device=dev,
                                        dtype=torch.int32), rand_luts(37, 8), 0))
    for codes, ids, luts, mp in cases:
        want = (ref.hop_adc_ref(codes[:, :mp], ids, luts[:, :mp]) if mp
                else ref.hop_adc_ref(codes, ids, luts))
        note("hop_adc", compare(f"hop_adc N+1={codes.shape[0]} M={codes.shape[1]} "
                                f"Q={ids.shape[0]} R'={ids.shape[1]} m_prefix={mp}",
                                ops.hop_adc(codes, ids, luts, m_prefix=mp), want,
                                rtol=1e-6, atol=1e-6))

    # adc_scan_batch: the main path's 1000 x N_base; ragged N, M=8, a query
    # count that is not a multiple of the tile
    codes_full = codes_p[:n_base]
    luts_full = rand_luts(n_query, m)
    for codes, luts in ((codes_full, luts_full), (rand_codes(4099, m), rand_luts(7, m)),
                        (rand_codes(10007, 8), rand_luts(13, 8))):
        note("adc_scan_batch", compare(
            f"adc_scan_batch N={codes.shape[0]} M={codes.shape[1]} Q={luts.shape[0]}",
            ops.adc_scan_batch(codes, luts), ref.adc_scan_batch_ref(codes, luts),
            rtol=1e-6, atol=1e-6))

    # ---- times at the main path's shapes (kernel: the bare launch) ----
    rows = []
    x = torch.randn((65536, m, dsub), generator=g, device=dev) * 3.0
    cb = torch.randn((m, k, dsub), generator=g, device=dev) * 3.0
    out = torch.empty((65536, m, k), device=dev)
    xt = x.transpose(0, 1).contiguous()
    n_, = x.shape[:1]
    b_ms, b_by = bound(4 * (x.numel() + cb.numel() + out.numel()),
                       out.numel() * (2 * dsub + 3) + 2 * dsub * (n_ * m + m * k))
    rows.append(dict(
        name="pq_pairwise", route="cuda",
        source="src/repro_torch/kernels/csrc/pq_pairwise.cu",
        replaces="src/repro/kernels/pq_pairwise.py:48",
        shape=f"({n_},{m},{dsub})x({m},{k},{dsub}) encode chunk",
        max_abs_err=errs["pq_pairwise"],
        ms=cuda_ms(lambda: kpqp.launch(x, cb, out), iters=50),
        plain_ms=cuda_ms(lambda: ref.pq_pairwise_ref(x, cb), iters=20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.cdist(xt, cb).square_(), iters=20),
        library_call="torch.cdist(x (M,N,dsub), codebooks).square_()"))

    ids = cases[0][1]
    luts = cases[0][2]
    hout = torch.empty(ids.shape, device=dev)
    distinct = int(torch.unique(ids).numel())
    b_ms, b_by = bound(4 * ids.numel() + distinct * m + 4 * luts.numel() + 4 * ids.numel(),
                       ids.numel() * m)
    rows.append(dict(
        name="hop_adc", route="cuda", source="src/repro_torch/kernels/csrc/hop_adc.cu",
        replaces="src/repro/kernels/hop_adc.py:170",
        shape=f"codes ({n_base + 1},{m}) u8, ids ({n_query},64), luts ({n_query},{m},{k}) "
              "one beam round",
        max_abs_err=errs["hop_adc"],
        ms=graph_ms(lambda: khop.launch(codes_p, ids, luts, m, hout), iters=200),
        plain_ms=graph_ms(lambda: ref.hop_adc_ref(codes_p, ids, luts), iters=50),
        issue_ms=cuda_ms(lambda: khop.launch(codes_p, ids, luts, m, hout), iters=200),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=None))

    aout = torch.empty((n_query, n_base), device=dev)
    b_ms, b_by = bound(codes_full.numel() + 4 * luts_full.numel() + 4 * aout.numel(),
                       aout.numel() * m)
    rows.append(dict(
        name="adc_scan_batch", route="cuda", source="src/repro_torch/kernels/csrc/adc_scan.cu",
        replaces="src/repro/kernels/adc_scan.py:131",
        shape=f"codes ({n_base},{m}) u8 x luts ({n_query},{m},{k})",
        max_abs_err=errs["adc_scan_batch"],
        ms=cuda_ms(lambda: kadc.launch(codes_full, luts_full, aout), iters=5),
        plain_ms=cuda_ms(lambda: ref.adc_scan_batch_ref(codes_full, luts_full),
                         iters=2, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=None))
    for row in rows:
        issue = (f" (back-to-back launches from the host: {row['issue_ms']:.4f} ms)"
                 if "issue_ms" in row else "")
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms{issue}, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return {row["name"]: row for row in rows}


# --------------------------------------------------------------------------
# phase 4: the slice on a small input, card vs CPU
# --------------------------------------------------------------------------

def small_reference() -> None:
    import torch

    from repro_torch.data import load_dataset
    from repro_torch.graphs import build_vamana, knn_ids
    from repro_torch.pq import base, train_pq
    from repro_torch.search.engine import InMemoryEngine
    from repro_torch.search.metrics import recall_at_k

    gen = lambda s: torch.Generator().manual_seed(s)
    cpu = load_dataset("unit-test", device="cpu")
    gt, _ = knn_ids(cpu.base, cpu.queries, 10)
    g_cpu = build_vamana(cpu.base, generator=gen(0), r=16, l=32, device="cpu")
    g_gpu = build_vamana(cpu.base, generator=gen(0), r=16, l=32, device="cuda")
    same_rows = float(torch.mean(torch.tensor(
        [set(a.tolist()) == set(b.tolist())
         for a, b in zip(g_cpu.neighbors, g_gpu.neighbors.cpu())], dtype=torch.float32)))
    m_cpu = train_pq(cpu.train, 8, 32, generator=gen(1), iters=8, device="cpu")
    m_gpu = m_cpu.to("cuda")
    codes_cpu = base.encode(m_cpu, cpu.base)
    codes_gpu = base.encode(m_gpu, cpu.base.cuda())
    same_codes = float((codes_cpu == codes_gpu.cpu()).all(dim=1).float().mean())
    res_cpu = InMemoryEngine(g_cpu, codes_cpu, lambda q: base.build_lut(m_cpu, q),
                             device="cpu").search(cpu.queries, k=10, h=32)
    res_gpu = InMemoryEngine(g_cpu, codes_cpu, lambda q: base.build_lut(m_gpu, q),
                             device="cuda").search(cpu.queries, k=10, h=32)
    same_top = float((res_cpu.ids == res_gpu.ids.cpu()).all(dim=1).float().mean())
    rec_cpu, rec_gpu = recall_at_k(res_cpu.ids, gt, 10), recall_at_k(res_gpu.ids, gt, 10)
    log(f"[small] unit-test 2000x32: graph rows identical card vs CPU {same_rows:.4f}; "
        f"codes rows identical {same_codes:.4f}; top-10 identical {same_top:.4f}; "
        f"recall@10 card {rec_gpu:.4f} CPU {rec_cpu:.4f}")
    check(same_codes >= 0.999, "encode on the card disagrees with the CPU")
    check(same_top >= 0.99, "search on the card disagrees with the CPU")
    check(same_rows >= 0.95, "Vamana build on the card disagrees with the CPU")
    check(abs(rec_cpu - rec_gpu) <= 0.01, "recall on the card disagrees with the CPU")


# --------------------------------------------------------------------------
# phase 5: the main path at full width
# --------------------------------------------------------------------------

def device_busy(fn, wall_s: float) -> dict:
    """Device time of one traced ``fn()`` by kernel name (torch.profiler),
    and its share of ``wall_s``, the untraced wall time of the same call.
    Kernels run on one stream, so their summed time is the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            per_kernel[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    device_ms = sum(ms for ms, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    if device_ms == 0:
        log("[trace] search: the profiler saw no device time (not measured)")
        return {"device_ms": None, "wall_ms": wall_s * 1e3, "busy_share": None}
    log(f"[trace] one InMemoryEngine search: device busy {device_ms:.2f} ms of "
        f"{wall_s * 1e3:.2f} ms untraced wall ({device_ms / (wall_s * 1e3):.3f}); "
        f"{sum(n for _, n in per_kernel.values())} kernels")
    for name, (ms, n) in top:
        log(f"[trace]   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    return {"device_ms": device_ms, "wall_ms": wall_s * 1e3,
            "busy_share": device_ms / (wall_s * 1e3),
            "top": [(name[:90], ms, n) for name, (ms, n) in top]}


def main_path(args) -> dict:
    import torch

    from repro_torch.data import load_dataset
    from repro_torch.graphs import build_vamana, knn_ids
    from repro_torch.kernels import ops, ref
    from repro_torch.pq import base, train_pq
    from repro_torch.search import beam
    from repro_torch.search.engine import HybridEngine, InMemoryEngine
    from repro_torch.search.metrics import measure_qps, recall_at_k

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[main] {label}: {secs:.2f} s")
        times[label] = secs
        return out

    times: dict[str, float] = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ds = timed("load_dataset", lambda: load_dataset("sift", scale=args.scale))
    log(f"[main] sift scale={args.scale}: base {tuple(ds.base.shape)}, queries "
        f"{tuple(ds.queries.shape)}, train {tuple(ds.train.shape)}")
    gt, _ = timed("knn_ids", lambda: knn_ids(ds.base, ds.queries, 10, block=256))
    model = timed("train_pq", lambda: train_pq(
        ds.train, 16, 256, generator=torch.Generator().manual_seed(1), iters=20))
    graph = timed("build_vamana", lambda: build_vamana(
        ds.base, generator=torch.Generator().manual_seed(0), r=64, l=128,
        batch=args.vamana_batch))
    # the graph alone: exact-distance routing, which the quantizer cannot cap
    exact_fn = beam.make_exact_dist_fn(ops.pad_sentinel_row(ds.base))
    graph_rec = {}
    for h in (32, 128):
        res_x = beam.beam_search(graph.neighbors, graph.medoid, ds.queries, exact_fn,
                                 h=h, max_steps=512)
        graph_rec[h] = recall_at_k(res_x.ids[:, :10], gt, 10)
    del exact_fn, res_x
    log(f"[main] graph recall@10 under exact routing (batch {args.vamana_batch}): "
        f"h=32 {graph_rec[32]:.4f}, h=128 {graph_rec[128]:.4f}")
    codes = timed("encode", lambda: base.encode(model, ds.base))
    lut_fn = lambda q: base.build_lut(model, q)
    mem = InMemoryEngine(graph, codes, lut_fn)
    hyb = HybridEngine(graph, codes, lut_fn, vectors=ds.base)
    res_m = timed("search_inmemory", lambda: mem.search(ds.queries, k=10, h=32))
    res_h = timed("search_hybrid", lambda: hyb.search(ds.queries, k=10, h=32))
    qps_m, _ = measure_qps(lambda q: mem.search(q, k=10, h=32), ds.queries)
    qps_h, _ = measure_qps(lambda q: hyb.search(q, k=10, h=32), ds.queries)
    adc = timed("exhaustive_adc", lambda: base.adc(model, codes, ds.queries))
    busy = device_busy(lambda: mem.search(ds.queries, k=10, h=32),
                       ds.queries.shape[0] / qps_m)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    adc_top = torch.topk(adc, 10, dim=1, largest=False).indices
    del adc
    rec = {"inmemory": recall_at_k(res_m.ids, gt, 10),
           "hybrid": recall_at_k(res_h.ids, gt, 10),
           "exhaustive_adc": recall_at_k(adc_top, gt, 10)}
    deg = (graph.neighbors < graph.n).sum(dim=1).float().mean().item()
    stats = {name: {"hops": float(r.hops.float().mean()),
                    "n_dist": float(r.n_dist.float().mean()),
                    "rounds": float(r.rounds.float().mean())}
             for name, r in (("inmemory", res_m), ("hybrid", res_h))}
    log(f"[main] recall@10 inmemory {rec['inmemory']:.4f} hybrid {rec['hybrid']:.4f} "
        f"exhaustive_adc {rec['exhaustive_adc']:.4f}")
    log(f"[main] inmemory hops {stats['inmemory']['hops']:.2f} n_dist "
        f"{stats['inmemory']['n_dist']:.2f} rounds {stats['inmemory']['rounds']:.2f}; "
        f"graph mean degree {deg:.2f}")
    log(f"[main] QPS (batch of {ds.queries.shape[0]}, h=32): inmemory {qps_m:.1f} "
        f"hybrid {qps_h:.1f}; peak device memory {peak_gb:.2f} GiB")
    log(f"[main] launches: {counts}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    for name, v in rec.items():
        check(math.isfinite(v), f"recall {name} is not finite")
    check(res_m.ids.shape == (ds.queries.shape[0], 10), "InMemoryEngine result shape")
    check(bool(torch.isfinite(res_m.dists).all()), "InMemoryEngine distances not finite")
    check(rec["hybrid"] >= rec["inmemory"] - 0.02, "HybridEngine recall below InMemoryEngine")
    check(graph_rec[32] >= MIN_EXACT_RECALL,
          f"the Vamana graph routes badly: exact recall@10 {graph_rec[32]:.4f} "
          f"< {MIN_EXACT_RECALL}")

    # the same search routed by the plain hop_adc version, on the card
    codes_p = ops.pad_sentinel_row(codes)
    plain_fn = lambda luts, ids: ref.hop_adc_ref(codes_p, ids, luts)
    res_p = beam.beam_search(mem.graph.neighbors, mem.graph.medoid,
                             lut_fn(ds.queries), plain_fn, h=32, max_steps=512)
    same = float((res_p.ids[:, :10] == res_m.ids).all(dim=1).float().mean())
    log(f"[main] top-10 identical with the plain hop_adc routing: {same:.4f} of queries")
    check(same >= 0.99, "kernel-routed and plain-routed searches disagree")
    return dict(times=times, recall=rec, stats=stats, qps={"inmemory": qps_m,
                "hybrid": qps_h}, launches=counts, peak_gib=peak_gb, search_busy=busy,
                same_top10_plain=same, mean_degree=deg, graph_exact_recall=graph_rec,
                vamana_batch=args.vamana_batch,
                n_base=int(ds.base.shape[0]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0,
                    help="sift spec scale: 10 → 1M base vectors (default), "
                         "1 → the registered 100k")
    ap.add_argument("--vamana-batch", type=int, default=VAMANA_BATCH,
                    help="nodes per batched Vamana insert round")
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} kernel libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    n_base = max(int(100_000 * args.scale), 1000)
    t0 = time.perf_counter()
    kernels = parity_and_timing(n_base, 1000)
    log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    small_reference()
    log(f"[small] done in {time.perf_counter() - t0:.1f} s")
    result = main_path(args)
    for name, row in kernels.items():
        row["launches"] = result["launches"][name]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "kernels": kernels, "main": result}, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
