#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # full width: 1M x 128, M=16, K=256
    python3 chip_smoke.py --scale 1       # the sift spec's registered 100k base
    python3 chip_smoke.py --vamana-batch 1024   # the JAX builder's batch

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: the card's ``nvidia-smi`` name and power limit, torch's name;
2. build: the seven CUDA kernels from ``src/repro_torch/kernels/csrc`` (six
   sources), one ``nvcc`` per source, all at once;
3. parity: each kernel against its plain PyTorch version on CUDA tensors, at
   the main path's shapes and at edge shapes (the fs4 kernels ``hop_adc_fs``
   and ``adc_scan_fs`` exactly, on their int32 sums; ``adc_scan`` and
   ``hop_gather`` also against ``adc_scan_batch`` and ``hop_adc``), the
   ``pq_pairwise`` gradient against autograd of its plain version, then
   CUDA-event times of the kernel, the plain version and, where one PyTorch
   call computes the same function, that call (``cdist`` for
   ``pq_pairwise``; one ``embedding_bag`` for ``adc_scan_batch``,
   ``adc_scan`` and ``hop_gather``, its inputs built by ``lut_bag`` outside
   the timed window; ``hop_adc``, ``hop_adc_fs``, ``hop_gather`` and
   ``adc_scan``, shorter than their Python launch, and the last two's
   library calls are timed by replaying a captured CUDA graph of many
   launches, ``hop_adc_fs`` beside an empty kernel on its grid; the fs4
   dequant pass is timed beside ``adc_scan_fs``, ``adc_scan_batch`` beside
   its shared-memory floor, the PyTorch backward of ``pq_pairwise`` at the
   default training step's shape);
4. small reference: the unit-test dataset served on the card and on the CPU
   (the plain versions) from the same graph and quantizer must agree;
5. u8 path at full width: ``load_dataset("sift", scale=10)``, ``knn_ids``
   ground truth, ``train_pq(M=16, K=256)``, ``build_vamana(r=64, l=128)``,
   the graph's own recall@10 under exact-distance routing, ``encode``,
   ``InMemoryEngine`` / ``HybridEngine`` search (k=10, h=32) and the
   exhaustive ADC of ``pq.base.adc``, with every kernel's launch count read
   around this phase alone;
6. fs4 path at full width, on phase 5's dataset and graph:
   ``train_pq_fs4(M=16)``, ``encode`` + ``pack_codes``, quantized LUTs,
   ``InMemoryEngine`` / ``HybridEngine`` search (k=10, h=32) and the
   one-shard ``ShardedEngine`` scan with exact rerank (k=10), the same
   engine over phase 5's u8 codes, their QPS, a traced fs4 search, launch
   counts read around this phase alone; then the checks (kernel- vs
   plain-routed top-10, fs4 vs f32 ADC within M·scale, fs4 memory below
   u8) and the times of the scan engines' kernels (u8), dequant (fs4) and
   top-k at 1000 x 1M;
7. gather: phase 5's search with every round scored by ``ops.hop_gather``
   on rows gathered in PyTorch; ids, distances and counters must equal the
   ``hop_adc``-routed search;
8. train: ``core.trainer.fit`` with the reference's ``TrainConfig``
   defaults (1000 steps, batches of 512, a routing refresh every 100 steps)
   on phase 5's base and graph, from its PQ codebooks at R = I; step and
   refresh times, the busy share of 20 traced steps, peak memory, one step
   at the ``quant_train`` shape (8192 triplets, 4096 routing examples),
   finite losses and an orthonormal R; then the RPQ codes served by
   ``InMemoryEngine`` / ``HybridEngine`` beside phase 5's PQ, and both
   quantizers' reconstruction MSE;
9. retrieval: ``models.recsys.score_candidates_adc`` for 100 single queries
   over the 1M RPQ codes, its top-100 against the plain scan's, and its
   time per query beside ``score_candidates_exact``.

Phases 5–9 each read every kernel's launch count around their own run.
The last three lines are the kernels JSON (each kernel's ``launches`` summed
over those counted runs), the ``nvidia-smi`` line, and
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


def timed(times: dict, tag: str, label: str, fn):
    """``fn()`` between two device synchronizations; its wall seconds go
    into ``times[label]`` and a ``[tag]`` line."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[label] = time.perf_counter() - t0
    log(f"[{tag}] {label}: {times[label]:.2f} s")
    return out


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


def lut_bag(codes, luts):
    """Index and weight tensors with which ONE ``F.embedding_bag(idx, w,
    mode="sum")`` call computes an ADC function, each bag holding its M LUT
    entries in j order (the library yardstick; the port never calls it):

    - codes (N, M), luts (Q, M, K): ``adc_scan_batch``, result (N, Q), its
      transpose;
    - codes (N, M), luts (M, K): ``adc_scan``, result (N, 1);
    - codes (Q, R, M), luts (Q, M, K): ``hop_gather``, result (Q·R, 1).

    Built outside any timed window."""
    import torch

    dev = codes.device
    if codes.dim() == 3:
        q, m, k = luts.shape
        off = (torch.arange(q, device=dev)[:, None, None] * m
               + torch.arange(m, device=dev)[None, None, :]) * k
        return (codes.long() + off).reshape(-1, m), luts.reshape(-1, 1)
    m, k = luts.shape[-2:]
    idx = codes.long() + torch.arange(m, device=dev) * k
    if luts.dim() == 2:
        return idx, luts.reshape(-1, 1)
    return idx, luts.permute(1, 2, 0).reshape(m * k, luts.shape[0]).contiguous()


LIBRARY_CALL = ('torch.nn.functional.embedding_bag(idx, w, mode="sum"), idx and w '
                'built by lut_bag outside the timed window')


def library_time(codes, luts, want, *, graph: bool = False) -> tuple[float, float]:
    """Time of the one ``embedding_bag`` call that computes the same ADC
    function (CUDA events, or graph replay for the short rows), and its max
    abs error against ``want`` (a yardstick only: not held to a tolerance,
    since its sum order on the card is the library's)."""
    import torch

    idx, w = lut_bag(codes, luts)
    call = lambda: torch.nn.functional.embedding_bag(idx, w, mode="sum")
    err = float((call().reshape(want.shape) - want).abs().max())
    ms = graph_ms(call, iters=50) if graph else cuda_ms(call, iters=3)
    return ms, err


def smem_floor_ms(lookup_bytes: float) -> float:
    """Least time to read ``lookup_bytes`` from shared memory with no bank
    conflict: 128 bytes per clock per SM, at the card's SM count and its
    maximum SM clock (``nvidia-smi``)."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return lookup_bytes / (128 * sms * mhz * 1e6) * 1e3


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

    # adc_scan_batch, bit for bit: the main path's 1000 x N_base; ragged N,
    # M=8, odd M (byte loads), M=32 (a 4-query tile), K < 256, query counts
    # off the 8-query tile, a single row, and rows one byte off 16 (byte
    # loads at M=16)
    codes_full = codes_p[:n_base]
    luts_full = rand_luts(n_query, m)
    flat = torch.empty(4099 * m + 1, dtype=torch.uint8, device=dev)
    flat[1:] = rand_codes(4099, m).reshape(-1)
    for codes, luts in ((codes_full, luts_full), (rand_codes(4099, m), rand_luts(7, m)),
                        (rand_codes(10007, 8), rand_luts(13, 8)),
                        (rand_codes(3001, 7, 100), rand_luts(37, 7, 100)),
                        (rand_codes(2049, 32), rand_luts(13, 32)),
                        (rand_codes(1, m, 16), rand_luts(1, m, 16)),
                        (flat[1:].view(4099, m), rand_luts(9, m))):
        note("adc_scan_batch", compare(
            f"adc_scan_batch N={codes.shape[0]} M={codes.shape[1]} K={luts.shape[2]} "
            f"Q={luts.shape[0]}{' (unaligned rows)' if codes.data_ptr() % 16 else ''}",
            ops.adc_scan_batch(codes, luts), ref.adc_scan_batch_ref(codes, luts),
            rtol=0.0, atol=0.0))

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
    ms = cuda_ms(lambda: kadc.launch(codes_full, luts_full, aout), iters=5)
    plain_ms = cuda_ms(lambda: ref.adc_scan_batch_ref(codes_full, luts_full),
                       iters=2, warmup=1)
    del aout
    lib_ms, lib_err = library_time(codes_full, luts_full,
                                   ref.adc_scan_batch_ref(codes_full, luts_full).T)
    rows.append(dict(
        name="adc_scan_batch", route="cuda", source="src/repro_torch/kernels/csrc/adc_scan.cu",
        replaces="src/repro/kernels/adc_scan.py:131",
        shape=f"codes ({n_base},{m}) u8 x luts ({n_query},{m},{k})",
        max_abs_err=errs["adc_scan_batch"], ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by,
        smem_floor_ms=smem_floor_ms(n_query * n_base * m * 4),
        library_ms=lib_ms, library_err=lib_err, library_call=LIBRARY_CALL))
    for row in rows:
        issue = (f" (back-to-back launches from the host: {row['issue_ms']:.4f} ms)"
                 if "issue_ms" in row else "")
        floor = (f", shared-memory floor {row['smem_floor_ms']:.4f} ms"
                 if "smem_floor_ms" in row else "")
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms{issue}, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){floor}")
    return {row["name"]: row for row in rows}


def fs4_parity_and_timing(n_base: int, n_query: int) -> dict:
    """Phase 3 for the fs4 kernels: int32 sums must equal the plain
    versions' exactly (max abs error 0)."""
    import torch

    from repro_torch.kernels import adc_scan_fs as kadcfs
    from repro_torch.kernels import hop_adc_fs as khopfs
    from repro_torch.kernels import ops, ref
    from repro_torch.pq import pack

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    m = 16
    errs = {"hop_adc_fs": 0.0, "adc_scan_fs": 0.0}

    def exact(kernel, name, got, want):
        errs[kernel] = max(errs[kernel], compare(name, got.double(), want.double(),
                                                 rtol=0.0, atol=0.0))

    def rand_packed(n, mm):
        return pack.pack_codes(torch.randint(0, 16, (n, mm), generator=g, device=dev,
                                             dtype=torch.int32))

    def rand_luts(q, mm):
        return torch.randint(0, 256, (q, mm, 16), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    # hop_adc_fs over the sentinel-padded full-width corpus: R'=64 (one beam
    # round), the entry call R'=1, ragged 200 and 256, duplicates and the
    # sentinel, odd m_prefix=5 of 16; odd M=7 with odd m_prefix=3, Q=37
    packed_p = ops.pad_sentinel_row(rand_packed(n_base, m))
    cases = []
    for r, mp in ((64, 0), (1, 0), (200, 0), (256, 0), (64, 5)):
        ids = torch.randint(0, n_base + 1, (n_query, r), generator=g, device=dev,
                            dtype=torch.int32)
        if r >= 8:
            ids[:, : r // 4] = ids[:, r // 4: 2 * (r // 4)]   # duplicates
            ids[:, -1] = n_base                               # sentinel row
            ids[0, 0] = 0
        cases.append((packed_p, ids, rand_luts(n_query, m), mp))
    packed7 = ops.pad_sentinel_row(rand_packed(5003, 7))
    for mp in (0, 3):
        cases.append((packed7, torch.randint(0, 5004, (37, 72), generator=g, device=dev,
                                             dtype=torch.int32), rand_luts(37, 7), mp))
    # rows three bytes off 8 (the byte-load path at M=16)
    flat = torch.empty(5004 * 8 + 3, dtype=torch.uint8, device=dev)
    flat[3:] = ops.pad_sentinel_row(rand_packed(5003, m)).reshape(-1)
    for mp in (0, 5):
        cases.append((flat[3:].view(5004, 8), torch.randint(
            0, 5004, (37, 64), generator=g, device=dev, dtype=torch.int32),
            rand_luts(37, m), mp))
    for codes, ids, luts, mp in cases:
        want = (ref.hop_adc_fs_acc(codes[:, :(mp + 1) // 2], ids, luts[:, :mp]) if mp
                else ref.hop_adc_fs_acc(codes, ids, luts))
        exact("hop_adc_fs", f"hop_adc_fs N+1={codes.shape[0]} M={luts.shape[1]} "
              f"Q={ids.shape[0]} R'={ids.shape[1]} m_prefix={mp}"
              f"{' (unaligned rows)' if codes.data_ptr() % 8 else ''}",
              khopfs.hop_adc_fs(codes, ids, luts, m_prefix=mp), want)

    # adc_scan_fs: the main path's 1000 x N_base, held against the plain
    # version in query chunks; ragged N, odd M, M=9 (5-byte rows: the byte-
    # load path), M=32 (64 KB table), query counts off the 8-query tile
    packed_full = packed_p[:n_base]
    luts_full = rand_luts(n_query, m)
    got = kadcfs.adc_scan_fs(packed_full, luts_full)
    for q0 in range(0, n_query, 125):
        exact("adc_scan_fs", f"adc_scan_fs N={n_base} M={m} queries {q0}:{q0 + 125}",
              got[q0:q0 + 125], ref.adc_scan_fs_acc(packed_full, luts_full[q0:q0 + 125]))
    del got
    for n, mm, q in ((4099, 16, 13), (10007, 7, 8), (3001, 9, 1), (20000, 32, 21)):
        codes, luts = rand_packed(n, mm), rand_luts(q, mm)
        exact("adc_scan_fs", f"adc_scan_fs N={n} M={mm} Q={q}",
              kadcfs.adc_scan_fs(codes, luts), ref.adc_scan_fs_acc(codes, luts))

    # ---- times at the main path's shapes (kernel: the bare launch) ----
    rows = []
    ids, luts = cases[0][1], cases[0][2]
    hout = torch.empty(ids.shape, dtype=torch.int32, device=dev)
    distinct = int(torch.unique(ids).numel())
    mb = packed_p.shape[1]
    b_ms, b_by = bound(4 * ids.numel() + distinct * mb + luts.numel() + 4 * ids.numel(),
                       ids.numel() * m)
    rows.append(dict(
        name="hop_adc_fs", route="cuda", source="src/repro_torch/kernels/csrc/hop_adc_fs.cu",
        replaces="src/repro/kernels/hop_adc.py:254",
        shape=f"packed ({n_base + 1},{mb}) u8, ids ({n_query},64), luts "
              f"({n_query},{m},16) u8, one beam round",
        max_abs_err=errs["hop_adc_fs"],
        ms=graph_ms(lambda: khopfs.launch(packed_p, ids, luts, m, hout), iters=200),
        plain_ms=graph_ms(lambda: ref.hop_adc_fs_acc(packed_p, ids, luts), iters=50),
        issue_ms=cuda_ms(lambda: khopfs.launch(packed_p, ids, luts, m, hout), iters=200),
        floor_ms=graph_ms(lambda: khopfs.launch_empty(*ids.shape), iters=200),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=None))

    aout = torch.empty((n_query, n_base), dtype=torch.int32, device=dev)
    scale = torch.rand(n_query, generator=g, device=dev) + 0.1
    bias = torch.rand(n_query, generator=g, device=dev)
    b_ms, b_by = bound(packed_full.numel() + luts_full.numel() + 4 * aout.numel(),
                       aout.numel() * m)
    rows.append(dict(
        name="adc_scan_fs", route="cuda", source="src/repro_torch/kernels/csrc/adc_scan_fs.cu",
        replaces="src/repro/kernels/adc_scan_fs.py:81",
        shape=f"packed ({n_base},{mb}) u8 x luts ({n_query},{m},16) u8 -> int32",
        max_abs_err=errs["adc_scan_fs"],
        ms=cuda_ms(lambda: kadcfs.launch(packed_full, luts_full, aout), iters=5),
        plain_ms=cuda_ms(lambda: ref.adc_scan_fs_acc(packed_full, luts_full),
                         iters=2, warmup=1),
        dequant_ms=cuda_ms(lambda: ops._dequant(aout, scale, bias, m), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=None))
    for row in rows:
        extra = (f" (back-to-back launches from the host: {row['issue_ms']:.4f} ms; "
                 f"an empty kernel on its grid: {row['floor_ms']:.4f} ms)"
                 if "issue_ms" in row else
                 f" (the dequant pass in ops: {row['dequant_ms']:.4f} ms)")
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms{extra}, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return {row["name"]: row for row in rows}


def scorer_parity_and_timing(n_base: int, n_query: int) -> tuple[dict, dict]:
    """Phase 3 for ``adc_scan`` and ``hop_gather`` (rtol 1e-6 against their
    plain versions, and against ``adc_scan_batch`` / ``hop_adc``, which sum
    in the same order) and for the ``pq_pairwise`` gradient (the autograd
    Function, kernel forward, against autograd of the plain version, rtol
    1e-5). Returns the two kernel rows and the backward's times."""
    import torch

    from repro_torch.kernels import adc_scan as kadc
    from repro_torch.kernels import hop_gather as khopg
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    m, k, dsub = 16, 256, 8
    errs = {"adc_scan": 0.0, "hop_gather": 0.0}

    def note(kernel, e):
        errs[kernel] = max(errs[kernel], e)

    def rand_codes(shape, kk=k):
        return torch.randint(0, kk, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    def rand_lut(shape):  # non-negative, like squared distances
        return torch.rand(shape, generator=g, device=dev) * 20.0

    # adc_scan: the retrieval scorer's 1 x N_base; ragged N, odd M (byte
    # loads), K < 256, a single row; each also as a row of adc_scan_batch
    codes_full = rand_codes((n_base, m))
    lut_full = rand_lut((m, k))
    for codes, lut in ((codes_full, lut_full), (rand_codes((4099, m)), rand_lut((m, k))),
                       (rand_codes((3001, 7)), rand_lut((7, k))),
                       (rand_codes((777, m), 16), rand_lut((m, 16))),
                       (rand_codes((1, m)), rand_lut((m, k)))):
        name = f"adc_scan N={codes.shape[0]} M={codes.shape[1]} K={lut.shape[1]}"
        got = ops.adc_scan(codes, lut)
        note("adc_scan", compare(name, got, ref.adc_scan_ref(codes, lut),
                                 rtol=1e-6, atol=1e-6))
        compare(f"{name} vs adc_scan_batch row", got,
                ops.adc_scan_batch(codes, lut[None])[0], rtol=1e-6, atol=1e-6)

    # hop_gather: one beam round's (Q, R=64) pre-gathered rows; odd M,
    # K < 256, Q = 1, R = 1; each also against hop_adc on the same ids
    codes_p = ops.pad_sentinel_row(rand_codes((n_base, m)))
    cases = []
    for q, r, mm, kk in ((n_query, 64, m, k), (37, 200, 7, k), (1, 64, m, 16),
                         (5, 1, m, k)):
        cp = codes_p if mm == m and kk == k else ops.pad_sentinel_row(
            rand_codes((5003, mm), kk))
        ids = torch.randint(0, cp.shape[0], (q, r), generator=g, device=dev,
                            dtype=torch.int32)
        cases.append((cp, ids, rand_lut((q, mm, kk))))
    for cp, ids, luts in cases:
        name = (f"hop_gather Q={ids.shape[0]} R={ids.shape[1]} M={cp.shape[1]} "
                f"K={luts.shape[2]}")
        rows = cp[ids.long()]
        got = ops.hop_gather(rows, luts)
        note("hop_gather", compare(name, got, ref.hop_gather_ref(rows, luts),
                                   rtol=1e-6, atol=1e-6))
        compare(f"{name} vs hop_adc on the same ids", got, ops.hop_adc(cp, ids, luts),
                rtol=0.0, atol=0.0)

    # pq_pairwise gradient at the default training step's shape: 512·3
    # triplet rows + 512·16 routing candidates
    n_step = 512 * 3 + 512 * 16
    x = torch.randn((n_step, m, dsub), generator=g, device=dev) * 3.0
    cb = torch.randn((m, k, dsub), generator=g, device=dev) * 3.0
    up = torch.randn((n_step, m, k), generator=g, device=dev)
    x1, c1 = x.clone().requires_grad_(), cb.clone().requires_grad_()
    x2, c2 = x.clone().requires_grad_(), cb.clone().requires_grad_()
    ops.pq_pairwise(x1, c1).backward(up)
    ref.pq_pairwise_ref(x2, c2).backward(up)
    grad_err = max(compare(f"pq_pairwise d/dx N={n_step}", x1.grad, x2.grad,
                           rtol=1e-5, atol=1e-3),
                   compare(f"pq_pairwise d/dcodebooks N={n_step}", c1.grad, c2.grad,
                           rtol=1e-5, atol=1e-2))

    def plain_backward():
        x2.grad = c2.grad = None
        ref.pq_pairwise_ref(x2, c2).backward(up)

    backward = dict(shape=f"({n_step},{m},{dsub})x({m},{k},{dsub}) default train step",
                    max_abs_err=grad_err,
                    ms=cuda_ms(lambda: ops.pq_pairwise_backward(x, cb, up), iters=20),
                    plain_autograd_ms=cuda_ms(plain_backward, iters=10))
    log(f"[time] pq_pairwise backward {backward['shape']}: PyTorch products "
        f"{backward['ms']:.4f} ms, autograd of the plain version "
        f"{backward['plain_autograd_ms']:.4f} ms (no bound: not a kernel)")

    # ---- times at the main path's shapes (kernel: CUDA-graph replay) ----
    rows = []
    sout = torch.empty((n_base,), device=dev)
    b_ms, b_by = bound(codes_full.numel() + 4 * lut_full.numel() + 4 * sout.numel(),
                       codes_full.numel())
    rows.append(dict(
        name="adc_scan", route="cuda", source="src/repro_torch/kernels/csrc/adc_scan.cu",
        replaces="src/repro/kernels/adc_scan.py:74",
        shape=f"codes ({n_base},{m}) u8 x lut ({m},{k}), one query",
        max_abs_err=errs["adc_scan"],
        ms=graph_ms(lambda: kadc.launch_query(codes_full, lut_full, sout), iters=100),
        plain_ms=cuda_ms(lambda: ref.adc_scan_ref(codes_full, lut_full), iters=10),
        issue_ms=cuda_ms(lambda: kadc.launch_query(codes_full, lut_full, sout), iters=100),
        bound_ms=b_ms, bound_by=b_by, library_call=LIBRARY_CALL))
    rows[-1]["library_ms"], rows[-1]["library_err"] = library_time(
        codes_full, lut_full, ref.adc_scan_ref(codes_full, lut_full), graph=True)

    _, ids, luts = cases[0]
    rows_g = codes_p[ids.long()]
    gout = torch.empty(ids.shape, device=dev)
    b_ms, b_by = bound(rows_g.numel() + 4 * luts.numel() + 4 * gout.numel(), rows_g.numel())
    rows.append(dict(
        name="hop_gather", route="cuda", source="src/repro_torch/kernels/csrc/hop_gather.cu",
        replaces="src/repro/kernels/hop_gather.py:55",
        shape=f"codes ({n_query},64,{m}) u8 x luts ({n_query},{m},{k}), one beam round",
        max_abs_err=errs["hop_gather"],
        ms=graph_ms(lambda: khopg.launch(rows_g, luts, gout), iters=200),
        plain_ms=graph_ms(lambda: ref.hop_gather_ref(rows_g, luts), iters=50),
        issue_ms=cuda_ms(lambda: khopg.launch(rows_g, luts, gout), iters=200),
        bound_ms=b_ms, bound_by=b_by, library_call=LIBRARY_CALL))
    rows[-1]["library_ms"], rows[-1]["library_err"] = library_time(
        rows_g, luts, ref.hop_gather_ref(rows_g, luts), graph=True)
    for row in rows:
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms (back-to-back "
            f"launches from the host: {row['issue_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return {row["name"]: row for row in rows}, backward


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

def kernel_times(prof, tag: str, label: str, wall_ms: float) -> dict:
    """Device time by kernel name in a finished ``torch.profiler`` trace,
    its share of ``wall_ms`` (the untraced wall time of the same work) and
    the six largest kernels, logged as ``[tag]`` lines. Kernels run on one
    stream, so their summed time is the busy time."""
    import torch

    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            per_kernel[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    device_ms = sum(ms for ms, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    if device_ms == 0:
        log(f"[{tag}] {label}: the profiler saw no device time (not measured)")
        return {"device_ms": None, "wall_ms": wall_ms, "busy_share": None}
    log(f"[{tag}] {label}: device busy {device_ms:.2f} ms of {wall_ms:.2f} ms untraced "
        f"wall ({device_ms / wall_ms:.3f}); {sum(n for _, n in per_kernel.values())} kernels")
    for name, (ms, n) in top:
        log(f"[{tag}]   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
    return {"device_ms": device_ms, "wall_ms": wall_ms, "busy_share": device_ms / wall_ms,
            "top": [(name[:90], ms, n) for name, (ms, n) in top]}


def device_busy(fn, wall_s: float, label: str = "InMemoryEngine") -> dict:
    """Device time of one traced ``fn()`` by kernel name (torch.profiler),
    and its share of ``wall_s``, the untraced wall time of the same call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_times(prof, "trace", f"one {label} search", wall_s * 1e3)


def main_path(args) -> tuple:
    import torch

    from repro_torch.data import load_dataset
    from repro_torch.graphs import build_vamana, knn_ids
    from repro_torch.kernels import ops, ref
    from repro_torch.pq import base, train_pq
    from repro_torch.search import beam
    from repro_torch.search.engine import HybridEngine, InMemoryEngine
    from repro_torch.search.metrics import measure_qps, recall_at_k

    times: dict[str, float] = {}
    timed_ = lambda label, fn: timed(times, "main", label, fn)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ds = timed_("load_dataset", lambda: load_dataset("sift", scale=args.scale))
    log(f"[main] sift scale={args.scale}: base {tuple(ds.base.shape)}, queries "
        f"{tuple(ds.queries.shape)}, train {tuple(ds.train.shape)}")
    gt, _ = timed_("knn_ids", lambda: knn_ids(ds.base, ds.queries, 10, block=256))
    model = timed_("train_pq", lambda: train_pq(
        ds.train, 16, 256, generator=torch.Generator().manual_seed(1), iters=20))
    graph = timed_("build_vamana", lambda: build_vamana(
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
    codes = timed_("encode", lambda: base.encode(model, ds.base))
    lut_fn = lambda q: base.build_lut(model, q)
    mem = InMemoryEngine(graph, codes, lut_fn)
    hyb = HybridEngine(graph, codes, lut_fn, vectors=ds.base)
    res_m = timed_("search_inmemory", lambda: mem.search(ds.queries, k=10, h=32))
    res_h = timed_("search_hybrid", lambda: hyb.search(ds.queries, k=10, h=32))
    qps_m, _ = measure_qps(lambda q: mem.search(q, k=10, h=32), ds.queries)
    qps_h, _ = measure_qps(lambda q: hyb.search(q, k=10, h=32), ds.queries)
    adc = timed_("exhaustive_adc", lambda: base.adc(model, codes, ds.queries))
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
    for name in ("pq_pairwise", "hop_adc", "adc_scan_batch"):
        check(counts[name] > 0, f"kernel {name} was not launched on the main path")
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
                n_base=int(ds.base.shape[0])), ds, gt, graph, model, codes


# --------------------------------------------------------------------------
# phase 6: the fs4 path at full width, on the u8 path's dataset and graph
# --------------------------------------------------------------------------

def fs4_path(ds, gt, graph, u8_model, u8_codes) -> dict:
    import torch

    from repro_torch.kernels import adc_scan_fs as kadcfs
    from repro_torch.kernels import ops, ref
    from repro_torch.pq import base, pack, train_pq_fs4
    from repro_torch.search import beam
    from repro_torch.search.engine import (HybridEngine, InMemoryEngine,
                                           ShardedEngine, topk_lower)
    from repro_torch.search.metrics import measure_qps, recall_at_k

    times: dict[str, float] = {}
    timed_ = lambda label, fn: timed(times, "fs4", label, fn)
    nq = ds.queries.shape[0]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    model = timed_("train_pq_fs4", lambda: train_pq_fs4(
        ds.train, 16, generator=torch.Generator().manual_seed(1), iters=20))
    codes = timed_("encode", lambda: base.encode(model, ds.base))
    packed = pack.pack_codes(codes)
    lut_fn = lambda q: base.build_lut(model, q, quantize=True)
    mem = InMemoryEngine(graph, packed, lut_fn)
    hyb = HybridEngine(graph, packed, lut_fn, vectors=ds.base)
    shd = ShardedEngine(packed, lut_fn, vectors=ds.base)
    # the same scan engine over phase 5's u8 codes: adc_scan_batch's user path
    u8_lut_fn = lambda q: base.build_lut(u8_model, q)
    shd_u8 = ShardedEngine(u8_codes, u8_lut_fn, vectors=ds.base)
    res_m = timed_("search_inmemory", lambda: mem.search(ds.queries, k=10, h=32))
    res_h = timed_("search_hybrid", lambda: hyb.search(ds.queries, k=10, h=32))
    res_s = timed_("search_sharded", lambda: shd.search(ds.queries, k=10))
    res_u8 = timed_("search_sharded_u8", lambda: shd_u8.search(ds.queries, k=10))
    qps = {"inmemory": measure_qps(lambda q: mem.search(q, k=10, h=32), ds.queries)[0],
           "hybrid": measure_qps(lambda q: hyb.search(q, k=10, h=32), ds.queries)[0],
           "sharded": measure_qps(lambda q: shd.search(q, k=10), ds.queries)[0],
           "sharded_u8": measure_qps(lambda q: shd_u8.search(q, k=10), ds.queries)[0]}
    busy = device_busy(lambda: mem.search(ds.queries, k=10, h=32),
                       nq / qps["inmemory"], label="fs4 InMemoryEngine")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    rec = {name: recall_at_k(r.ids, gt, 10)
           for name, r in (("inmemory", res_m), ("hybrid", res_h), ("sharded", res_s),
                           ("sharded_u8", res_u8))}
    stats = {name: {"hops": float(r.hops.float().mean()),
                    "n_dist": float(r.n_dist.float().mean()),
                    "rounds": float(r.rounds.float().mean())}
             for name, r in (("inmemory", res_m), ("hybrid", res_h), ("sharded", res_s))}
    log(f"[fs4] recall@10 inmemory {rec['inmemory']:.4f} hybrid {rec['hybrid']:.4f} "
        f"sharded (scan + rerank of 40) {rec['sharded']:.4f}; u8 sharded (phase 5's "
        f"codes) {rec['sharded_u8']:.4f}")
    log(f"[fs4] inmemory hops {stats['inmemory']['hops']:.2f} n_dist "
        f"{stats['inmemory']['n_dist']:.2f} rounds {stats['inmemory']['rounds']:.2f}; "
        f"sharded n_dist {stats['sharded']['n_dist']:.0f}")
    log(f"[fs4] QPS (batch of {nq}): inmemory {qps['inmemory']:.1f} hybrid "
        f"{qps['hybrid']:.1f} sharded {qps['sharded']:.1f} u8 sharded "
        f"{qps['sharded_u8']:.1f}; peak device memory {peak_gb:.2f} GiB")
    log(f"[fs4] launches: {counts}")
    for name in ("pq_pairwise", "hop_adc_fs", "adc_scan_fs", "adc_scan_batch"):
        check(counts[name] > 0, f"kernel {name} was not launched on the fs4 path")
    for name, v in rec.items():
        check(math.isfinite(v), f"fs4 recall {name} is not finite")
    for name, r in (("inmemory", res_m), ("hybrid", res_h), ("sharded", res_s),
                    ("sharded_u8", res_u8)):
        check(r.ids.shape == (nq, 10), f"fs4 {name} result shape")
        check(bool(torch.isfinite(r.dists).all()), f"fs4 {name} distances not finite")

    # the same search routed by the plain hop_adc_fs version, on the card
    codes_p = mem._codes_p
    plain_fn = lambda ql, ids: ops._dequant(ref.hop_adc_fs_acc(codes_p, ids, ql.lut),
                                            ql.scale, ql.bias, model.m)
    res_p = beam.beam_search(graph.neighbors, graph.medoid, lut_fn(ds.queries),
                             plain_fn, h=32, max_steps=512)
    same = float((res_p.ids[:, :10] == res_m.ids).all(dim=1).float().mean())
    log(f"[fs4] top-10 identical with the plain hop_adc_fs routing: {same:.4f} of queries")
    check(same >= 0.99, "fs4 kernel-routed and plain-routed searches disagree")

    # fs4 bulk distances within M·scale of the f32 ADC of the same K=16 model
    q64 = ds.queries[:64]
    ql = lut_fn(q64)
    fs = ops.adc_scan_fs(packed, ql.lut, ql.scale, ql.bias)
    f32 = ops.adc_scan_batch(codes, base.build_lut(model, q64))
    ratio = float(((fs - f32).abs() / (model.m * ql.scale[:, None])).max())
    log(f"[fs4] |fs4 - f32 ADC| / (M*scale) over 64 queries x {codes.shape[0]} rows: "
        f"max {ratio:.4f} (bound 1)")
    check(bool(((fs - f32).abs() <= model.m * ql.scale[:, None] + 1e-4).all()),
          "fs4 bulk distances beyond M*scale of the f32 ADC")
    del fs, f32

    u8_lut = lambda q: base.build_lut(model, q)
    mem_bytes = {"inmemory": (mem.memory_bytes(),
                              InMemoryEngine(graph, codes, u8_lut).memory_bytes()),
                 "sharded": (shd.memory_bytes(),
                             ShardedEngine(codes, u8_lut, vectors=ds.base).memory_bytes())}
    log(f"[fs4] memory_bytes fs4 vs u8 of the same model: {mem_bytes}")
    for name, (b_fs, b_u8) in mem_bytes.items():
        check(b_fs < b_u8, f"fs4 {name} memory_bytes not below u8")

    # what the scan engine spends around the kernel, at 1000 x N
    ql = lut_fn(ds.queries)
    acc = kadcfs.adc_scan_fs(packed, ql.lut)
    d = ops._dequant(acc, ql.scale, ql.bias, model.m)
    scan = {"dequant_ms": cuda_ms(lambda: ops._dequant(acc, ql.scale, ql.bias, model.m),
                                  iters=5),
            "topk_lower_40_ms": cuda_ms(lambda: topk_lower(d, 40), iters=3),
            "topk_lower_10_ms": cuda_ms(lambda: topk_lower(d, 10), iters=3),
            "torch_topk_40_ms": cuda_ms(lambda: torch.topk(d, 40, dim=1, largest=False),
                                        iters=3),
            "stable_sort_ms": cuda_ms(lambda: torch.sort(d, dim=1, stable=True),
                                      iters=2, warmup=1)}
    del acc, d
    log(f"[fs4] scan engine at {nq} x {codes.shape[0]}: dequant "
        f"{scan['dequant_ms']:.3f} ms, stable top-40 {scan['topk_lower_40_ms']:.3f} ms, "
        f"stable top-10 {scan['topk_lower_10_ms']:.3f} ms (torch.topk 40, unstable: "
        f"{scan['torch_topk_40_ms']:.3f} ms; full stable sort "
        f"{scan['stable_sort_ms']:.3f} ms)")
    u8_luts = u8_lut_fn(ds.queries)
    d = ops.adc_scan_batch(u8_codes, u8_luts)
    scan["u8_adc_scan_batch_ms"] = cuda_ms(lambda: ops.adc_scan_batch(u8_codes, u8_luts),
                                           iters=5)
    scan["u8_topk_lower_40_ms"] = cuda_ms(lambda: topk_lower(d, 40), iters=3)
    del d
    log(f"[fs4] u8 scan engine at {nq} x {u8_codes.shape[0]}: adc_scan_batch "
        f"{scan['u8_adc_scan_batch_ms']:.3f} ms, stable top-40 "
        f"{scan['u8_topk_lower_40_ms']:.3f} ms")
    return dict(times=times, recall=rec, stats=stats, qps=qps, launches=counts,
                peak_gib=peak_gb, search_busy=busy, same_top10_plain=same,
                fs4_vs_f32_max_ratio=ratio, memory_bytes=mem_bytes, scan=scan)


# --------------------------------------------------------------------------
# phase 7: beam search routed through ops.hop_gather (the pre-fusion round)
# --------------------------------------------------------------------------

def gather_path(ds, graph, model, codes) -> dict:
    """The u8 search of phase 5 with every round scored by ``ops.hop_gather``
    on rows gathered in PyTorch, the reference's ``ops.hop_gather`` path. It
    must return the hop_adc-routed ids and counters exactly (both kernels
    sum in j order), and on one round's frontier ``hop_gather(codes[ids],
    luts)`` must equal ``hop_adc(codes, ids, luts)``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.pq import base
    from repro_torch.search import beam

    codes_p = ops.pad_sentinel_row(codes)
    frontier = {}

    def gather_fn(luts, ids):
        if "ids" not in frontier and ids.shape[1] > 1:
            frontier["ids"] = ids.clone()
        return ops.hop_gather(codes_p[ids], luts)

    times: dict[str, float] = {}
    ops.reset_launch_counts()
    luts = base.build_lut(model, ds.queries)
    res_g = timed(times, "gather", "search_hop_gather", lambda: beam.beam_search(
        graph.neighbors, graph.medoid, luts, gather_fn, h=32, max_steps=512))
    counts = ops.launch_counts()
    log(f"[gather] launches: {counts}")
    check(counts["hop_gather"] > 0, "kernel hop_gather was not launched on its path")

    res_a = timed(times, "gather", "search_hop_adc", lambda: beam.beam_search(
        graph.neighbors, graph.medoid, luts, beam.make_adc_dist_fn(codes_p), h=32,
        max_steps=512))
    same = {name: bool(torch.equal(getattr(res_g, name), getattr(res_a, name)))
            for name in ("ids", "dists", "hops", "n_dist", "rounds")}
    ids = frontier["ids"]
    round_equal = bool(torch.equal(ops.hop_gather(codes_p[ids], luts),
                                   ops.hop_adc(codes_p, ids, luts)))
    log(f"[gather] hop_gather-routed vs hop_adc-routed search (1000 queries, h=32): "
        f"equal {same}; one round's frontier ({tuple(ids.shape)}) equal {round_equal}")
    check(all(same.values()), "hop_gather-routed search differs from hop_adc-routed")
    check(round_equal, "hop_gather(codes[ids]) differs from hop_adc(codes, ids)")
    return dict(times=times, launches=counts, same=same, round_equal=round_equal)


# --------------------------------------------------------------------------
# phase 8: RPQ training at full width, then serving its codes
# --------------------------------------------------------------------------

TRACE_FROM_STEP = 301  # the 20 traced steps hold no routing refresh
TRACE_STEPS = 20


def train_path(ds, gt, graph, pq_model, pq_main: dict) -> tuple[dict, object, object, object]:
    """``fit`` with the reference's TrainConfig defaults on the 1M base and
    its R=64 graph, from the u8 phase's PQ codebooks at R = I; step and
    refresh times, the busy share of 20 traced steps, one step at the
    ``quant_train`` shape; then the RPQ codes served beside PQ."""
    import dataclasses
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common import adam, one_cycle
    from repro_torch.core import features as F
    from repro_torch.core import quantizer as Q
    from repro_torch.core import trainer as T
    from repro_torch.kernels import ops
    from repro_torch.pq import base
    from repro_torch.search.engine import HybridEngine, InMemoryEngine
    from repro_torch.search.metrics import measure_qps, recall_at_k

    dev = ds.base.device
    cfg = Q.RPQConfig(dim=ds.base.shape[1], m=16, k=256)
    tcfg = T.TrainConfig()
    params0 = Q.init_params(cfg, pq_model.codebooks)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_step(step, params, opt_state):
        torch.cuda.synchronize()
        marks[step] = time.perf_counter()
        if step == TRACE_FROM_STEP - 1:
            prof.start()
        elif step == TRACE_FROM_STEP + TRACE_STEPS - 1:
            prof.stop()

    torch.cuda.synchronize()
    marks[-1] = t0 = time.perf_counter()
    state = T.fit(cfg, tcfg, ds.base, graph, seed=0, params=params0,
                  checkpoint_cb=on_step, verbose=True, device=dev)
    fit_s = time.perf_counter() - t0
    peak_fit = torch.cuda.max_memory_allocated() / 2**30
    dt = {s: (marks[s] - marks[s - 1]) * 1e3 for s in range(tcfg.steps)}
    traced = range(TRACE_FROM_STEP, TRACE_FROM_STEP + TRACE_STEPS)
    plain = [dt[s] for s in dt if s % tcfg.refresh_every and s not in traced]
    step_ms = statistics.median(plain)
    refresh_ms = statistics.median(dt[s] - step_ms for s in dt
                                   if s % tcfg.refresh_every == 0 and s > 0)
    log(f"[train] fit: {tcfg.steps} steps in {fit_s:.1f} s; median step {step_ms:.3f} ms "
        f"(first step {dt[0]:.1f} ms with the first refresh); routing refresh "
        f"{refresh_ms:.1f} ms (median over {tcfg.steps // tcfg.refresh_every - 1})")
    trace = kernel_times(prof, "train", f"{TRACE_STEPS} traced steps (wall: {TRACE_STEPS} "
                         f"untraced median steps; traced {sum(dt[s] for s in traced):.1f} ms)",
                         TRACE_STEPS * step_ms)
    log(f"[train] peak device memory {peak_fit:.2f} GiB")
    hist = state.history
    check(all(math.isfinite(h["total"]) and math.isfinite(h["gnorm"]) for h in hist),
          "a logged loss or gradient norm is not finite")
    r = Q.rotation_matrix(cfg, state.params).detach()
    ortho = float((r.T @ r - torch.eye(cfg.dim, device=r.device)).abs().max())
    log(f"[train] |R^T R - I|_max {ortho:.3e}; loss total {hist[0]['total']:.4f} -> "
        f"{hist[-1]['total']:.4f} (routing {hist[0]['routing']:.4f} -> "
        f"{hist[-1]['routing']:.4f}, nbr {hist[0]['neighborhood']:.4f} -> "
        f"{hist[-1]['neighborhood']:.4f}, alpha {hist[-1]['alpha']:.4f})")
    check(ortho < 1e-4, f"R is not orthonormal: {ortho:.3e}")

    # one step at the quant_train cell's shape (configs/rpq_paper.py)
    qt = dataclasses.replace(tcfg, triplet_batch=8192, routing_batch=4096)
    qt_step = T.make_train_step(cfg, qt, adam(one_cycle(qt.lr, qt.steps)))
    model = T.to_model(cfg, state.params)
    g = torch.Generator(device=dev).manual_seed(7)
    pool = F.sample_routing(graph, ds.base, ds.base[torch.randperm(
        ds.base.shape[0], generator=g, device=dev)[:qt.routing_pool_queries]],
        base.encode(model, ds.base), lambda q: base.build_lut(model, q), h=qt.beam_h)

    def quant_train_step():
        anchors = torch.randint(0, ds.base.shape[0], (qt.triplet_batch,), generator=g,
                                device=dev)
        trip = F.sample_triplets(graph, ds.base, anchors, generator=g)
        route = F.subsample_routing(pool, qt.routing_batch, generator=g)
        return qt_step(state.params, state.opt_state, ds.base, trip, route, generator=g)

    quant_train_step()
    torch.cuda.reset_peak_memory_stats()
    qt_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = quant_train_step()
        torch.cuda.synchronize()
        qt_ms.append((time.perf_counter() - t1) * 1e3)
    check(math.isfinite(float(out[2].total)), "quant_train step loss not finite")
    peak_qt = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] quant_train step (8192 triplets, 4096 routing x h=16): "
        f"{statistics.median(qt_ms):.2f} ms (median of 3), peak {peak_qt:.2f} GiB")

    # serve the RPQ codes beside PQ's from phase 5
    codes = base.encode(model, ds.base)
    lut_fn = lambda q: base.build_lut(model, q)
    mem = InMemoryEngine(graph, codes, lut_fn, device=dev)
    hyb = HybridEngine(graph, codes, lut_fn, vectors=ds.base, device=dev)
    res_m, res_h = mem.search(ds.queries, k=10, h=32), hyb.search(ds.queries, k=10, h=32)
    rec = {"inmemory": recall_at_k(res_m.ids, gt, 10), "hybrid": recall_at_k(res_h.ids, gt, 10)}
    qps = {"inmemory": measure_qps(lambda q: mem.search(q, k=10, h=32), ds.queries)[0],
           "hybrid": measure_qps(lambda q: hyb.search(q, k=10, h=32), ds.queries)[0]}
    counts = ops.launch_counts()
    sub = ds.base[:100_000]
    mse = {"rpq": float(Q.reconstruction_mse(cfg, state.params, sub)),
           "pq": float(Q.reconstruction_mse(cfg, params0, sub))}
    log(f"[train] recall@10 (h=32) RPQ inmemory {rec['inmemory']:.4f} hybrid "
        f"{rec['hybrid']:.4f} | PQ inmemory {pq_main['recall']['inmemory']:.4f} hybrid "
        f"{pq_main['recall']['hybrid']:.4f}")
    log(f"[train] QPS RPQ inmemory {qps['inmemory']:.1f} hybrid {qps['hybrid']:.1f} | "
        f"PQ inmemory {pq_main['qps']['inmemory']:.1f} hybrid {pq_main['qps']['hybrid']:.1f}")
    log(f"[train] reconstruction_mse on 100k rows: RPQ {mse['rpq']:.4f} PQ {mse['pq']:.4f}")
    log(f"[train] launches: {counts}")
    for name in ("pq_pairwise", "hop_adc"):
        check(counts[name] > 0, f"kernel {name} was not launched on the training path")
    for name, v in rec.items():
        check(math.isfinite(v), f"RPQ recall {name} is not finite")
    check(bool(torch.isfinite(res_m.dists).all()), "RPQ InMemoryEngine distances not finite")
    result = dict(fit_s=fit_s, step_ms=step_ms, first_step_ms=dt[0], refresh_ms=refresh_ms,
                  trace=trace, peak_gib=peak_fit,
                  quant_train_ms=qt_ms, quant_train_peak_gib=peak_qt, ortho=ortho,
                  history=hist, recall=rec, qps=qps, mse=mse, launches=counts)
    return result, cfg, state.params, codes


# --------------------------------------------------------------------------
# phase 9: the retrieval scorer over the RPQ codes
# --------------------------------------------------------------------------

def retrieval_path(ds, cfg, params, codes, n_queries: int = 100, k: int = 100) -> dict:
    """``score_candidates_adc`` (the ``adc_scan`` kernel and a stable
    top-k) over the 1M RPQ codes for single queries, against the plain
    scan's top-k, and timed beside ``score_candidates_exact``."""
    import torch

    from repro_torch.core import quantizer as Q
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys
    from repro_torch.search.engine import topk_lower

    qs = ds.queries[:n_queries]
    luts = Q.build_lut(cfg, params, qs).detach()
    ops.reset_launch_counts()
    got = [recsys.score_candidates_adc(luts[i], codes, k=k) for i in range(n_queries)]
    counts = ops.launch_counts()
    check(counts["adc_scan"] > 0, "kernel adc_scan was not launched on the retrieval path")
    same = sum(bool(torch.equal(ids.long(), topk_lower(ref.adc_scan_ref(codes, luts[i])[None],
                                                       k)[1][0]))
               for i, (_, ids) in enumerate(got)) / n_queries
    check(all(bool(torch.isfinite(v).all()) and v.shape == (k,) for v, _ in got),
          "retrieval scores not finite or of the wrong shape")

    def per_query_us(fn):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_queries):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_queries * 1e6

    adc_us = per_query_us(lambda i: recsys.score_candidates_adc(luts[i], codes, k=k))
    exact_us = per_query_us(lambda i: recsys.score_candidates_exact(qs[i], ds.base, k=k))
    scan_us = per_query_us(lambda i: ops.adc_scan(codes, luts[i]))
    log(f"[retrieval] {n_queries} single queries, k={k}, over {codes.shape[0]} RPQ codes: "
        f"kernel top-{k} ids equal the plain scan's on {same:.4f} of queries")
    log(f"[retrieval] per query: score_candidates_adc {adc_us:.1f} us (adc_scan alone "
        f"{scan_us:.1f} us), score_candidates_exact (GEMV + top-k) {exact_us:.1f} us")
    log(f"[retrieval] launches: {counts}")
    check(same >= 0.99, "kernel-scored and plain-scored top-k ids disagree")
    return dict(same_topk=same, adc_us=adc_us, adc_scan_us=scan_us, exact_us=exact_us,
                launches=counts)


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
    kernels.update(fs4_parity_and_timing(n_base, 1000))
    scorer_rows, backward = scorer_parity_and_timing(n_base, 1000)
    kernels.update(scorer_rows)
    log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    small_reference()
    log(f"[small] done in {time.perf_counter() - t0:.1f} s")
    result, ds, gt, graph, pq_model, pq_codes = main_path(args)
    phases = {"main": result}
    t0 = time.perf_counter()
    phases["fs4"] = fs4_path(ds, gt, graph, pq_model, pq_codes)
    log(f"[fs4] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phases["gather"] = gather_path(ds, graph, pq_model, pq_codes)
    log(f"[gather] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phases["train"], cfg, params, rpq_codes = train_path(ds, gt, graph, pq_model, result)
    log(f"[train] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phases["retrieval"] = retrieval_path(ds, cfg, params, rpq_codes)
    log(f"[retrieval] done in {time.perf_counter() - t0:.1f} s")
    for name, row in kernels.items():
        row["launches"] = sum(p["launches"][name] for p in phases.values())
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "kernels": kernels, "pq_pairwise_backward": backward,
                       **phases}, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
