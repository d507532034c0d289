#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # full width: 1M x 128, M=16, K=256
    python3 chip_smoke.py --scale 1       # the sift spec's registered 100k base
    python3 chip_smoke.py --vamana-batch 1024   # the JAX builder's batch

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: the card's ``nvidia-smi`` name and power limit, torch's name;
2. build: the nine CUDA kernels from ``src/repro_torch/kernels/csrc`` (seven
   sources; four of them also as int32-code variants), one ``nvcc`` per
   source, all at once;
3. parity: each kernel against its plain PyTorch version on CUDA tensors, at
   the main path's shapes and at edge shapes (``hop_adc``, ``adc_scan`` and
   ``adc_scan_batch``, in both code types, bit for bit, on every timed
   output too; the fs4 kernels ``hop_adc_fs`` and ``adc_scan_fs`` exactly,
   on their int32 sums; ``adc_scan`` and ``hop_gather`` also against
   ``adc_scan_batch`` and ``hop_adc``), the
   ``pq_pairwise`` gradient against autograd of its plain version, then
   CUDA-event times of the kernel, the plain version and, where one PyTorch
   call computes the same function, that call (``cdist`` for
   ``pq_pairwise``; one ``embedding_bag`` for ``adc_scan_batch``,
   ``adc_scan`` and ``hop_gather``, its inputs built by ``lut_bag`` outside
   the timed window; ``hop_adc``, ``hop_adc_fs``, ``hop_gather`` and
   ``adc_scan``, shorter than their Python launch, and the last two's
   library calls are timed by replaying a captured CUDA graph of many
   launches rotated over input sets past twice the L2, so that each
   launch reads HBM as its bound assumes (the L2-warm time is logged
   beside), ``hop_adc_fs`` beside an empty kernel on its grid; the fs4
   dequant pass is timed beside ``adc_scan_fs``, ``adc_scan_batch`` beside
   its shared-memory floor, ``adc_scan`` beside the floor its timed codes'
   bank conflicts set, ``hop_adc`` and ``hop_adc_i32`` beside a bound
   counted on the 32-byte sectors their timed ids, rows and LUT entries
   touch (``sector_bound``), the PyTorch backward of ``pq_pairwise`` at the
   default training step's shape beside its bound); then the int32-code
   variants of ``adc_scan_batch``, ``adc_scan``, ``hop_adc`` and
   ``hop_gather`` at K=512 and the subspace chunking past shared memory (M=64, K=1024 on
   int32 codes; M=208, K=256 on uint8; fs4 ``adc_scan_fs`` at M=128 and
   201, exactly), each against its plain version, and the int32 variants
   at 1000 × 1M, M=16, K=512: the timed outputs held against their plain
   versions, and their times; ``adc_scan_batch_i32`` beside the HBM bytes
   its plan should move (``adc_batch_i32_bytes``) and its diagnostic rows
   (``adc_batch_rows``: int32 at K=512 at 100k, 250k and 1M rows, int32
   against uint8 at K=256, and the streaming round's 1000 × 50,000 delta
   shape, each bit for bit); last the classic beam round's two kernels
   (``beam_round_rows``: ``beam_expand`` and ``beam_merge`` at 10,000
   lanes, h = 96, R = 64 on a random graph over the base's vertex count),
   one whole search through them equal to the op chain bit for bit, and
   each kernel's time beside its plain version's and its bound, its timed
   outputs equal to the plain version's;
4. small reference: the unit-test dataset served on the card and on the CPU
   (the plain versions) from the same graph and quantizer must agree; at
   S=4, one partition built on the CPU served by ``ShardedGraphEngine``
   (three knob sets) and ``ShardedEngine(n_shards=4)`` in both layouts on
   the card and on the CPU with the same LUTs must agree bit for bit; the
   unit-test HNSW (m=8) and NSG (r=16, k=24, search_l=24) built on the card
   and on the CPU from the same draws (rows identical on ≥ 95%), HNSW
   descent (entries identical on ≥ 99%) and ``InMemoryEngine`` with
   ``entry_fn=descend`` (top-10 identical on ≥ 99%) on both, and a small
   Catalyst trained on the CPU served on both (``forward`` within 1e-5,
   codes identical on ≥ 99.9%);
5. u8 path at full width: ``load_dataset("sift", scale=10)``, ``knn_ids``
   ground truth, ``train_pq(M=16, K=256)``, ``build_vamana(r=64, l=128)``
   (beside phase 11, whose end it then waits for),
   the graph's own recall@10 under exact-distance routing, ``encode``,
   ``InMemoryEngine`` / ``HybridEngine`` search (k=10, h=32) and the
   exhaustive ADC of ``pq.base.adc``, with every kernel's launch count read
   around this phase alone, and one traced search: the device's busy share,
   its kernel count and ``hop_adc``'s mean device time per launch beside its
   phase-3 L2-cold and L2-warm times;
6. fs4 path at full width, on phase 5's dataset and graph:
   ``train_pq_fs4(M=16)``, ``encode`` + ``pack_codes``, quantized LUTs,
   ``InMemoryEngine`` / ``HybridEngine`` search (k=10, h=32) and the
   one-shard ``ShardedEngine`` scan with exact rerank (k=10), the same
   engine over phase 5's u8 codes, their QPS, a traced fs4 search (with
   ``hop_adc_fs``'s mean time per launch, as in phase 5), launch counts read
   around this phase alone; then the checks (kernel- vs
   plain-routed top-10, fs4 vs f32 ADC within M·scale, fs4 memory below
   u8) and the times of the scan engines' kernels (u8), dequant (fs4) and
   top-k at 1000 x 1M;
7. gather: phase 5's search with every round scored by ``ops.hop_gather``
   on rows gathered in PyTorch; ids, distances and counters must equal the
   ``hop_adc``-routed search;
8. train: ``core.trainer.fit`` with the reference's ``TrainConfig``
   defaults (batches of 512, a routing refresh every 100 steps) but 250
   steps, not 1000 (``TRAIN_STEPS``)
   on phase 5's base and graph, from its PQ codebooks at R = I; step and
   refresh times, the busy share of 20 traced steps, peak memory, one step
   at the ``quant_train`` shape (8192 triplets, 4096 routing examples),
   finite losses and an orthonormal R; then the RPQ codes served by
   ``InMemoryEngine`` / ``HybridEngine`` beside phase 5's PQ, and both
   quantizers' reconstruction MSE;
9. retrieval: ``models.recsys.score_candidates_adc`` for 100 single queries
   over the 1M RPQ codes, its top-100 against the plain scan's, and its
   time per query beside ``score_candidates_exact``;
10. adaptive: on phase 5's graph, u8 codes and queries and phase 6's fs4
   codes, the five rows of ``examples/adaptive_routing.py`` (baseline,
   ``entries=8``, ``prune_eps=0.2, m_prefix=2``, seeded + pruned, + ``expand=4``)
   through ``InMemoryEngine`` and ``HybridEngine`` (h=32, k=10) in both
   layouts, a ``max_rounds`` sweep, ``calibrate_max_rounds`` for a deadline
   and ``DegradationPolicy`` levels 0–4 on ``HybridEngine``; checks: (a) the
   default knobs equal phase 5's search bit for bit, (b) every row's
   kernel-routed top-10 equals its plain-routed one on ≥ 99% of queries, (c)
   budgets bind per lane and a lane not flagged ``truncated`` is converged,
   (d) the ``m_prefix=2`` distance of both kernels is ≤ the full one on a
   sampled frontier, (e) pruning cuts ``n_dist``;
11. cli: in a temporary directory, ``python -m repro_torch.launch.train``
   on the ``sift`` spec's registered 100k base at M=16, K=256, R=64, L=128
   (its graphs built 4096 nodes a round, ``--graph-batch``)
   (200 steps, a checkpoint every 50, a crash injected at step 120 and a
   supervised restart), then ``python -m repro_torch.launch.serve`` for the
   ``memory``, ``hybrid`` (``--entries 8 --prune-eps 0.2``, a deadline from
   the memory run, ``--degrade-level 2``, ``--chaos io=0.05``) and
   ``sharded`` scenarios, and ``streaming`` (``--churn 0.1 --churn-rounds 4
   --refresh-every 2``: generation 0 is the 90k rows left by the hold-out,
   two refreshed consolidations), then ``disk`` twice, plain and with
   ``--chaos slow_read=2,corrupt_record,io=0.05`` (its ``[serve] disk:``
   and ``[serve] disk io:`` lines parsed; no retries on the plain run), then
   ``sharded-graph --shards 4`` at R=32, l=64 three times: the first builds
   ``graph_part4.npz``, the second loads it, the third runs with ``--chaos
   dead=1`` (degraded); each subprocess reports its kernel launches. The
   phase runs in a thread of its own beside phase 5's Vamana build (a
   host-bound loop that leaves the card mostly idle): it starts after
   phase 4, and phase 5 waits for it after the build, before its first
   search, so no time measured from there on shares the card with it.
   After ``train``, the serve runs go as five chains, three at a time:
   memory then hybrid (whose deadline comes from the memory run), sharded,
   streaming, disk then disk with chaos (which corrupts the first's
   segment), and the three sharded-graph runs (which share
   ``graph_part4.npz``);
12. stream (run after phase 10): ``index.StreamingEngine`` on
   phase 5's 1M base, R=64 graph, u8 codes and PQ model, a delta of 50,000
   slots, 4 rounds that each tombstone 12,500 random live base rows (numpy
   seed 0) and insert the same vectors as new rows, then a 1000-query
   search at h=32, k=10 against ``live_ground_truth`` (QPS, the delta
   arm's own CUDA-event ms, ``n_live``, resident MB); a refreshed
   consolidation (``RefreshConfig()``) after round 2, a plain one with a
   snapshot and ``StreamingEngine.restore`` after round 4; then 2 such
   rounds over phase 6's fs4 codes (no consolidation) and one round over
   K=512 int32 codes of a PQ trained here, whose search also runs down the
   ``hop_gather`` route (equal to the ``hop_adc`` route) and whose codes
   ``score_candidates_adc`` scores for 10 queries (top-100 equal to the
   plain scan's). Checks: (a) no tombstoned id is
   returned; (b) every inserted vector queried as itself returns its new
   id at rank 0, or on an exact ADC tie an earlier delta row; (c) the
   kernel-routed top-10 (beam and delta scan) equals the plain-routed one
   on ≥ 99% of queries; (d) the restored engine's search equals the
   pre-snapshot one bit for bit; (e) the refresh does not raise the live
   distortion; (f) each consolidation's ``old2new`` maps exactly the live
   ids. Logs delete, insert, consolidation, refresh and restore seconds,
   the phase's kernel launches (the delta arm's CUDA-event timing calls
   not counted) and its peak device memory;
13. disk (run after phase 12): ``storage.DiskEngine`` on phase 5's base,
   R=64 graph, u8 codes and PQ model and phase 6's fs4 codes and model:
   generation 0 of each layout written to a temporary directory and opened
   from its quantizer sidecar (LUTs by ``pq_pairwise`` on the card) with a
   32 MB hot-vertex cache and 4 reader threads; one serial search of the
   1000 queries per layout (recall@10, QPS, rounds, hops, ``n_dist``, cache
   hit rate, bytes read a query, I/O wait, kernel launches; the u8 one also
   traced for the device's busy share); then the reference bench's serial
   vs overlapped comparison on 200 queries (``benchmarks/disk_serving.py``:
   a warm-up and one timed run per arm where the bench takes the best of
   two, read latency at 1.2x the per-round compute clipped to [0.5, 20]
   ms, and at 0), its speedup
   reported against the reference's 1.5x bar without failing on it. Checks:
   (a) on 100 queries per layout, the card's serial search equals the CPU
   route's (plain versions, the same LUTs on the CPU) bit for bit; (b) the
   u8 recall within 0.01 of phase 5's ``InMemoryEngine`` (and the share of
   queries with its top-10); (c) overlapped recall within 0.01 of serial;
   (d) after tombstoning 1% of the ids (numpy seed 0), none is returned;
   (e) ``max_rounds=5`` bounds rounds and flags ``truncated`` exactly where
   the free search took more; (f) a corrupt generation 1 falls back to
   generation 0, whose search it equals; (g) the sidecar route equals an
   explicit ``lut_fn``; (h) ``pq_pairwise``, ``hop_adc`` and ``hop_adc_fs``
   ran.

14. sharded (run after phase 13): ``build_partitioned_vamana`` into 4 shards
   (R=32, l=64, α=1.2, the Vamana batch of phase 5) on phase 5's 1M base,
   its seconds per shard; ``ShardedGraphEngine`` over phase 5's u8 and phase
   6's fs4 codes (h=32, k=10), plain, ``expand=4`` and with ``vectors=``
   (local rerank): recall@10, QPS, rounds (mean, max), hops, ``n_dist``,
   launches, a traced search per layout (busy share, ``hop_adc`` /
   ``hop_adc_fs`` mean µs a launch); ``ShardedEngine`` at 1 and 4 shards,
   with and without the rerank, in both layouts; the partition's recall
   under exact routing merged over the shards; then 100 ``fit`` steps at
   ``TrainConfig`` defaults on one device and with 4 data-parallel replicas
   and int8 compression (median step ms, peak GiB). Checks: (a) per layout,
   on all 1000 queries, the lockstep S=4 search equals the four
   ``InMemoryEngine`` searches over ``shard_subgraph(pg, s)`` merged by
   ``partial_merge`` bit for bit (ids, dists, summed ``hops`` and ``n_dist``,
   max ``rounds``, any ``truncated``); (b) the same with ``entries=4,
   prune_eps=0.2`` and with ``max_rounds=5``; (c) S=4 recall ≥ phase 5's
   ``InMemoryEngine`` recall − 0.05, and the rerank recall ≥ the plain one;
   (d) a dead shard 1 returns none of its ids, no higher recall, degraded;
   (e) a straggler past the deadline is dropped exactly as ``resolve_quorum``
   says, and a quorum of 4 waits for it; (f) the S=4 scan's sorted top-10
   distances equal the one-shard scan's bit for bit; (g) the partition's
   exact-routed recall ≥ 0.5; (h) ``hop_adc``, ``hop_adc_fs``,
   ``adc_scan_batch`` and ``adc_scan_fs`` ran; DP losses finite and every
   error-feedback residual within one quantization step.

15. pgraphs (run after phase 14, in the main process): on phase 5's 1M
   base, queries and ground truth, one exact k=48 kNN of the base, then
   ``build_hnsw(m=12)`` (its layer 0 from that kNN) and ``build_nsg(r=24,
   k=32, search_l=32)`` (from its first 32 columns; the parameters of
   ``benchmarks/paper_tables.py:85-86``; NSG at phase 5's Vamana batch),
   their seconds, degree stats and NSG's nodes
   unreachable before each repair pass; ``train_opq(outer_iters=4,
   kmeans_iters=8)`` and ``train_catalyst(M=16, K=256, d_out=48,
   steps=1000)`` on ``ds.train`` (d_out=48: the multiple of 16 nearest the
   paper's 40, which the reference's assert rejects at M=16), training
   seconds and model bytes beside PQ's and RPQ's (Tables 4-5);
   ``InMemoryEngine`` over HNSW (``entry_fn=descend``) and over NSG with
   phase 5's PQ, OPQ's and phase 8's RPQ codes (h=32, k=10; recall@10,
   QPS, rounds, hops; Figures 6-7) and the descent's ms alone;
   ``HybridEngine`` and ``InMemoryEngine`` with Catalyst codes, and
   ``HybridEngine`` with OPQ codes, over phase 5's Vamana graph (Figure
   5); each graph's exact-routed recall@10; one traced HNSW-PQ search
   (busy share, ``hop_adc`` µs a launch). Checks: (a) HNSW's base degree
   ≤ 2m and its upper layers' ≤ m, NSG's ≤ r, no self edge, no id past
   the sentinel, and BFS from NSG's medoid reaches every node; (b) for
   HNSW-PQ and NSG-PQ the kernel-routed top-10 equals the plain-routed one
   (``ref.hop_adc_ref``, same entries) on ≥ 99% of queries; (c) each
   graph's exact-routed recall ≥ its floor (``MIN_EXACT_RECALL_HNSW``,
   ``MIN_EXACT_RECALL_NSG``); (d) Catalyst's losses finite at every step,
   ``catalyst.adc`` equal to the plain ``adc_scan_batch`` bit for bit on
   1000 queries, its Hybrid recall ≥ its InMemory recall; (e)
   ``pq_pairwise``, ``hop_adc`` and ``adc_scan_batch`` ran. No ordering
   between quantizers is gated: their ADC recall on this spec is about
   0.01.
16. archs (run last, once the earlier phases' tensors are freed): the
   model zoo. (a) every registry arch but ``rpq`` at its reduced config, one
   set of params made on the CPU, its train step (+ prefill and decode for
   the LMs) on the card and on the CPU: losses within 1e-5 relative,
   logits within 1e-3, params after the step within 2·lr and 99% within
   1e-4 relative (TF32 off); (b) granite-moe-1b-a400m at its published
   config (bf16, 4 microbatches, remat) trains 3 steps on one ``lm_batch``
   of 8 × 4096 (the loss is finite and falls; step ms, tokens/s, model-FLOPs
   share of 989 TFLOP/s, peak GiB), then prefill 8 × 2048 and 8 decode
   steps against forward's logits at the same positions (``ARCHS_DECODE_TOL``
   on the capacity factor E/k, where no expert overflows and decode and
   forward route alike; the published capacity's numbers are logged);
   (c) granite-3-8b at its published config, 40 layers, prefill 8 × 2048
   into a 32,768-slot cache and 16 decode steps beside their HBM bound
   (weights + the whole cache once a step); (d) DeepFM, DIN, Bert4Rec and
   DLRM (tables capped at 1M rows) at their widths, one train step each
   at 65,536 rows (Bert4Rec's MLM at 4,096) and the forward's ms at 512;
   GAT-cora 20 steps on a synthetic graph of Cora's shape (the loss
   falls), a ``graph_pool_loss`` step at the molecule shape and
   ``sample_block`` at minibatch_lg over a synthetic CSR of its 232,965
   nodes and 114,615,892 edges. ``--archs`` runs this phase alone.
17. launch (last, in the main process): ``repro_torch.launch.dryrun``'s
   meta check of the reference's dry-run test cells and the seven rpq cells
   on the 16×16 and 2×16×16 meshes (per-device argument bytes, matmul
   FLOPs), the seven rpq cells run for real at full width on the host mesh
   (``dryrun.card_record``: step ms, peak GiB, the kernels each launched,
   outputs finite and of the meta run's shapes), then the four example
   twins (``examples/{adaptive_routing,serve_ann,streaming}_torch.py
   --dry-run`` and ``train_rpq_e2e_torch`` at ``E2E_ARGS``, with one
   injected restart). ``--launch`` runs this phase alone.

Phases 5–17 each read every kernel's launch count around their own run.
The last three lines are the kernels JSON (each kernel's ``launches`` summed
over those counted runs; the int32 variants are rows of their own), the ``nvidia-smi`` line, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or run outside the repository, it exits non-zero and prints no
result. It imports nothing of JAX and nothing of the JAX package.

``--beam-round`` runs only the round kernels' rows (phase 3's last part,
~1 min with its nvcc builds) and prints them as JSON.
``--retrieval-us [--src DIR]`` runs none of this: it times phase 9's
per-query loop alone (``retrieval_us``) on seeded codes, with the
``repro_torch`` of ``DIR``, and prints one JSON line, so two trees (one
unpacked by ``git archive``) compare in one chip call. ``--adc-batch
[--src DIR]`` does the same for ``adc_scan_batch``'s diagnostic rows
(``adc_batch_rows``, each held bit for bit against its plain version).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores; bound_ms is the larger of bytes / HBM and ops / F32.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
# Nodes per batched Vamana insert round on the main path (the JAX default is
# 1024): 16x fewer sequential beam searches at 1M, and each is host-bound,
# so the build's time follows their count. The graph's exact-routed recall,
# checked below, shows what the staler batch costs.
VAMANA_BATCH = 16384
# Least recall@10 of the graph under exact-distance routing at h=32 (see
# main_path). An H100 read 0.7298 at 1M (batch 8192; 0.7193 at batch 1024)
# and 0.9996 at 100k; a graph that routes nowhere scores near 0.
MIN_EXACT_RECALL = 0.65
# Least exact-routed recall@10 at h=32 of phase 15's HNSW (from its
# descent) and NSG. Their builders are the reference's: exact kNN pruned
# with alpha = 1, which on this spec's well-separated clusters keeps no
# edge between two clusters. NSG is joined only through its repair's
# adoptions; HNSW's layers stay split by cluster, and at 1M its top layer
# holds about ten members a cluster, so the descent reaches the query's
# cluster only sometimes (an H100 read HNSW 0.0796 and NSG 0.4455 at 1M).
# The floors hold that each graph routes at all: a search that never
# leaves the entry's cluster scores about 1/200.
MIN_EXACT_RECALL_HNSW = 0.05
MIN_EXACT_RECALL_NSG = 0.3


def log(msg: str) -> None:
    # one write a message: phase 11's thread logs beside the main one
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


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


L2_BYTES = 50 * 2**20   # the H100's L2 cache


def rotating(fn, sets):
    """A no-argument call that runs ``fn(*sets[i % len(sets)])`` on its i-th
    call. Captured by :func:`graph_ms`, successive launches read different
    buffers, so a kernel whose inputs fit in L2 is timed reading them from
    HBM, as its bound assumes, and not from the L2 copy left by the call
    before."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def cold_copies(nbytes: float) -> int:
    """Input sets for :func:`rotating` such that one turn of the rotation
    touches at least twice the L2 (``nbytes``: what one call touches)."""
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


def touched_bytes(ids, row_bytes: int) -> int:
    """Bytes of the 32-byte sectors that gathering rows ``ids`` of
    ``row_bytes`` each reads."""
    import torch

    first = ids.long().flatten() * row_bytes // 32
    last = (ids.long().flatten() * row_bytes + row_bytes - 1) // 32
    return 32 * int(torch.unique(torch.cat([first, last])).numel())


def lut_sector_bytes(codes, ids, luts) -> int:
    """Bytes of the 32-byte sectors of the (Q, M, K) f32 ``luts`` that
    ``hop_adc(codes, ids, luts)`` reads: entry (q, j, codes[ids[q, i], j])
    of every lane and subspace, each sector once."""
    import torch

    q, m, k = luts.shape
    dev = luts.device
    entry = ((torch.arange(q, device=dev)[:, None, None] * m
              + torch.arange(m, device=dev)) * k + codes[ids.long()].long())
    return 32 * int(torch.unique(entry.flatten() // 8).numel())


def sector_bound(codes, ids, luts) -> float:
    """``hop_adc``'s bound in ms counted on its inputs, beside the row's
    bound (which reads every LUT entry and 16-byte rows): the ids, the
    32-byte sectors of the code rows and of the LUT entries they name, and
    the output, over the HBM rate."""
    nbytes = (8 * ids.numel() + touched_bytes(ids, codes.shape[1] * codes.element_size())
              + lut_sector_bytes(codes, ids, luts))
    return nbytes / HBM_BYTES_S * 1e3


def sector_note(row: dict) -> str:
    return (f", sector bound {row['sector_bound_ms']:.4f} ms (the 32-byte sectors these "
            "ids, rows and LUT entries touch)" if "sector_bound_ms" in row else "")


def l2_note(row: dict) -> str:
    return (f" (L2-cold over {row['cold_sets']} input sets; L2-warm "
            f"{row['l2_warm_ms']:.4f} ms)" if "l2_warm_ms" in row else "")


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


def library_time(codes, luts, want, *, graph: bool = False,
                 more: tuple = ()) -> tuple[float, float]:
    """Time of the one ``embedding_bag`` call that computes the same ADC
    function (CUDA events, or graph replay for the short rows, rotated over
    ``(codes, luts)`` and the further input sets ``more`` as the kernel's
    row is), and its max abs error against ``want`` on the first set (a
    yardstick only: not held to a tolerance, since its sum order on the
    card is the library's)."""
    import torch

    bags = [lut_bag(c, lt) for c, lt in ((codes, luts), *more)]
    call = lambda idx, w: torch.nn.functional.embedding_bag(idx, w, mode="sum")
    err = float((call(*bags[0]).reshape(want.shape) - want).abs().max())
    ms = (graph_ms(rotating(call, bags), iters=50) if graph
          else cuda_ms(lambda: call(*bags[0]), iters=3))
    return ms, err


def sm_clocks_per_ms() -> float:
    """SM clocks per millisecond on the whole card: its SM count times its
    maximum SM clock (``nvidia-smi``)."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e3


def smem_floor_ms(lookup_bytes: float) -> float:
    """Least time to read ``lookup_bytes`` from shared memory with no bank
    conflict: 128 bytes per clock per SM."""
    return lookup_bytes / 128 / sm_clocks_per_ms()


def lookup_floor_ms(codes, k: int) -> tuple[float, float]:
    """Least time of the one-query scan's shared-memory lookups on these
    codes, and the wavefronts a warp-wide lookup takes on average. A warp
    scores 32 consecutive rows; at each subspace its 32 lookups in one LUT
    row of ``k`` f32 entries take as many wavefronts (one per SM per clock)
    as the fullest of the 32 banks holds distinct entries (a word read by
    several lanes is broadcast)."""
    import torch

    n, m = codes.shape
    w = -(-n // 32)
    c = torch.zeros((w * 32, m), dtype=torch.long, device=codes.device)
    c[:n] = codes.long()
    fronts = 0
    for j in range(m):  # (warps, k) entries hit, then distinct entries per bank
        hit = torch.zeros((w, k), dtype=torch.bool, device=codes.device)
        hit.scatter_(1, c[:, j].view(w, 32), True)
        if n % 32:  # the last warp's idle lanes look nothing up
            hit[-1] = False
            hit[-1, codes[(w - 1) * 32:, j].long()] = True
        per_bank = hit.view(w, -1, 32).sum(dim=1)   # entry e sits in bank e % 32
        fronts += int(per_bank.max(dim=1).values.sum())
    return fronts / sm_clocks_per_ms(), fronts / (w * m)


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
    # rows one byte off 16 (the code-by-code path at M=16)
    flat16 = torch.empty(5004 * m + 1, dtype=torch.uint8, device=dev)
    flat16[1:] = ops.pad_sentinel_row(rand_codes(5003, m)).reshape(-1)
    cases.append((flat16[1:].view(5004, m), torch.randint(0, 5004, (37, 64), generator=g,
                                                          device=dev, dtype=torch.int32),
                  rand_luts(37, m), 0))
    for codes, ids, luts, mp in cases:
        want = (ref.hop_adc_ref(codes[:, :mp], ids, luts[:, :mp]) if mp
                else ref.hop_adc_ref(codes, ids, luts))
        note("hop_adc", compare(f"hop_adc N+1={codes.shape[0]} M={codes.shape[1]} "
                                f"Q={ids.shape[0]} R'={ids.shape[1]} m_prefix={mp}"
                                f"{' (unaligned rows)' if codes.data_ptr() % 16 else ''}",
                                ops.hop_adc(codes, ids, luts, m_prefix=mp), want,
                                rtol=0.0, atol=0.0))

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
    # L2-cold: rotate over fresh (ids, LUTs) sets past twice the L2
    sets = [(codes_p, ids, luts)] + [
        (codes_p, torch.randint(0, n_base + 1, ids.shape, generator=g, device=dev,
                                dtype=torch.int32), rand_luts(n_query, m))
        for _ in range(cold_copies(4 * luts.numel() + 8 * ids.numel()
                                   + touched_bytes(ids, m)) - 1)]
    kern = lambda c, i, lt: khop.launch(c, i, lt, m, hout)
    rows.append(dict(
        name="hop_adc", route="cuda", source="src/repro_torch/kernels/csrc/hop_adc.cu",
        replaces="src/repro/kernels/hop_adc.py:170",
        shape=f"codes ({n_base + 1},{m}) u8, ids ({n_query},64), luts ({n_query},{m},{k}) "
              "one beam round",
        max_abs_err=errs["hop_adc"], cold_sets=len(sets),
        ms=graph_ms(rotating(kern, sets), iters=200),
        l2_warm_ms=graph_ms(lambda: kern(*sets[0]), iters=200),
        plain_ms=graph_ms(rotating(ref.hop_adc_ref, sets), iters=50),
        issue_ms=cuda_ms(rotating(kern, sets), iters=200),
        bound_ms=b_ms, bound_by=b_by, sector_bound_ms=sector_bound(*sets[0]),
        library_ms=None, library_call=None))
    kern(*sets[0])
    note("hop_adc", compare(f"hop_adc N+1={n_base + 1} M={m} Q={n_query} R'=64 (the timed "
                            "output)", hout, ref.hop_adc_ref(*sets[0]), rtol=0.0, atol=0.0))
    rows[-1]["max_abs_err"] = errs["hop_adc"]
    del sets

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
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms{l2_note(row)}{issue}, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){sector_note(row)}{floor}")
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
    # L2-cold: the whole packed corpus (8 MB) fits in L2, so each set has
    # its own corpus, ids and LUTs, past twice the L2 in all
    sets = [(packed_p, ids, luts)] + [
        (ops.pad_sentinel_row(rand_packed(n_base, m)),
         torch.randint(0, n_base + 1, ids.shape, generator=g, device=dev,
                       dtype=torch.int32), rand_luts(n_query, m))
        for _ in range(cold_copies(luts.numel() + 8 * ids.numel()
                                   + touched_bytes(ids, mb)) - 1)]
    kern = lambda c, i, lt: khopfs.launch(c, i, lt, m, hout)
    rows.append(dict(
        name="hop_adc_fs", route="cuda", source="src/repro_torch/kernels/csrc/hop_adc_fs.cu",
        replaces="src/repro/kernels/hop_adc.py:254",
        shape=f"packed ({n_base + 1},{mb}) u8, ids ({n_query},64), luts "
              f"({n_query},{m},16) u8, one beam round",
        max_abs_err=errs["hop_adc_fs"], cold_sets=len(sets),
        ms=graph_ms(rotating(kern, sets), iters=200),
        l2_warm_ms=graph_ms(lambda: kern(*sets[0]), iters=200),
        plain_ms=graph_ms(rotating(ref.hop_adc_fs_acc, sets), iters=50),
        issue_ms=cuda_ms(rotating(kern, sets), iters=200),
        floor_ms=graph_ms(lambda: khopfs.launch_empty(*ids.shape), iters=200),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=None))
    del sets

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
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms{l2_note(row)}{extra}, "
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
    flat = torch.empty(4099 * m + 1, dtype=torch.uint8, device=dev)
    flat[1:] = rand_codes((4099, m)).reshape(-1)
    for codes, lut in ((codes_full, lut_full), (rand_codes((4099, m)), rand_lut((m, k))),
                       (rand_codes((3001, 7)), rand_lut((7, k))),
                       (rand_codes((777, m), 16), rand_lut((m, 16))),
                       (rand_codes((1, m)), rand_lut((m, k))),
                       (rand_codes((2049, 32)), rand_lut((32, k))),
                       (flat[1:].view(4099, m), rand_lut((m, k)))):
        name = (f"adc_scan N={codes.shape[0]} M={codes.shape[1]} K={lut.shape[1]}"
                f"{' (unaligned rows)' if codes.data_ptr() % 16 else ''}")
        got = ops.adc_scan(codes, lut)
        note("adc_scan", compare(name, got, ref.adc_scan_ref(codes, lut),
                                 rtol=0.0, atol=0.0))
        compare(f"{name} vs adc_scan_batch row", got,
                ops.adc_scan_batch(codes, lut[None])[0], rtol=0.0, atol=0.0)

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

    # its bound, counted from kernels/ops.pq_pairwise_backward: x, codebooks
    # and the upstream gradient read once, both gradients written once; two
    # batched products of 2·N·M·K·dsub, the sums over k and over n, and the
    # elementwise terms
    bw_bytes = 4 * (2 * x.numel() + 2 * cb.numel() + up.numel())
    bw_ops = (4 * n_step * m * k * dsub + 2 * n_step * m * k + 3 * x.numel()
              + 3 * cb.numel())
    bw_bound, bw_by = bound(bw_bytes, bw_ops)
    backward = dict(shape=f"({n_step},{m},{dsub})x({m},{k},{dsub}) default train step",
                    max_abs_err=grad_err,
                    ms=cuda_ms(lambda: ops.pq_pairwise_backward(x, cb, up), iters=20),
                    plain_autograd_ms=cuda_ms(plain_backward, iters=10),
                    bound_ms=bw_bound, bound_by=bw_by)
    log(f"[time] pq_pairwise backward {backward['shape']}: PyTorch products "
        f"{backward['ms']:.4f} ms, autograd of the plain version "
        f"{backward['plain_autograd_ms']:.4f} ms; bound {bw_bound:.4f} ms ({bw_by}: "
        f"{bw_bytes / 1e6:.1f} MB, {bw_ops / 1e9:.3f} GFLOP)")

    # ---- times at the main path's shapes (kernel: CUDA-graph replay) ----
    rows = []
    sout = torch.empty((n_base,), device=dev)
    b_ms, b_by = bound(codes_full.numel() + 4 * lut_full.numel() + 4 * sout.numel(),
                       codes_full.numel())
    # L2-cold: the 16 MB corpus fits in L2; rotate over corpora
    sets = [(codes_full, lut_full)] + [
        (rand_codes((n_base, m)), rand_lut((m, k)))
        for _ in range(cold_copies(codes_full.numel() + 4 * n_base) - 1)]
    kern = lambda c, lt: kadc.launch_query(c, lt, sout)
    rows.append(dict(
        name="adc_scan", route="cuda", source="src/repro_torch/kernels/csrc/adc_scan.cu",
        replaces="src/repro/kernels/adc_scan.py:74",
        shape=f"codes ({n_base},{m}) u8 x lut ({m},{k}), one query",
        max_abs_err=errs["adc_scan"], cold_sets=len(sets),
        ms=graph_ms(rotating(kern, sets), iters=100),
        l2_warm_ms=graph_ms(lambda: kern(*sets[0]), iters=100),
        plain_ms=cuda_ms(rotating(ref.adc_scan_ref, sets), iters=10),
        issue_ms=cuda_ms(rotating(kern, sets), iters=100),
        bound_ms=b_ms, bound_by=b_by, library_call=LIBRARY_CALL))
    want = ref.adc_scan_ref(codes_full, lut_full)
    kern(codes_full, lut_full)
    note("adc_scan", compare(f"adc_scan N={n_base} M={m} K={k} (the timed output)", sout,
                             want, rtol=0.0, atol=0.0))
    rows[-1]["max_abs_err"] = errs["adc_scan"]
    rows[-1]["smem_floor_ms"], rows[-1]["wavefronts_per_lookup"] = lookup_floor_ms(
        codes_full, k)
    rows[-1]["library_ms"], rows[-1]["library_err"] = library_time(
        codes_full, lut_full, want, graph=True, more=sets[1:])
    del sets, want

    _, ids, luts = cases[0]
    rows_g = codes_p[ids.long()]
    gout = torch.empty(ids.shape, device=dev)
    b_ms, b_by = bound(rows_g.numel() + 4 * luts.numel() + 4 * gout.numel(), rows_g.numel())
    sets = [(rows_g, luts)] + [
        (rand_codes(rows_g.shape), rand_lut(luts.shape))
        for _ in range(cold_copies(rows_g.numel() + 4 * luts.numel() + 4 * gout.numel()) - 1)]
    kern = lambda c, lt: khopg.launch(c, lt, gout)
    rows.append(dict(
        name="hop_gather", route="cuda", source="src/repro_torch/kernels/csrc/hop_gather.cu",
        replaces="src/repro/kernels/hop_gather.py:55",
        shape=f"codes ({n_query},64,{m}) u8 x luts ({n_query},{m},{k}), one beam round",
        max_abs_err=errs["hop_gather"], cold_sets=len(sets),
        ms=graph_ms(rotating(kern, sets), iters=200),
        l2_warm_ms=graph_ms(lambda: kern(*sets[0]), iters=200),
        plain_ms=graph_ms(rotating(ref.hop_gather_ref, sets), iters=50),
        issue_ms=cuda_ms(rotating(kern, sets), iters=200),
        bound_ms=b_ms, bound_by=b_by, library_call=LIBRARY_CALL))
    rows[-1]["library_ms"], rows[-1]["library_err"] = library_time(
        rows_g, luts, ref.hop_gather_ref(rows_g, luts), graph=True, more=sets[1:])
    del sets
    for row in rows:
        floor = (f", shared-memory floor {row['smem_floor_ms']:.4f} ms (bank conflicts "
                 f"of these codes: {row['wavefronts_per_lookup']:.3f} wavefronts per "
                 "warp-wide lookup)" if "smem_floor_ms" in row else "")
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms{l2_note(row)} "
            f"(back-to-back launches from the host: {row['issue_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){floor}")
    return {row["name"]: row for row in rows}, backward


def wide_parity_and_timing(n_base: int, n_query: int) -> dict:
    """Phase 3 for the int32-code variants (K > 256, fault C1) and for the
    subspace chunking past shared memory (fault C2): each int32 variant at
    K=512 against its plain version (``adc_scan_batch`` bit for bit, the
    others at rtol 1e-5, atol 1e-4), the chunked edge shapes (M=64, K=1024
    in f32 on int32 codes; M=208, K=256 on uint8 codes; fs4 at M=128,
    exactly), then the four int32 variants at the main path's N, Q and
    M=16, K=512: each timed output against its plain version, and the
    times beside their bounds, plain versions and library calls, with
    ``adc_scan_batch_i32``'s planned HBM bytes and diagnostic rows."""
    import torch

    from repro_torch.kernels import adc_scan as kadc
    from repro_torch.kernels import adc_scan_fs as kadcfs
    from repro_torch.kernels import hop_adc as khop
    from repro_torch.kernels import hop_gather as khopg
    from repro_torch.kernels import ops, ref
    from repro_torch.pq import pack

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(97531)
    m, k = 16, 512
    errs = {"adc_scan_batch_i32": 0.0, "adc_scan_i32": 0.0, "hop_adc_i32": 0.0,
            "hop_gather_i32": 0.0}

    def note(kernel, e):
        errs[kernel] = max(errs[kernel], e)

    def rand_codes(shape, kk, dtype=torch.int32):
        return torch.randint(0, kk, shape, generator=g, device=dev,
                             dtype=torch.int32).to(dtype)

    def rand_lut(shape):
        return torch.rand(shape, generator=g, device=dev) * 20.0

    def all_four(tag, codes, luts, ids, kernel_suffix):
        """The four entry points on one (codes, LUTs, ids) set."""
        sfx = kernel_suffix
        got = ops.adc_scan_batch(codes, luts)
        e = compare(f"adc_scan_batch{sfx} {tag}", got, ref.adc_scan_batch_ref(codes, luts),
                    rtol=0.0, atol=0.0)
        if sfx:
            note("adc_scan_batch_i32", e)
        e = compare(f"adc_scan{sfx} {tag}", ops.adc_scan(codes, luts[0]),
                    ref.adc_scan_ref(codes, luts[0]), rtol=0.0, atol=0.0)
        if sfx:
            note("adc_scan_i32", e)
        for mp in (0, codes.shape[1] // 2 + 1):
            want = (ref.hop_adc_ref(codes[:, :mp], ids, luts[:, :mp]) if mp
                    else ref.hop_adc_ref(codes, ids, luts))
            e = compare(f"hop_adc{sfx} {tag} m_prefix={mp}",
                        ops.hop_adc(codes, ids, luts, m_prefix=mp), want,
                        rtol=0.0, atol=0.0)
            if sfx:
                note("hop_adc_i32", e)
        rows = codes[ids.long()]
        e = compare(f"hop_gather{sfx} {tag}", ops.hop_gather(rows, luts),
                    ref.hop_gather_ref(rows, luts), rtol=1e-5, atol=1e-4)
        if sfx:
            note("hop_gather_i32", e)

    # int32 codes: K=512 (the reference's own K > 256 case, N=600, M=4, and
    # the main path's M=16), then M=64, K=1024 (a 256 KB LUT, two chunks);
    # uint8 codes at M=208, K=256 (208 KB, two chunks)
    for n, mm, kk, q in ((600, 4, 512, 3), (4099, m, k, 13), (3001, 64, 1024, 5)):
        codes = rand_codes((n, mm), kk)
        ids = torch.randint(0, n, (q, 64), generator=g, device=dev, dtype=torch.int32)
        all_four(f"N={n} M={mm} K={kk} Q={q} (int32 codes, "
                 f"{len(khop.subspace_chunks(mm, kk))} chunk(s))",
                 codes, rand_lut((q, mm, kk)), ids, "_i32")
    codes = rand_codes((2049, 208), 256, torch.uint8)
    ids = torch.randint(0, 2049, (7, 64), generator=g, device=dev, dtype=torch.int32)
    all_four("N=2049 M=208 K=256 Q=7 (uint8 codes, 2 chunks)", codes,
             rand_lut((7, 208, 256)), ids, "")
    # fs4 at M=128: the paired table passes 200 KB, two byte chunks, exact
    for n, mm, q in ((3001, 128, 9), (4099, 201, 13)):
        packed = pack.pack_codes(rand_codes((n, mm), 16))
        luts = rand_codes((q, mm, 16), 256, torch.uint8)
        compare(f"adc_scan_fs N={n} M={mm} Q={q} ({len(kadcfs.byte_chunks(packed.shape[1]))} "
                f"byte chunks)", kadcfs.adc_scan_fs(packed, luts).double(),
                ref.adc_scan_fs_acc(packed, luts).double(), rtol=0.0, atol=0.0)

    # ---- the int32 variants at the main path's shapes: held against their
    # plain versions on the timed inputs, then timed (the short ones by
    # graph replay, L2-cold: rotated over fresh input sets) ----
    codes_full = rand_codes((n_base, m), k)
    codes_p = ops.pad_sentinel_row(codes_full)
    luts = rand_lut((n_query, m, k))
    ids = torch.randint(0, n_base + 1, (n_query, 64), generator=g, device=dev,
                        dtype=torch.int32)
    rows = []
    aout = torch.empty((n_query, n_base), device=dev)
    b_ms, b_by = bound(4 * codes_full.numel() + 4 * luts.numel() + 4 * aout.numel(),
                       aout.numel() * m)
    ms = cuda_ms(lambda: kadc.launch(codes_full, luts, aout), iters=5)
    want = ref.adc_scan_batch_ref(codes_full, luts)
    note("adc_scan_batch_i32", compare(
        f"adc_scan_batch_i32 N={n_base} M={m} K={k} Q={n_query} (the timed output)",
        aout, want, rtol=0.0, atol=0.0))
    del aout
    plain_ms = cuda_ms(lambda: ref.adc_scan_batch_ref(codes_full, luts), iters=2, warmup=1)
    lib_ms, lib_err = library_time(codes_full, luts, want.T)
    del want
    hbm = adc_batch_i32_bytes(n_base, n_query, m, k)
    log(f"[time] adc_scan_batch_i32 HBM bytes its plan should move at N={n_base}: int32 "
        f"codes read once {hbm['codes']}, packed codes written and read once "
        f"{hbm['packed']} each, LUTs staged {hbm['lut_stages']} times {hbm['luts']} (from "
        f"L2 where they stay), output {hbm['out']}: {hbm['total'] / HBM_BYTES_S * 1e3:.4f} "
        f"ms at 3.35 TB/s, beside the bound {b_ms:.4f} ms (each input read once)")
    diagnostics = adc_batch_rows(n_query)
    rows.append(dict(
        name="adc_scan_batch_i32", route="cuda", source="src/repro_torch/kernels/csrc/adc_scan.cu",
        replaces="src/repro/kernels/adc_scan.py:131",
        shape=f"codes ({n_base},{m}) int32 x luts ({n_query},{m},{k})",
        max_abs_err=max(errs["adc_scan_batch_i32"],
                        *(r["max_abs_err"] for r in diagnostics if r["codes"] == "int32")),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library_err=lib_err, library_call=LIBRARY_CALL, hbm_bytes=hbm,
        diagnostics=diagnostics))

    hout = torch.empty(ids.shape, device=dev)
    distinct = int(torch.unique(ids).numel())
    b_ms, b_by = bound(4 * ids.numel() + 4 * distinct * m + 4 * luts.numel() + 4 * ids.numel(),
                       ids.numel() * m)
    sets = [(codes_p, ids, luts)] + [
        (codes_p, torch.randint(0, n_base + 1, ids.shape, generator=g, device=dev,
                                dtype=torch.int32), rand_lut(luts.shape))
        for _ in range(cold_copies(4 * luts.numel() + 8 * ids.numel()
                                   + touched_bytes(ids, 4 * m)) - 1)]
    kern = lambda c, i, lt: khop.launch(c, i, lt, m, hout)
    row = dict(
        name="hop_adc_i32", route="cuda", source="src/repro_torch/kernels/csrc/hop_adc.cu",
        replaces="src/repro/kernels/hop_adc.py:170",
        shape=f"codes ({n_base + 1},{m}) int32, ids ({n_query},64), luts ({n_query},{m},{k})",
        cold_sets=len(sets), l2_warm_ms=graph_ms(lambda: kern(*sets[0]), iters=200))
    note("hop_adc_i32", compare(f"hop_adc_i32 N+1={n_base + 1} M={m} K={k} Q={n_query} "
                                "R'=64 (the timed output)", hout,
                                ref.hop_adc_ref(codes_p, ids, luts), rtol=0.0, atol=0.0))
    row.update(ms=graph_ms(rotating(kern, sets), iters=200),
               plain_ms=graph_ms(rotating(ref.hop_adc_ref, sets), iters=50),
               bound_ms=b_ms, bound_by=b_by, sector_bound_ms=sector_bound(*sets[0]),
               library_ms=None, library_call=None)
    rows.append(row)
    del sets

    sout = torch.empty((n_base,), device=dev)
    b_ms, b_by = bound(4 * codes_full.numel() + 4 * luts[0].numel() + 4 * sout.numel(),
                       codes_full.numel())
    sets = [(codes_full, luts[0])] + [
        (rand_codes((n_base, m), k), rand_lut((m, k)))
        for _ in range(cold_copies(4 * codes_full.numel() + 4 * n_base) - 1)]
    kern = lambda c, lt: kadc.launch_query(c, lt, sout)
    row = dict(
        name="adc_scan_i32", route="cuda", source="src/repro_torch/kernels/csrc/adc_scan.cu",
        replaces="src/repro/kernels/adc_scan.py:74",
        shape=f"codes ({n_base},{m}) int32 x lut ({m},{k}), one query",
        cold_sets=len(sets), l2_warm_ms=graph_ms(lambda: kern(*sets[0]), iters=100))
    want = ref.adc_scan_ref(codes_full, luts[0])
    note("adc_scan_i32", compare(f"adc_scan_i32 N={n_base} M={m} K={k} (the timed output)",
                                 sout, want, rtol=0.0, atol=0.0))
    row.update(ms=graph_ms(rotating(kern, sets), iters=100),
               plain_ms=cuda_ms(rotating(ref.adc_scan_ref, sets), iters=10),
               bound_ms=b_ms, bound_by=b_by, library_call=LIBRARY_CALL)
    row["library_ms"], row["library_err"] = library_time(
        codes_full, luts[0], want, graph=True, more=sets[1:])
    rows.append(row)
    del sets, want

    rows_g = codes_p[ids.long()]
    gout = torch.empty(ids.shape, device=dev)
    b_ms, b_by = bound(4 * rows_g.numel() + 4 * luts.numel() + 4 * gout.numel(),
                       rows_g.numel())
    sets = [(rows_g, luts)] + [
        (rand_codes(rows_g.shape, k), rand_lut(luts.shape))
        for _ in range(cold_copies(4 * rows_g.numel() + 4 * luts.numel()
                                   + 4 * gout.numel()) - 1)]
    kern = lambda c, lt: khopg.launch(c, lt, gout)
    row = dict(
        name="hop_gather_i32", route="cuda", source="src/repro_torch/kernels/csrc/hop_gather.cu",
        replaces="src/repro/kernels/hop_gather.py:55",
        shape=f"codes ({n_query},64,{m}) int32 x luts ({n_query},{m},{k}), one beam round",
        cold_sets=len(sets), l2_warm_ms=graph_ms(lambda: kern(*sets[0]), iters=200))
    want = ref.hop_gather_ref(rows_g, luts)
    note("hop_gather_i32", compare(f"hop_gather_i32 Q={n_query} R=64 M={m} K={k} "
                                   "(the timed output)", gout, want, rtol=1e-5, atol=1e-4))
    row.update(ms=graph_ms(rotating(kern, sets), iters=200),
               plain_ms=graph_ms(rotating(ref.hop_gather_ref, sets), iters=50),
               bound_ms=b_ms, bound_by=b_by, library_call=LIBRARY_CALL)
    row["library_ms"], row["library_err"] = library_time(
        rows_g, luts, want, graph=True, more=sets[1:])
    rows.append(row)
    del sets, want
    for row in rows:
        row["max_abs_err"] = errs[row["name"]]
    for row in rows:
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms{l2_note(row)}, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){sector_note(row)}")
    return {row["name"]: row for row in rows}


# The classic beam round's kernels at the benchmark's widths (phase 3 and
# --beam-round): lanes, beam slots, degree, rounds run before the timed ones
# and rounds timed.
ROUND_LANES, ROUND_H, ROUND_R = 10_000, 96, 64
ROUND_WARM, ROUND_TIMED = 20, 10


def round_state(nbrs, entry, luts, dist_fn, h: int, rounds: int) -> dict:
    """The beam state of ``beam.beam_search`` (single entry, no knobs) after
    ``rounds`` classic rounds, built with the round's entry points."""
    import torch

    from repro_torch.kernels import ops, ref

    dev, (n, _), q = nbrs.device, nbrs.shape, entry.shape[0]
    st = dict(ids=torch.full((q, h), n, dtype=torch.int64, device=dev),
              dists=torch.full((q, h), float("inf"), device=dev),
              exp=torch.ones((q, h), dtype=torch.bool, device=dev),
              live=torch.ones(q, dtype=torch.bool, device=dev),
              visited=torch.zeros((q, (n + 31) // 32 + 1), dtype=torch.int32, device=dev),
              hops=torch.zeros(q, dtype=torch.int32, device=dev),
              ndist=torch.ones(q, dtype=torch.int32, device=dev),
              step=torch.zeros(q, dtype=torch.int32, device=dev),
              count=torch.zeros((), dtype=torch.int32, device=dev), n=n)
    st["ids"][:, 0] = entry
    st["dists"][:, 0] = dist_fn(luts, entry[:, None])[:, 0]
    st["exp"][:, 0] = False
    ref.scatter_bits_(st["visited"], entry[:, None].long(),
                      torch.ones((q, 1), dtype=torch.bool, device=dev))
    for _ in range(rounds):
        expand_once(ops.beam_expand, nbrs, st)
        merge_once(ops.beam_merge, st, *st["last"], dist_fn(luts, st["last"][0]))
    return st


def expand_once(fn, nbrs, st):
    st["last"] = fn(nbrs, st["ids"], st["dists"], st["exp"], st["live"], st["visited"],
                    st["hops"], st["ndist"], st["count"])
    return st["last"]


def merge_once(fn, st, front, fresh, front_d):
    return fn(st["ids"], st["dists"], st["exp"], front, fresh, front_d, st["live"],
              st["step"], st["ndist"], st["count"], n=st["n"], max_steps=1 << 30)


def captured_ms(calls, restore, reps: int = 3) -> tuple[float, list]:
    """Device ms of one of ``calls`` (a list of no-argument calls, captured
    into one CUDA graph), each replay starting from ``restore()`` (outside
    the events): the median over ``reps`` replays, and the outputs of the
    last."""
    import torch

    restore()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    times = []
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times), outs


def beam_round_rows(n_base: int, n_query: int = ROUND_LANES, h: int = ROUND_H,
                    r: int = ROUND_R) -> dict:
    """The classic beam round's two kernels (``csrc/beam_round.cu``) on a
    random graph of ``n_base`` vertices and degree ``r`` (a tenth of the
    slots the sentinel), u8 codes (M=16, K=256) and random LUTs, ``n_query``
    lanes at beam width ``h``. First one whole ``beam_search`` through the
    kernels and through their plain versions (``ops.beam_expand`` /
    ``ops.beam_merge`` swapped for ``ref.beam_expand_ref`` /
    ``ref.beam_merge_ref``): bit for bit equal, the kernels launched once a
    round, the host's ms a round on each route. Then each kernel over
    ROUND_TIMED successive rounds from the state after ROUND_WARM rounds,
    captured in one CUDA graph and replayed from a restored state, beside
    its plain version likewise; the end states and every timed output of
    the two must be equal. Bounds: bytes, counted on the timed rounds
    (``beam_expand``: each lane's beam dists and flags, its beam id and
    adjacency row, two 32-byte sectors a fresh id for the visited test and
    its atomic, the frontier out; ``beam_merge``: the beam read and written
    back, the frontier and the distances read)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.search import beam

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    m, k = 16, 256
    nbrs = torch.randint(0, n_base, (n_base, r), generator=g, device=dev, dtype=torch.int32)
    nbrs[torch.rand((n_base, r), generator=g, device=dev) < 0.1] = n_base
    codes = ops.pad_sentinel_row(torch.randint(0, k, (n_base, m), generator=g, device=dev,
                                               dtype=torch.int32).to(torch.uint8))
    luts = torch.rand((n_query, m, k), generator=g, device=dev) * 20.0
    entry = torch.randint(0, n_base, (n_query,), generator=g, device=dev)
    fn = beam.make_adc_dist_fn(codes)
    plain = {ops.beam_expand: ref.beam_expand_ref, ops.beam_merge: ref.beam_merge_ref}

    @contextlib.contextmanager
    def plain_round():
        saved = ops.beam_expand, ops.beam_merge
        ops.beam_expand, ops.beam_merge = ref.beam_expand_ref, ref.beam_merge_ref
        try:
            yield
        finally:
            ops.beam_expand, ops.beam_merge = saved

    def search():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = beam.beam_search(nbrs, entry, luts, fn, h=h)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    search()                                       # builds and warms
    ops.reset_launch_counts()
    got, s_kern = search()
    launches = ops.launch_counts()
    with plain_round():
        search()
        want, s_plain = search()
    fields = ("ids", "dists", "hops", "n_dist", "rounds", "truncated")
    check(all(torch.equal(bits(getattr(got, f)), bits(getattr(want, f))) for f in fields),
          "beam_search through the round kernels equals the op chain bit for bit")
    rounds = int(got.rounds.max())
    check(launches["beam_expand"] == launches["beam_merge"] == rounds,
          f"one launch of each round kernel a round ({launches})")
    log(f"[round] beam_search Q={n_query} h={h} R={r} over {n_base} vertices: {rounds} rounds, "
        f"equal to the op chain bit for bit; host {1e3 * s_kern / rounds:.4f} ms a round "
        f"through the kernels, {1e3 * s_plain / rounds:.4f} through the op chain; "
        f"launches {launches['beam_expand']} + {launches['beam_merge']}")

    st = round_state(nbrs, entry, luts, fn, h, ROUND_WARM)
    names = ("ids", "dists", "exp", "live", "visited", "hops", "ndist", "step")
    snap = {name: st[name].clone() for name in names}

    def restore():
        for name in names:
            st[name].copy_(snap[name])

    def end_state():
        return {name: st[name].clone() for name in names}

    rows, timed = [], {}
    for route, expand in (("kernel", ops.beam_expand), ("plain", plain[ops.beam_expand])):
        ms, outs = captured_ms([lambda e=expand: expand_once(e, nbrs, st)] * ROUND_TIMED, restore)
        timed[route] = (ms, [torch.cat([f.to(torch.int32)[None], s.to(torch.int32)[None]])
                             for f, s in outs], end_state())
    same = (all(torch.equal(a, b) for a, b in zip(timed["kernel"][1], timed["plain"][1]))
            and all(torch.equal(timed["kernel"][2][n], timed["plain"][2][n]) for n in names))
    check(same, "beam_expand's timed outputs and end state equal its plain version's")
    fresh_ids = sum(int(o[1].sum()) for o in timed["kernel"][1])
    nbytes = (ROUND_TIMED * n_query * (5 * h + 8 + 4 * r + 5 * r + 9) + 64 * fresh_ids) / ROUND_TIMED
    b_ms, b_by = bound(nbytes, 0)
    rows.append(dict(name="beam_expand", route="cuda",
                     source="src/repro_torch/kernels/csrc/beam_round.cu",
                     replaces="none: the beam's op chain",
                     shape=f"Q={n_query} h={h} R={r}, graph {n_base} x {r}",
                     ms=timed["kernel"][0], plain_ms=timed["plain"][0], bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, library_call=None,
                     max_abs_err=0.0, launches=launches["beam_expand"],
                     search_ms_a_round=1e3 * s_kern / rounds,
                     plain_search_ms_a_round=1e3 * s_plain / rounds))

    restore()
    front, fresh = expand_once(ops.beam_expand, nbrs, st)
    front_d = fn(luts, front)
    snap = {name: st[name].clone() for name in names}
    timed = {}
    for route, merge in (("kernel", ops.beam_merge), ("plain", plain[ops.beam_merge])):
        ms, _ = captured_ms([lambda mg=merge: merge_once(mg, st, front, fresh, front_d)]
                            * ROUND_TIMED, restore)
        timed[route] = (ms, end_state())
    check(all(torch.equal(bits(timed["kernel"][1][n]), bits(timed["plain"][1][n]))
              for n in names), "beam_merge's end state equals its plain version's")
    b_ms, b_by = bound(n_query * (2 * 13 * h + 9 * r + 13), 0)
    rows.append(dict(name="beam_merge", route="cuda",
                     source="src/repro_torch/kernels/csrc/beam_round.cu",
                     replaces="none: the beam's op chain",
                     shape=f"Q={n_query} h={h} R={r}",
                     ms=timed["kernel"][0], plain_ms=timed["plain"][0], bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, library_call=None,
                     max_abs_err=0.0, launches=launches["beam_merge"]))
    for row in rows:
        log(f"[time] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms (one round, "
            f"graph replay of {ROUND_TIMED} rounds), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), equal to the plain version")
    return {row["name"]: row for row in rows}


# adc_scan_batch's diagnostic rows at Q=1000, M=16: (case, N, K, code type).
# (a) int32 at K=512 with the code table in L2 (6.4 and 16 MB) and past it
# (64 MB); (b) int32 against uint8 codes at K=256, one query tile size (8);
# (c) int32 at K=256 (8 queries a tile) against K=512 (4); then the
# streaming round's delta arm, 1000 queries against 50,000 slots at K=512.
ADC_BATCH_CASES = (
    ("(a) int32 K=512", 100_000, 512, "int32"),
    ("(a) int32 K=512", 250_000, 512, "int32"),
    ("(a) int32 K=512", 1_000_000, 512, "int32"),
    ("(b) uint8 K=256", 1_000_000, 256, "uint8"),
    ("(b) int32 K=256", 1_000_000, 256, "int32"),
    ("(b) uint8 K=256", 250_000, 256, "uint8"),
    ("(c) int32 K=256", 250_000, 256, "int32"),
    ("delta int32 K=512", 50_000, 512, "int32"),
)


def adc_batch_i32_bytes(n: int, q: int, m: int, k: int) -> dict:
    """HBM bytes ``adc_scan_batch`` on (n, m) int32 codes and (q, m, k) LUTs
    should move as its plan goes (``kernels/adc_scan.py``): the int32 codes
    read once by the packing, the packed uint16 codes written once and read
    once (their re-reads, one per query tile, from L2), each block's tile
    LUTs staged once per tile (an upper bound: the 32 MB of LUTs at 1000 x
    K=512 may stay in L2), and the (q, n) f32 output. One 768-thread block
    per SM: a 4-query tile takes 128 KB of the SM's 228 KB."""
    import torch

    from repro_torch.kernels import adc_scan as kadc

    tq = kadc.query_tile(m, k)
    tile_bytes = tq * m * k * 4
    per_sm = max(1, min(2048 // kadc.BATCH_THREADS, (228 * 1024) // (tile_bytes + 1024)))
    blocks = kadc.grid_blocks(n, q, tq, torch.cuda.get_device_properties(0)
                              .multi_processor_count * per_sm)
    stages = kadc.lut_stages(n, q, tq, blocks)
    out = dict(codes=n * m * 4, packed=kadc.packed_bytes(n, m), lut_stages=stages,
               luts=stages * tile_bytes, out=4 * q * n)
    out["total"] = out["codes"] + 2 * out["packed"] + out["luts"] + out["out"]
    return out


def adc_batch_rows(n_query: int = 1000, cases=ADC_BATCH_CASES, seed: int = 24680) -> list:
    """``adc_scan_batch`` (the bare launch) on seeded uniform codes and
    LUTs for each of ``cases``: its CUDA-event time over back-to-back
    launches (each writes a (Q, N) output past the L2), the time per
    thousand (query, row) pairs, and its bound; each timed output is held
    against the plain version bit for bit."""
    import torch

    from repro_torch.kernels import adc_scan as kadc
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for case, n, k, dtype in cases:
        m = 16
        codes = torch.randint(0, k, (n, m), generator=g, device="cuda",
                              dtype=torch.int32).to(getattr(torch, dtype))
        luts = torch.rand((n_query, m, k), generator=g, device="cuda") * 20.0
        out = torch.empty((n_query, n), device="cuda")
        ms = cuda_ms(lambda: kadc.launch(codes, luts, out), iters=max(5, 5_000_000 // n))
        err = compare(f"adc_scan_batch {case} N={n} Q={n_query} (the timed output)", out,
                      ref.adc_scan_batch_ref(codes, luts), rtol=0.0, atol=0.0)
        b_ms, b_by = bound(codes.numel() * codes.element_size() + 4 * luts.numel()
                           + 4 * out.numel(), out.numel() * m)
        rows.append(dict(case=case, n=n, q=n_query, m=m, k=k, codes=dtype,
                         query_tile=kadc.query_tile(m, k), ms=ms,
                         ns_per_1000_pairs=ms * 1e9 / (n * n_query), bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err))
        log(f"[adc-batch] {case} N={n} Q={n_query}: {ms:.4f} ms, "
            f"{rows[-1]['ns_per_1000_pairs']:.4f} ns per 1000 (query, row) pairs, bound "
            f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it")
        del codes, luts, out
    return rows


# --------------------------------------------------------------------------
# phase 4: the slice on a small input, card vs CPU
# --------------------------------------------------------------------------

def rows_identical(a, b) -> float:
    """Share of rows of two (N, R) adjacencies with the same neighbour
    set (``b`` may lie on another device)."""
    import torch

    return float(torch.mean(torch.tensor(
        [set(x.tolist()) == set(y.tolist()) for x, y in zip(a.cpu(), b.cpu())],
        dtype=torch.float32)))


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
    same_rows = rows_identical(g_cpu.neighbors, g_gpu.neighbors)
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
    small_sharded(cpu, m_cpu, codes_cpu)
    small_pgraphs(cpu, m_cpu, codes_cpu)


def small_sharded(cpu, m_cpu, codes_cpu) -> None:
    """Phase 4 at S=4: one partition built on the CPU, the graph-routed and
    the scan engines served from it on the card and on the CPU (the plain
    versions) with the same LUTs, in both layouts; every result equal bit
    for bit."""
    import torch

    from repro_torch.graphs.partition import build_partitioned_vamana
    from repro_torch.pq import base, pack, train_pq_fs4
    from repro_torch.search.engine import ShardedEngine, ShardedGraphEngine

    pg = build_partitioned_vamana(cpu.base, SHARDS, generator=torch.Generator().manual_seed(2),
                                  r=16, l=32, device="cpu")
    m4 = train_pq_fs4(cpu.train, 8, generator=torch.Generator().manual_seed(3), iters=8,
                      device="cpu")
    luts = {"u8": base.build_lut(m_cpu, cpu.queries),
            "fs4": base.build_lut(m4, cpu.queries, quantize=True)}
    codes = {"u8": codes_cpu, "fs4": pack.pack_codes(base.encode(m4, cpu.base))}
    on_card = lambda lut: (lut.cuda() if isinstance(lut, torch.Tensor)
                           else type(lut)(*(t.cuda() for t in lut)))
    same = {}
    for lay in ("u8", "fs4"):
        for kw in ({}, {"entries": 4, "prune_eps": 0.2}, {"max_rounds": 3, "expand": 2}):
            res = [ShardedGraphEngine(pg, codes[lay], (lambda lut: lambda _: lut)(lut),
                                      device=dev, n_shards=SHARDS).search(
                       cpu.queries, k=10, h=32, **kw)
                   for dev, lut in (("cpu", luts[lay]), ("cuda", on_card(luts[lay])))]
            same[f"graph {lay} {kw}"] = same_search(*res)
        scan = [ShardedEngine(codes[lay], (lambda lut: lambda _: lut)(lut), device=dev,
                              n_shards=SHARDS).search(cpu.queries, k=10)
                for dev, lut in (("cpu", luts[lay]), ("cuda", on_card(luts[lay])))]
        same[f"scan {lay}"] = same_search(*scan)
    log(f"[small] S={SHARDS} partition, card vs CPU bit for bit: {same}")
    check(all(same.values()), "a sharded engine on the card disagrees with the CPU")


def small_pgraphs(cpu, m_cpu, codes_cpu) -> None:
    """Phase 4's other graphs and Catalyst: the unit-test dataset's HNSW
    (m=8) and NSG (r=16, k=24, search_l=24) built on the card and on the
    CPU from the same draws, HNSW descent and an ``entry_fn`` search on
    both, and a small Catalyst served on both."""
    import torch

    from repro_torch.graphs import build_hnsw, build_nsg, descend
    from repro_torch.pq import base
    from repro_torch.pq import catalyst
    from repro_torch.search.engine import InMemoryEngine

    q = cpu.queries
    hs = {dev: build_hnsw(cpu.base, generator=torch.Generator().manual_seed(2), m=8,
                          device=dev) for dev in ("cpu", "cuda")}
    h_rows = min([rows_identical(hs["cpu"].base.neighbors, hs["cuda"].base.neighbors)]
                 + [rows_identical(a.neighbors, b.neighbors)
                    for a, b in zip(hs["cpu"].layers, hs["cuda"].layers)])
    same_members = all(torch.equal(a, b.cpu()) for a, b in
                       zip(hs["cpu"].members, hs["cuda"].members))
    ents = {dev: descend(h, q.to(dev), cpu.base.to(dev)) for dev, h in hs.items()}
    same_entry = float((ents["cpu"] == ents["cuda"].cpu()).float().mean())

    def entry_search(dev):
        """The CPU's HNSW served on ``dev``, entries from its own descent."""
        h, model, x = hs["cpu"].to(dev), m_cpu.to(dev), cpu.base.to(dev)
        eng = InMemoryEngine(h.base, codes_cpu, lambda qq: base.build_lut(model, qq),
                             device=dev, entry_fn=lambda qq: descend(h, qq, x))
        return eng.search(q, k=10, h=32)

    res = {dev: entry_search(dev) for dev in ("cpu", "cuda")}
    same_top = float((res["cpu"].ids == res["cuda"].ids.cpu()).all(dim=1).float().mean())
    ns = {dev: build_nsg(cpu.base, r=16, k=24, search_l=24, device=dev)
          for dev in ("cpu", "cuda")}
    n_rows = rows_identical(ns["cpu"].neighbors, ns["cuda"].neighbors)
    cm, losses = catalyst.train_catalyst(cpu.train, 8, 32,
                                         generator=torch.Generator().manual_seed(4),
                                         d_out=16, steps=50, device="cpu")
    cm_gpu = cm.to("cuda")
    y_err = float((catalyst.forward(cm_gpu.net, cpu.base.cuda()).cpu()
                   - catalyst.forward(cm.net, cpu.base)).abs().max())
    codes_gpu = catalyst.encode(cm_gpu, cpu.base.cuda()).cpu()
    same_codes = float((catalyst.encode(cm, cpu.base) == codes_gpu).all(dim=1).float().mean())
    log(f"[small] HNSW m=8 (layers {[g.n for g in hs['cpu'].layers]}): rows identical card vs "
        f"CPU {h_rows:.4f} (min over layers), members equal {same_members}, descend entries "
        f"identical {same_entry:.4f}, entry_fn top-10 identical {same_top:.4f}; NSG r=16 rows "
        f"identical {n_rows:.4f}; Catalyst (d_out=16, 50 steps) forward max abs err "
        f"{y_err:.3e}, codes identical {same_codes:.4f}")
    check(same_members, "HNSW layer members differ card vs CPU")
    check(h_rows >= 0.95, "HNSW build on the card disagrees with the CPU")
    check(n_rows >= 0.95, "NSG build on the card disagrees with the CPU")
    check(same_entry >= 0.99, "HNSW descent on the card disagrees with the CPU")
    check(same_top >= 0.99, "the entry_fn search on the card disagrees with the CPU")
    check(bool(torch.isfinite(losses).all()), "small Catalyst: a loss is not finite")
    check(y_err <= 1e-5, f"Catalyst forward on the card disagrees with the CPU ({y_err:.3e})")
    check(same_codes >= 0.999, "Catalyst encode on the card disagrees with the CPU")


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
            "kernels": sum(n for _, n in per_kernel.values()),
            "top": [(name[:90], ms, n) for name, (ms, n) in top], "per_kernel": per_kernel}


def in_search(busy: dict, pattern: str, row: dict, label: str) -> dict:
    """Mean device time per launch of the kernels whose name holds
    ``pattern`` inside a traced search (``device_busy``), logged beside the
    same kernel's phase-3 times alone, L2-cold and L2-warm: where the mean
    sits between them says whether the search finds its LUTs in L2."""
    if busy["device_ms"] is None:
        log(f"[trace] {row['name']} inside one {label} search: not measured (no device time)")
        return {}
    ms = n = 0
    for name, (k_ms, k_n) in busy["per_kernel"].items():
        if pattern in name:
            ms, n = ms + k_ms, n + k_n
    check(n > 0, f"the traced {label} search launched no {row['name']}")
    note = {"launches": n, "mean_us": ms / n * 1e3, "l2_cold_us": row["ms"] * 1e3,
            "l2_warm_us": row["l2_warm_ms"] * 1e3}
    log(f"[trace] {row['name']} inside one {label} search: {n} launches, mean "
        f"{note['mean_us']:.2f} us of device time per launch; alone at one beam round's "
        f"shape (phase 3): L2-cold {note['l2_cold_us']:.2f} us, L2-warm "
        f"{note['l2_warm_us']:.2f} us")
    return note


def device_busy(fn, wall_s: float, label: str = "InMemoryEngine") -> dict:
    """Device time of one traced ``fn()`` by kernel name (torch.profiler),
    and its share of ``wall_s``, the untraced wall time of the same call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_times(prof, "trace", f"one {label} search", wall_s * 1e3)


def main_path(args, wait_for_cli) -> tuple:
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
        batch=args.vamana_batch, verbose=True))
    # phase 11 ran beside the build; nothing timed from here on shares the card
    timed_("wait_for_cli", wait_for_cli)
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
                n_base=int(ds.base.shape[0])), ds, gt, graph, model, codes, res_m


# --------------------------------------------------------------------------
# phase 6: the fs4 path at full width, on the u8 path's dataset and graph
# --------------------------------------------------------------------------

def fs4_path(ds, gt, graph, u8_model, u8_codes) -> tuple:
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
                fs4_vs_f32_max_ratio=ratio, memory_bytes=mem_bytes,
                scan=scan), model, packed


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

# fit's steps: the reference's TrainConfig default is 1000; cut to 250 when
# phase 16 took the run past ~830 s on one H100 (ROADMAP's first named cut)
TRAIN_STEPS = 250
TRACE_FROM_STEP = 101  # the 20 traced steps hold no routing refresh
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
    tcfg = T.TrainConfig(steps=TRAIN_STEPS)
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
    refreshes = [dt[s] - step_ms for s in dt if s % tcfg.refresh_every == 0 and s > 0]
    refresh_ms = statistics.median(refreshes)
    log(f"[train] fit: {tcfg.steps} steps in {fit_s:.1f} s; median step {step_ms:.3f} ms "
        f"(first step {dt[0]:.1f} ms with the first refresh); routing refresh "
        f"{refresh_ms:.1f} ms (median over {len(refreshes)})")
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

def per_query_us(fn, n_queries: int) -> float:
    """Host wall time per call of ``fn(i)`` for i < ``n_queries``, one
    query after another as a caller issues them, after one untimed call,
    between two synchronizations."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_queries):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_queries * 1e6


def retrieval_us(n: int = 1_000_000, m: int = 16, k: int = 256, n_queries: int = 100,
                 top: int = 100, reps: int = 11, seed: int = 0) -> dict:
    """``--retrieval-us``: phase 9's per-query loop alone, ``adc_scan`` and
    ``score_candidates_adc``, ``reps`` times each (each time and the
    median; the host's clock is noisy), on seeded uniform (n, m)
    uint8 codes and ``n_queries`` f32 LUTs made on the card, with whichever
    ``repro_torch`` is first on ``sys.path``. Two trees' wrappers and
    kernels compare in one chip call, each run in a process of its own."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys

    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, k, (n, m), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    luts = torch.rand((n_queries, m, k), generator=g, device="cuda")
    check(torch.equal(ops.adc_scan(codes, luts[0]), ref.adc_scan_ref(codes, luts[0])),
          "adc_scan differs from its plain version")
    ops.reset_launch_counts()
    out = {"adc_scan_us": [], "score_candidates_adc_us": []}
    for _ in range(reps):
        out["score_candidates_adc_us"].append(per_query_us(
            lambda i: recsys.score_candidates_adc(luts[i], codes, k=top), n_queries))
        out["adc_scan_us"].append(per_query_us(lambda i: ops.adc_scan(codes, luts[i]),
                                               n_queries))
    for key in ("adc_scan_us", "score_candidates_adc_us"):
        out[key + "_median"] = statistics.median(out[key])
    out["launches"] = ops.launch_counts()["adc_scan"]
    check(out["launches"] == 2 * reps * (n_queries + 1), "adc_scan was not launched per query")
    return out


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

    adc_us = per_query_us(lambda i: recsys.score_candidates_adc(luts[i], codes, k=k),
                          n_queries)
    exact_us = per_query_us(lambda i: recsys.score_candidates_exact(qs[i], ds.base, k=k),
                            n_queries)
    scan_us = per_query_us(lambda i: ops.adc_scan(codes, luts[i]), n_queries)
    log(f"[retrieval] {n_queries} single queries, k={k}, over {codes.shape[0]} RPQ codes: "
        f"kernel top-{k} ids equal the plain scan's on {same:.4f} of queries")
    log(f"[retrieval] per query: score_candidates_adc {adc_us:.1f} us (adc_scan alone "
        f"{scan_us:.1f} us), score_candidates_exact (GEMV + top-k) {exact_us:.1f} us")
    log(f"[retrieval] launches: {counts}")
    check(same >= 0.99, "kernel-scored and plain-scored top-k ids disagree")
    return dict(same_topk=same, adc_us=adc_us, adc_scan_us=scan_us, exact_us=exact_us,
                launches=counts)


# --------------------------------------------------------------------------
# phase 10: adaptive routing, budgets and the degradation ladder at 1M
# --------------------------------------------------------------------------

# the five rows of examples/adaptive_routing.py:84-89
ADAPTIVE_ROWS = (("baseline", {}),
                 ("entries=8", {"entries": 8}),
                 ("prune eps=0.2 m'=2", {"prune_eps": 0.2, "m_prefix": 2}),
                 ("seeded+pruned", {"entries": 8, "prune_eps": 0.2, "m_prefix": 2}),
                 ("seeded+pruned+E=4", {"entries": 8, "prune_eps": 0.2, "m_prefix": 2,
                                        "expand": 4}))
ROUND_BUDGETS = (2, 4, 8, 16, 32, 64)


def plain_hop_adc(codes, ids, luts, *, m_prefix=0):
    """``ops.hop_adc`` with the plain version on CUDA tensors."""
    import torch

    from repro_torch.kernels import ref

    m = codes.shape[1]
    mp = m_prefix if 0 < m_prefix < m else 0
    ids = ids.to(torch.int32)
    if mp:
        return ref.hop_adc_ref(codes[:, :mp], ids, luts[:, :mp].float())
    return ref.hop_adc_ref(codes, ids, luts.float())


def plain_hop_adc_fs(packed, ids, luts_u8, scale, bias, *, m_prefix=0):
    """``ops.hop_adc_fs`` with the plain version on CUDA tensors."""
    import torch

    from repro_torch.kernels import ref

    m = luts_u8.shape[1]
    mp = m_prefix if 0 < m_prefix < m else 0
    m_eff = mp or m
    acc = ref.hop_adc_fs_acc(packed[:, :(m_eff + 1) // 2], ids.to(torch.int32),
                             luts_u8[:, :m_eff])
    return ref.dequant(acc, scale, bias, m_eff)


class uncounted:
    """Within the block, kernel launches are added to ``excluded`` (kernel
    name → launches), which the caller subtracts from the phase's counts:
    a microbenchmark inside a counted phase is not the main path's run."""

    def __init__(self, excluded: dict):
        self.excluded = excluded

    def __enter__(self):
        from repro_torch.kernels import ops

        self._before = ops.launch_counts()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for k, v in ops.launch_counts().items():
            self.excluded[k] = self.excluded.get(k, 0) + v - self._before[k]
        return False


class plain_routing:
    """Within the block, every beam round and seed probe of the engines
    scores through the plain versions (on CUDA tensors) instead of the
    kernels: ``ops.hop_adc`` and ``ops.hop_adc_fs`` are swapped, and both
    ``search/beam.py`` and ``search/seed.py`` call them through ``ops``."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self._saved = ops.hop_adc, ops.hop_adc_fs
        ops.hop_adc, ops.hop_adc_fs = plain_hop_adc, plain_hop_adc_fs

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.hop_adc, ops.hop_adc_fs = self._saved
        return False


def adaptive_path(ds, gt, graph, u8_model, u8_codes, res_main, fs4_model, fs4_packed) -> dict:
    import torch

    from repro_torch.kernels import hop_adc_fs as khopfs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import calibrate_max_rounds
    from repro_torch.pq import base
    from repro_torch.search.degrade import DegradationPolicy
    from repro_torch.search.engine import HybridEngine, InMemoryEngine
    from repro_torch.search.metrics import measure_qps, recall_at_k

    qs = ds.queries
    nq = qs.shape[0]
    layouts = {"u8": (u8_codes, lambda q: base.build_lut(u8_model, q)),
               "fs4": (fs4_packed, lambda q: base.build_lut(fs4_model, q, quantize=True))}
    engines = {(lay, name): cls(graph, codes, lut_fn, device=qs.device, **extra)
               for lay, (codes, lut_fn) in layouts.items()
               for name, cls, extra in (("inmemory", InMemoryEngine, {}),
                                        ("hybrid", HybridEngine, {"vectors": ds.base}))}

    def row_stats(res, qps):
        return {"recall": recall_at_k(res.ids, gt, 10), "qps": qps,
                "rounds_mean": float(res.rounds.float().mean()),
                "rounds_max": int(res.rounds.max()),
                "n_dist": float(res.n_dist.float().mean()),
                "truncated": float(res.truncated.float().mean())}

    ops.reset_launch_counts()
    # the seed index of each layout, built once and timed (the engines of a
    # layout share one: the index depends on the codes only)
    seed_s = {}
    for lay in layouts:
        mem = engines[(lay, "inmemory")]
        luts = mem.lut_fn(qs[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ix = mem._seed_index(luts)
        torch.cuda.synchronize()
        seed_s[lay] = time.perf_counter() - t0
        engines[(lay, "hybrid")]._seedix = ix
        occupied = int((ix.table >= 0).any(dim=1).sum())
        log(f"[adaptive] {lay} seed index: {seed_s[lay] * 1e3:.1f} ms; "
            f"{ix.table.shape[0]} buckets on {ix.m_hash} sub-code(s) (K={ix.k}), "
            f"{occupied} occupied, {ix.n_candidates} candidates per query")

    rows, results, launch_rows = {}, {}, {}
    for (lay, name), eng in engines.items():
        for tag, kw in ADAPTIVE_ROWS:
            before = ops.launch_counts()
            res = eng.search(qs, k=10, h=32, **kw)
            after = ops.launch_counts()
            launch_rows[(lay, name, tag)] = {k: after[k] - before[k] for k in after
                                             if after[k] - before[k]}
            qps, _ = measure_qps(lambda q: eng.search(q, k=10, h=32, **kw), qs)
            results[(lay, name, tag)] = res
            rows[(lay, name, tag)] = row_stats(res, qps)
            r = rows[(lay, name, tag)]
            log(f"[adaptive] {lay} {name:8s} {tag:20s} recall@10 {r['recall']:.4f} "
                f"QPS {qps:9.1f} rounds {r['rounds_mean']:6.2f} (max {r['rounds_max']:3d}) "
                f"n_dist {r['n_dist']:8.1f} truncated {r['truncated']:.3f} "
                f"launches {launch_rows[(lay, name, tag)]}")

    # budgets on the u8 InMemoryEngine: a max_rounds sweep
    mem = engines[("u8", "inmemory")]
    full = results[("u8", "inmemory", "baseline")]
    sweep = {}
    for r_max in ROUND_BUDGETS:
        qps, res = measure_qps(lambda q: mem.search(q, k=10, h=32, max_rounds=r_max), qs,
                               repeats=1)
        sweep[r_max] = (res, row_stats(res, qps))
        st = sweep[r_max][1]
        log(f"[adaptive] u8 inmemory max_rounds={r_max:3d}: recall@10 {st['recall']:.4f} "
            f"QPS {qps:9.1f} rounds max {st['rounds_max']} truncated {st['truncated']:.3f}")
    # a deadline of half the baseline hybrid batch, through calibrate_max_rounds
    hyb = engines[("u8", "hybrid")]
    batch_s = nq / rows[("u8", "hybrid", "baseline")]["qps"]
    deadline_s = 0.5 * batch_s
    mr = calibrate_max_rounds(hyb, qs, deadline_s, k=10, h=32)
    qps_d, res_d = measure_qps(lambda q: hyb.search(q, k=10, h=32, max_rounds=mr), qs)
    deadline = dict(deadline_ms=deadline_s * 1e3, max_rounds=mr, batch_ms=nq / qps_d * 1e3,
                    **row_stats(res_d, qps_d))
    log(f"[adaptive] u8 hybrid deadline {deadline_s * 1e3:.2f} ms -> max_rounds={mr}: "
        f"batch {deadline['batch_ms']:.2f} ms, recall@10 {deadline['recall']:.4f}, "
        f"truncated {deadline['truncated']:.3f}")
    # the degradation ladder, levels 0-4, on HybridEngine over the full config
    policy, ladder = DegradationPolicy(), {}
    full_cfg = dict(h=32, expand=4, entries=8, prune_eps=0.2, m_prefix=2)
    for level in range(5):
        kw = policy.apply(hyb, level, **full_cfg)
        qps, res = measure_qps(lambda q: hyb.search(q, k=10, **kw), qs)
        ladder[level] = dict(kwargs={k: v for k, v in kw.items()}, **row_stats(res, qps))
        log(f"[adaptive] ladder L{level} {kw}: recall@10 {ladder[level]['recall']:.4f} "
            f"QPS {qps:9.1f} rounds {ladder[level]['rounds_mean']:.2f} n_dist "
            f"{ladder[level]['n_dist']:.1f}")
    counts = ops.launch_counts()
    log(f"[adaptive] launches: {counts}")
    for name in ("pq_pairwise", "hop_adc", "hop_adc_fs"):
        check(counts[name] > 0, f"kernel {name} was not launched on the adaptive path")

    # ---- checks (their launches are not counted) ----
    # (a) the default knobs are phase 5's search, bit for bit
    for res in (full, mem.search(qs, k=10, h=32, entries=1, prune_eps=0.0)):
        same = {f: bool(torch.equal(getattr(res, f), getattr(res_main, f)))
                for f in ("ids", "dists", "hops", "n_dist", "rounds", "truncated")}
        check(all(same.values()), f"(a) default knobs differ from phase 5's search: {same}")
    log("[adaptive] (a) entries=1, prune_eps=0, no budget: bit-equal to phase 5's search")
    # (b) kernel- vs plain-routed top-10, every row
    same_top = {}
    with plain_routing():
        for (lay, name, tag), res in results.items():
            kw = dict(ADAPTIVE_ROWS)[tag]
            res_p = engines[(lay, name)].search(qs, k=10, h=32, **kw)
            same_top[(lay, name, tag)] = float((res_p.ids == res.ids).all(dim=1).float().mean())
    worst = min(same_top.values())
    log(f"[adaptive] (b) top-10 identical with plain routing: min {worst:.4f} over "
        f"{len(same_top)} rows")
    for key, v in same_top.items():
        check(v >= 0.99, f"(b) {key}: kernel- and plain-routed top-10 agree on {v:.4f}")
    # (c) budgets bind per lane; an unflagged lane is converged
    for r_max, (res, _) in sweep.items():
        check(int(res.rounds.max()) <= r_max, f"(c) rounds exceed max_rounds={r_max}")
        done = ~res.truncated
        check(bool((res.rounds[res.truncated] == r_max).all()),
              f"(c) a truncated lane stopped before max_rounds={r_max}")
        for f in ("ids", "hops", "rounds", "n_dist"):
            check(bool(torch.equal(getattr(res, f)[done], getattr(full, f)[done])),
                  f"(c) an unflagged lane under max_rounds={r_max} is not converged ({f})")
    check(not bool(full.truncated.any()), "(c) the unbudgeted search truncated")
    log(f"[adaptive] (c) max_rounds {ROUND_BUDGETS}: rounds <= budget, truncated lanes "
        f"stop at it, every other lane equals the unbudgeted search")
    # (d) the prefix bound of both kernels on a sampled frontier
    g = torch.Generator(device=qs.device).manual_seed(99)
    src = torch.randint(0, graph.n, (nq,), generator=g, device=qs.device)
    ids = graph.neighbors[src].to(torch.int32)                    # (Q, R) frontier
    luts = layouts["u8"][1](qs)
    codes_p = engines[("u8", "inmemory")]._codes_p
    lb, fu = ops.hop_adc(codes_p, ids, luts, m_prefix=2), ops.hop_adc(codes_p, ids, luts)
    check(bool((lb <= fu).all()), "(d) hop_adc m_prefix=2 exceeds the full distance")
    ql = layouts["fs4"][1](qs)
    packed_p = engines[("fs4", "inmemory")]._codes_p
    lb_i = khopfs.hop_adc_fs(packed_p, ids, ql.lut, m_prefix=2)
    fu_i = khopfs.hop_adc_fs(packed_p, ids, ql.lut)
    check(bool((lb_i <= fu_i).all()), "(d) hop_adc_fs m_prefix=2 exceeds the full int32 sum")
    log(f"[adaptive] (d) prefix <= full on {tuple(ids.shape)} frontier ids: hop_adc "
        f"(mean ratio {float((lb / fu.clamp(min=1e-30)).mean()):.3f}), hop_adc_fs int32")
    # (e) pruning cuts n_dist
    for lay in layouts:
        for name in ("inmemory", "hybrid"):
            a = rows[(lay, name, "baseline")]["n_dist"]
            b = rows[(lay, name, "prune eps=0.2 m'=2")]["n_dist"]
            check(b < a, f"(e) {lay} {name}: pruned n_dist {b:.1f} not below {a:.1f}")
    log("[adaptive] (e) pruned n_dist below unpruned in every layout and engine")
    for key, r in rows.items():
        check(math.isfinite(r["recall"]) and r["qps"] > 0, f"{key}: bad recall or QPS")

    key = lambda k: " / ".join(k)
    return dict(seed_index_ms={k: v * 1e3 for k, v in seed_s.items()},
                rows={key(k): v for k, v in rows.items()},
                row_launches={key(k): v for k, v in launch_rows.items()},
                same_top10_plain={key(k): v for k, v in same_top.items()},
                sweep={r: st for r, (_, st) in sweep.items()}, deadline=deadline,
                ladder=ladder, launches=counts)


# --------------------------------------------------------------------------
# phase 12: the streaming index under churn, on phase 5's base and graph
# --------------------------------------------------------------------------

# An update stream of re-embedded catalogue items: each round tombstones
# STREAM_BATCH random live base rows (numpy seed 0) and inserts the same
# vectors as new rows, into a delta of STREAM_CAPACITY slots.
STREAM_CAPACITY = 50_000
STREAM_BATCH = 12_500
STREAM_ROUNDS = 4
STREAM_FS4_ROUNDS = 2  # the fs4 rounds (no consolidation) add no check of their own
RYW_CHUNK = 2_500     # read-your-writes queries per search call


class plain_streaming(plain_routing):
    """:class:`plain_routing` for the streaming engine: inside the block the
    delta arm's ``ops.adc_scan_batch`` / ``ops.adc_scan_fs`` are their plain
    versions too (``search/engine._bulk_adc`` calls them through ``ops``)."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        super().__enter__()
        self._saved_all = ops.adc_scan_batch, ops.adc_scan_fs
        ops.adc_scan_batch = lambda codes, luts: ref.adc_scan_batch_ref(codes, luts)
        ops.adc_scan_fs = lambda packed, lut, scale, bias: ref.adc_scan_fs_ref(
            packed, lut, scale, bias)

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.adc_scan_batch, ops.adc_scan_fs = self._saved_all
        return super().__exit__(*exc)


def stream_path(ds, graph, u8_model, u8_codes, fs4_model, fs4_packed, work_dir: str) -> dict:
    """Phase 12: ``StreamingEngine`` at full width on phase 5's base, R=64
    graph, u8 codes and PQ model (then phase 6's fs4 codes, then a K=512
    int32-code quantizer). Per round: delete, insert, a 1000-query search
    at h=32, k=10 scored against ``live_ground_truth``, QPS, the delta
    arm's own time, ``n_live``, resident MB. u8: a refreshed
    consolidation (``RefreshConfig()``) after round 2, a plain one with a
    snapshot and ``StreamingEngine.restore`` after round 4. Checks (a)–(f)
    of the module docstring."""
    import numpy as np
    import torch

    from repro_torch.index import BaseSegment, RefreshConfig, StreamingEngine
    from repro_torch.index import refresh as refresh_mod
    from repro_torch.index.engine import _merge_delta
    from repro_torch.index.segment import encode_codes
    from repro_torch.kernels import ops, ref
    from repro_torch.models.recsys import score_candidates_adc
    from repro_torch.pq import train_pq
    from repro_torch.search import beam
    from repro_torch.search.engine import _bulk_adc, topk_lower
    from repro_torch.search.metrics import live_ground_truth, measure_qps, recall_at_k

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    q = ds.queries
    n, dim = ds.base.shape
    times: dict[str, list] = {}
    rounds: list[dict] = []
    timing_launches: dict[str, int] = {}
    checks = {"a_no_tombstone": True, "b_read_your_writes_ties": 0, "c_same_top10": [],
              "d_restore_bit_equal": None, "e_distortion": None, "f_old2new": []}

    def clock(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(label, []).append(time.perf_counter() - t0)
        return out

    def run(layout, model, codes, *, consolidations, n_rounds=STREAM_ROUNDS):
        eng = StreamingEngine(BaseSegment(graph=graph, codes=codes, vectors=ds.base,
                                          layout=layout), model,
                              delta_capacity=STREAM_CAPACITY, device=ds.base.device)
        all_x = torch.zeros((n + STREAM_CAPACITY, dim), device=ds.base.device)
        all_x[:n] = ds.base
        live = np.zeros(n + STREAM_CAPACITY, bool)
        live[:n] = True
        rng = np.random.default_rng(0)

        def renumber(stats):
            nonlocal all_x, live
            o2n = stats["old2new"]
            ok = bool(np.array_equal(o2n >= 0, live[:o2n.shape[0]])
                      and np.array_equal(np.sort(o2n[o2n >= 0]), np.arange(stats["n"])))
            checks["f_old2new"].append(ok)
            check(ok, f"(f) {layout} generation {stats['generation']}: old2new does not "
                      f"map exactly the live ids")
            new_live = np.zeros(stats["n"] + STREAM_CAPACITY, bool)
            new_live[o2n[np.flatnonzero(live)]] = True
            live = new_live
            all_x = torch.cat([eng.base.vectors, torch.zeros((STREAM_CAPACITY, dim),
                                                             device=ds.base.device)])

        for i in range(n_rounds):
            dead = rng.choice(np.flatnonzero(live[:eng.base.n]), STREAM_BATCH, replace=False)
            vecs = eng.base.vectors[torch.from_numpy(dead).to(ds.base.device)]
            clock(f"{layout} delete", lambda: eng.delete(dead))
            live[dead] = False
            gids = clock(f"{layout} insert", lambda: eng.insert(vecs))
            all_x[torch.from_numpy(gids).to(ds.base.device)] = vecs
            live[gids] = True
            gt = live_ground_truth(all_x, np.flatnonzero(live), q, 10)
            qps, res = measure_qps(lambda qq: eng.search(qq, k=10, h=32), q)
            # the delta arm alone (bulk scan + merge top-k) on this batch's
            # LUTs and base-arm output, by CUDA events
            luts = eng.lut_fn(q)
            base_res = eng.search(q, k=32, h=32, skip_delta=True)
            with uncounted(timing_launches):
                delta_ms = cuda_ms(lambda: _merge_delta(
                    base_res.ids, base_res.dists, eng._delta_codes_dev, luts, eng._live_dev,
                    k=10, n_base=eng.base.n), iters=5)
            del luts, base_res
            ids = res.ids.cpu().numpy()
            # (a) no tombstoned id is ever returned
            ok_a = not eng.tombstones.contains(ids[ids >= 0]).any()
            checks["a_no_tombstone"] &= ok_a
            check(ok_a, f"(a) {layout} round {i}: a tombstoned id was returned")
            # (b) read-your-writes: each inserted vector, queried as itself,
            # returns its new id at rank 0 — or, on an exact ADC tie with
            # its own row, an earlier delta row (delta lanes first, in slot
            # order: the merge's documented tie order)
            ryw = [eng.search(vecs[s:s + RYW_CHUNK], k=1, h=32)
                   for s in range(0, len(gids), RYW_CHUNK)]
            top = torch.cat([r.ids[:, 0] for r in ryw]).cpu().numpy()
            miss = np.flatnonzero(top != gids)
            if miss.size:
                mt = torch.from_numpy(miss).to(ds.base.device)
                own = _bulk_adc(eng._delta_codes_dev[torch.from_numpy(gids[miss] - eng.base.n)
                                                     .to(ds.base.device)],
                                eng.lut_fn(vecs[mt])).diagonal()
                d_top = torch.cat([r.dists[:, 0] for r in ryw])[mt]
                slot_t = top[miss] - eng.base.n
                tie = ((slot_t >= 0) & (slot_t < gids[miss] - eng.base.n)
                       & (d_top == own).cpu().numpy())
                check(bool(tie.all()), f"(b) {layout} round {i}: {int((~tie).sum())} inserted "
                                       f"vectors do not return their own id at rank 0")
                checks["b_read_your_writes_ties"] += int(miss.size)
            # (c) the kernel-routed top-10 equals the plain-routed one
            with plain_streaming():
                res_p = eng.search(q, k=10, h=32)
            same = float((res_p.ids == res.ids).all(dim=1).float().mean())
            checks["c_same_top10"].append(same)
            check(same >= 0.99, f"(c) {layout} round {i}: kernel- and plain-routed "
                                f"top-10 agree on {same:.4f} of queries")
            row = dict(layout=layout, round=i, recall=recall_at_k(res.ids, gt, 10), qps=qps,
                       delta_ms=delta_ms, delta_share=delta_ms / (1e3 * q.shape[0] / qps),
                       n_live=eng.n_live, generation=eng.generation,
                       resident_mb=eng.memory_bytes() / 1e6,
                       hops=float(res.hops.float().mean()),
                       n_dist=float(res.n_dist.float().mean()), same_top10_plain=same)
            rounds.append(row)
            log(f"[stream] {layout} round {i}: recall@10={row['recall']:.4f} qps={qps:.1f} "
                f"(delta arm {delta_ms:.3f} ms, {row['delta_share']:.3f} of the batch) "
                f"live={row['n_live']} gen={row['generation']} "
                f"resident={row['resident_mb']:.1f}MB hops={row['hops']:.1f} "
                f"n_dist={row['n_dist']:.1f} same-top10-plain={same:.4f}")
            if consolidations and i == 1:
                # consolidate() looks refresh_quantizer up at call time: a
                # timing wrapper there clocks the refresh inside it
                real_refresh = refresh_mod.refresh_quantizer
                refresh_mod.refresh_quantizer = lambda *a, **kw: clock(
                    "refresh", lambda: real_refresh(*a, **kw))
                try:
                    stats = clock("consolidate refreshed", lambda: eng.consolidate(
                        refresh=RefreshConfig()))
                finally:
                    refresh_mod.refresh_quantizer = real_refresh
                rep = stats["refresh"]
                checks["e_distortion"] = (rep["distortion_before"], rep["distortion_after"])
                log(f"[stream] consolidated → generation {stats['generation']}: {stats['n']} "
                    f"rows ({stats['dropped']} dropped, {stats['folded']} folded in), "
                    f"codebooks refreshed (live distortion {rep['distortion_before']:.3f} → "
                    f"{rep['distortion_after']:.3f}) in "
                    f"{times['consolidate refreshed'][-1]:.2f} s, "
                    f"the refresh {times['refresh'][-1]:.2f} s of it")
                check(rep["distortion_after"] <= rep["distortion_before"],
                      "(e) the refresh raised the live distortion")
                renumber(stats)
        if consolidations:
            stats = clock("consolidate + snapshot", lambda: eng.consolidate(
                ckpt_dir=work_dir, keep=2))
            log(f"[stream] consolidated → generation {stats['generation']}: {stats['n']} "
                f"rows ({stats['dropped']} dropped, {stats['folded']} folded in), "
                f"snapshot at {work_dir} in {times['consolidate + snapshot'][-1]:.2f} s")
            renumber(stats)
            before = eng.search(q, k=10, h=32)
            restored = clock("restore", lambda: StreamingEngine.restore(
                work_dir, delta_capacity=STREAM_CAPACITY, device=ds.base.device))
            after = restored.search(q, k=10, h=32)
            same = bool(torch.equal(before.ids, after.ids)
                        and torch.equal(before.dists, after.dists))
            checks["d_restore_bit_equal"] = same
            log(f"[stream] restored generation {restored.generation} ({restored.n_live} live "
                f"rows) in {times['restore'][-1]:.2f} s; search bit-equal: {same}")
            check(same, "(d) the restored engine's search differs from the pre-snapshot one")
            del restored
        return eng

    eng = run("u8", u8_model, u8_codes, consolidations=True)
    del eng
    eng = run("fs4", fs4_model, fs4_packed, consolidations=False, n_rounds=STREAM_FS4_ROUNDS)
    del eng
    # K=512: int32 codes through the same graph, one round
    wide = clock("train_pq K=512", lambda: train_pq(
        ds.train, 16, 512, generator=torch.Generator().manual_seed(5), iters=5,
        device=ds.base.device))
    wide_codes = encode_codes(wide, ds.base, "u8")
    check(wide_codes.dtype == torch.int32, "K=512 codes are not int32")
    eng = run("u8", wide, wide_codes, consolidations=False, n_rounds=1)
    rounds[-1]["layout"] = "u8 K=512 int32"
    # the same codes down the gather route (phase 7's) and the retrieval
    # scorer's (phase 9's): the other two int32 variants on real work
    luts = eng.lut_fn(q)
    res_g = beam.beam_search(graph.neighbors, graph.medoid, luts,
                             lambda lt, ids: ops.hop_gather(eng._codes_p[ids], lt),
                             h=32, max_steps=512)
    res_a = beam.beam_search(graph.neighbors, graph.medoid, luts,
                             beam.make_adc_dist_fn(eng._codes_p), h=32, max_steps=512)
    check(torch.equal(res_g.ids, res_a.ids) and torch.equal(res_g.dists, res_a.dists),
          "K=512: the hop_gather-routed search differs from the hop_adc-routed one")
    top = [score_candidates_adc(luts[i], wide_codes, k=100)[1] for i in range(10)]
    plain = [topk_lower(ref.adc_scan_ref(wide_codes, luts[i])[None], 100)[1][0]
             for i in range(10)]
    same = all(torch.equal(a.long(), b) for a, b in zip(top, plain))
    log(f"[stream] K=512 int32 codes: hop_gather-routed search equals hop_adc-routed; "
        f"score_candidates_adc top-100 equal to the plain scan's on 10 queries: {same}")
    check(same, "K=512: score_candidates_adc differs from the plain scan")
    del eng, wide_codes, luts, res_g, res_a
    counts = {k: v - timing_launches.get(k, 0) for k, v in ops.launch_counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    summary = {k: (sum(v), len(v)) for k, v in times.items()}
    log(f"[stream] times (s, total over calls): "
        + ", ".join(f"{k} {t:.2f}/{c}" for k, (t, c) in summary.items()))
    log(f"[stream] launches: {counts}; peak device memory {peak_gb:.2f} GiB; "
        f"checks {checks}")
    for name in ("pq_pairwise", "hop_adc", "adc_scan_batch", "hop_adc_fs", "adc_scan_fs",
                 "hop_adc_i32", "adc_scan_batch_i32", "adc_scan_i32", "hop_gather_i32"):
        check(counts[name] > 0, f"kernel {name} was not launched by the streaming phase")
    for row in rounds:
        check(math.isfinite(row["recall"]) and row["qps"] > 0,
              f"{row['layout']} round {row['round']}: recall or QPS not finite")
    return dict(rounds=rounds, times=times, checks=checks, launches=counts,
                peak_gib=peak_gb, capacity=STREAM_CAPACITY, batch=STREAM_BATCH)


# --------------------------------------------------------------------------
# phase 13: the all-in-storage disk tier, on phase 5's base and graph
# --------------------------------------------------------------------------

DISK_CACHE_MB = 32.0       # ~117k records, 12% of the base (the bench: ~14%)
DISK_IO_THREADS = 4
DISK_CHECK_QUERIES = 100   # checks (a) and (d)-(g)
DISK_OVERLAP_QUERIES = 200  # the serial-vs-overlapped comparison
# benchmarks/disk_serving.py: modeled read latency at 1.2x the measured
# per-round compute, clipped to [0.5, 20] ms; the reference's bar is 1.5x
DISK_SLOW_MULT, DISK_SLOW_MS = 1.2, (0.5, 20.0)
DISK_OVERLAP_BAR = 1.5
DISK_OVERLAP_RUNS = 1  # timed searches per arm after its warm-up (the bench: 2)


def disk_search(eng, q, **kw):
    """A ``DiskEngine`` search at k=10, h=32 between two device
    synchronizations: (result, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.search(q, k=10, h=32, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def same_search(a, b) -> bool:
    """Two search results equal bit for bit: ids, dists and every counter
    (``b`` may lie on another device)."""
    import torch

    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("ids", "dists", "hops", "rounds", "n_dist", "truncated"))


def overlap_arm(eng, q, overlap: bool, timed_runs: int = DISK_OVERLAP_RUNS) -> tuple:
    """The bench's ``_timed``: one warm-up search, then ``timed_runs``;
    (last result, QPS of the fastest run, ``last_io`` of that run)."""
    disk_search(eng, q, overlap=overlap)
    best = None
    for _ in range(timed_runs):
        res, wall = disk_search(eng, q, overlap=overlap)
        if best is None or wall < best[0]:
            best = (wall, dict(eng.last_io))
    return res, q.shape[0] / best[0], best[1]


def disk_path(ds, gt, graph, u8_model, u8_codes, fs4_model, fs4_packed, res_main,
              inmem_recall: float, work_dir: str) -> dict:
    """Phase 13: ``storage.DiskEngine`` at 1M. Generation 0 of each layout
    written to ``work_dir``, opened from its quantizer sidecar with a 32 MB
    hot-vertex cache and 4 reader threads; one serial search of the 1000
    queries per layout (QPS, recall, rounds, hops, ``n_dist``, cache hit
    rate, bytes read, I/O wait, launches; the u8 one traced for the busy
    share); the reference bench's serial-vs-overlapped comparison on 200
    queries, calibrated and at ``slow_read_ms=0``; checks (a)–(h) of the
    module docstring (their searches run after the launch counts are read)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.index.segment import BaseSegment
    from repro_torch.kernels import ops
    from repro_torch.pq import base
    from repro_torch.search.metrics import recall_at_k
    from repro_torch.storage import DiskEngine, corrupt_header, segment_path, write_segment

    times, checks = {}, {}
    q = ds.queries
    nq = q.shape[0]
    qc = q[:DISK_CHECK_QUERIES]
    layouts = {"u8": (u8_model, u8_codes), "fs4": (fs4_model, fs4_packed)}
    ops.reset_launch_counts()
    segs, engines, serial, results = {}, {}, {}, {}
    for lay, (model, codes) in layouts.items():
        seg = BaseSegment(graph=graph, codes=codes, vectors=None, layout=lay,
                          dim_hint=ds.dim)
        t0 = time.perf_counter()
        path = write_segment(os.path.join(work_dir, lay), seg, model=model)
        times[f"write_{lay}"] = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        eng = DiskEngine.open(os.path.join(work_dir, lay), lut_fn=None,
                              cache_mb=DISK_CACHE_MB, io_threads=DISK_IO_THREADS,
                              device=q.device)
        times[f"open_{lay}"] = time.perf_counter() - t0
        log(f"[disk] {lay}: generation 0 written in {times[f'write_{lay}']:.2f} s, "
            f"{mb:.1f} MB ({eng.n} records of {eng.header.record_bytes} B); opened from "
            f"the sidecar in {times[f'open_{lay}']:.2f} s, cache {len(eng.cache)}/"
            f"{eng.cache.capacity} records ({eng.cache.stats()['pinned']} BFS-pinned), "
            f"{DISK_IO_THREADS} reader threads")
        segs[lay], engines[lay] = (seg, model), eng
        before = ops.launch_counts()
        res, wall = disk_search(eng, q, overlap=False)
        io = dict(eng.last_io)
        launched = {k: v - before[k] for k, v in ops.launch_counts().items() if v > before[k]}
        row = {"qps": nq / wall, "wall_s": wall, "recall": recall_at_k(res.ids, gt, 10),
               "rounds": float(res.rounds.float().mean()),
               "hops": float(res.hops.float().mean()),
               "n_dist": float(res.n_dist.float().mean()),
               "cache_hit_rate": io["cache_hit_rate"],
               "bytes_read_per_query": io["bytes_read"] / nq,
               "io_wait_s": io["io_wait_s"], "n_reads": io["n_reads"],
               "rounds_total": io["rounds_total"], "launches": launched}
        log(f"[disk] {lay} serial, {nq} queries at h=32: recall@10 {row['recall']:.4f}, "
            f"{row['qps']:.1f} QPS ({wall:.2f} s), mean rounds {row['rounds']:.2f} hops "
            f"{row['hops']:.2f} n_dist {row['n_dist']:.2f}; cache hit rate "
            f"{row['cache_hit_rate']:.3f}, {row['bytes_read_per_query']:.0f} B read a query "
            f"({io['n_reads']} reads), io_wait {io['io_wait_s'] * 1e3:.1f} ms; "
            f"kernels {launched}")
        check(res.ids.shape == (nq, 10) and res.ids.device == q.device,
              f"{lay}: disk result shape or device")
        check(bool(torch.isfinite(res.dists).all()), f"{lay}: disk distances not finite")
        if lay == "u8":
            row["busy"] = device_busy(lambda: eng.search(q, k=10, h=32, overlap=False),
                                      wall, "u8 DiskEngine")
            if row["busy"]["busy_share"] is not None:
                log(f"[disk] u8 serial search: device busy share "
                    f"{row['busy']['busy_share']:.6f}")
        serial[lay], results[lay] = row, res

    # ---- the reference bench's overlap comparison (u8, 200 queries) ----
    eng = engines["u8"]
    qo, gto = q[:DISK_OVERLAP_QUERIES], gt[:DISK_OVERLAP_QUERIES]
    overlap = {}
    for slow in ("real", "calibrated"):
        if slow == "calibrated":
            eng.reader.slow_read_ms = float(np.clip(
                DISK_SLOW_MULT * overlap["real"]["compute_ms_per_round"], *DISK_SLOW_MS))
        arms = {}
        for mode in ("serial", "overlapped"):
            res, qps, io = overlap_arm(eng, qo, mode == "overlapped")
            arms[mode] = {"qps": qps, "recall": recall_at_k(res.ids, gto, 10),
                          "io_wait_s": io["io_wait_s"], "rounds_total": io["rounds_total"],
                          "compute_ms_per_round": (io["wall_s"] - io["io_wait_s"]) * 1e3
                          / max(io["rounds_total"], 1)}
        row = {"slow_read_ms": eng.reader.slow_read_ms,
               "speedup": arms["overlapped"]["qps"] / arms["serial"]["qps"],
               "compute_ms_per_round": max(a["compute_ms_per_round"] for a in arms.values()),
               **arms}
        overlap[slow] = row
        log(f"[disk] overlap ({slow} reads, slow_read_ms {row['slow_read_ms']:.2f}, "
            f"{DISK_OVERLAP_QUERIES} queries, best of {DISK_OVERLAP_RUNS} after a warm-up): "
            f"serial "
            f"{arms['serial']['qps']:.1f} QPS recall {arms['serial']['recall']:.4f}, "
            f"overlapped {arms['overlapped']['qps']:.1f} QPS recall "
            f"{arms['overlapped']['recall']:.4f}; speedup {row['speedup']:.4f} (the "
            f"reference's bar {DISK_OVERLAP_BAR}: "
            f"{'met' if row['speedup'] >= DISK_OVERLAP_BAR else 'missed'}); compute "
            f"{row['compute_ms_per_round']:.2f} ms a round")
        # (c) the bench's correctness invariant
        ok = abs(arms["overlapped"]["recall"] - arms["serial"]["recall"]) <= 0.01
        checks[f"c_overlap_recall_{slow}"] = ok
        check(ok, f"(c) overlapped recall differs from serial by more than 0.01 ({slow})")
    eng.reader.slow_read_ms = 0.0
    counts = ops.launch_counts()

    # ---- checks: their searches come after the counts are read ----
    # (a) the card's serial search equals the CPU route's bit for bit: the
    # same LUTs (the sidecar's, built on the card) moved to the CPU; the CPU
    # engine's cache is left empty, which changes what is read, not a result
    card_res = {}
    for lay, eng in engines.items():
        luts = eng.lut_fn(qc)
        host_luts = luts.to("cpu")
        with DiskEngine.open(os.path.join(work_dir, lay), lut_fn=lambda _q: host_luts,
                             cache_records=0, io_threads=DISK_IO_THREADS,
                             device="cpu") as cpu_eng:
            host = cpu_eng.search(qc.cpu(), k=10, h=32, overlap=False)
        saved, eng.lut_fn = eng.lut_fn, lambda _q: luts
        card = card_res[lay] = eng.search(qc, k=10, h=32, overlap=False)
        checks[f"a_card_equals_cpu_{lay}"] = same_search(card, host)
        check(checks[f"a_card_equals_cpu_{lay}"],
              f"(a) {lay}: the card's search differs from the CPU route's")
        # (g) the sidecar route (``card``) equals an explicit lut_fn
        model = segs[lay][1]
        eng.lut_fn = lambda qq: base.build_lut(model, qq, quantize=lay == "fs4")
        explicit = eng.search(qc, k=10, h=32, overlap=False)
        eng.lut_fn = saved
        checks[f"g_sidecar_equals_explicit_{lay}"] = same_search(card, explicit)
        check(checks[f"g_sidecar_equals_explicit_{lay}"],
              f"(g) {lay}: the sidecar route differs from an explicit lut_fn")
    log(f"[disk] (a) the card's serial search equals the CPU route's bit for bit on "
        f"{DISK_CHECK_QUERIES} queries (u8, fs4); (g) the sidecar route equals an "
        f"explicit lut_fn")
    # (b) within a point of InMemoryEngine on the same graph, codes, queries
    rec = serial["u8"]["recall"]
    a, b = results["u8"].ids, res_main.ids[:, :10]
    same_ordered = float((a == b).all(dim=1).float().mean())
    same_set = float((a.sort(dim=1).values == b.sort(dim=1).values).all(dim=1)
                     .float().mean())
    checks["b_recall_within_0.01_of_inmemory"] = abs(rec - inmem_recall) <= 0.01
    log(f"[disk] (b) u8 recall@10 {rec:.4f} against InMemoryEngine's {inmem_recall:.4f}; "
        f"top-10 ids equal to InMemoryEngine's on {same_ordered:.4f} of queries in order, "
        f"{same_set:.4f} as sets")
    check(checks["b_recall_within_0.01_of_inmemory"],
          "(b) the disk search's recall is not within 0.01 of InMemoryEngine's")
    eng = engines["u8"]
    # (e) max_rounds=5: rounds bound, truncated exactly where work was left
    free = card_res["u8"]
    capped = eng.search(qc, k=10, h=32, overlap=False, max_rounds=5)
    left = free.rounds > 5
    done = ~capped.truncated
    checks["e_budget"] = bool((capped.rounds <= 5).all()
                              and torch.equal(capped.truncated, left)
                              and torch.equal(capped.ids[done], free.ids[done]))
    log(f"[disk] (e) max_rounds=5: rounds <= 5, truncated on {int(left.sum())} of "
        f"{DISK_CHECK_QUERIES} queries, exactly those whose free search took more; "
        f"the rest equal the free search")
    check(checks["e_budget"], "(e) max_rounds=5 does not bind or flag honestly")
    # (d) 1% of the ids tombstoned: none returned
    dead = np.random.default_rng(0).choice(eng.n, eng.n // 100, replace=False)
    eng.delete(dead)
    ids = eng.search(qc, k=10, h=32, overlap=False).ids.cpu().numpy()
    eng.tombstones = None
    checks["d_tombstones"] = not np.isin(ids, dead).any() and bool((ids >= 0).any(axis=1).all())
    log(f"[disk] (d) {dead.size} ids tombstoned (numpy seed 0): none returned")
    check(checks["d_tombstones"], "(d) a tombstoned id was returned")
    # (f) a corrupt generation 1 falls back to generation 0
    seg, model = segs["u8"]
    d = os.path.join(work_dir, "u8")
    write_segment(d, dataclasses.replace(seg, generation=1), model=model)
    corrupt_header(segment_path(d, 1), seed=0)
    falls = []
    with DiskEngine.open(d, lut_fn=None, cache_mb=DISK_CACHE_MB,
                         io_threads=DISK_IO_THREADS, device=q.device,
                         on_fallback=lambda g, e: falls.append(g)) as back:
        fell = back.generation == 0 and falls == [1]
        checks["f_fallback"] = fell and same_search(
            back.search(qc, k=10, h=32, overlap=False), free)
    log(f"[disk] (f) generation 1 corrupted: open fell back past {falls} to generation 0, "
        f"search equal to generation 0's: {checks['f_fallback']}")
    check(checks["f_fallback"], "(f) the corrupt-generation fallback failed")
    for eng in engines.values():
        eng.close()
    # (h) the phase ran its kernels
    for name in ("pq_pairwise", "hop_adc", "hop_adc_fs"):
        check(counts[name] > 0, f"(h) kernel {name} was not launched by the disk phase")
    checks["h_kernels"] = True
    log(f"[disk] launches: { {k: v for k, v in counts.items() if v} }; checks {checks}")
    return dict(serial=serial, overlap=overlap, checks=checks, times=times, launches=counts,
                cache_mb=DISK_CACHE_MB, check_queries=DISK_CHECK_QUERIES,
                overlap_queries=DISK_OVERLAP_QUERIES, overlap_timed_runs=DISK_OVERLAP_RUNS,
                same_top10_inmemory={"ordered": same_ordered, "set": same_set})


# --------------------------------------------------------------------------
# phase 14: the sharded engines at S = 4 on phase 5's base
# --------------------------------------------------------------------------

SHARDS = 4
DEAD_SHARD = [True, False, True, True]
# modeled shard latencies for the quorum check: shard 2 straggles past the
# deadline, three of four shards (at least the majority quorum) make it
STRAGGLER_LATENCY_S = [0.001, 0.001, 0.2, 0.001]
DEADLINE_S = 0.05
MIN_PARTITION_EXACT_RECALL = 0.5
DP_STEPS = 100


def per_shard_merge(pg, codes, lut_fn, queries, **kw):
    """What the sharded graph engine is held to: one ``InMemoryEngine`` per
    ``shard_subgraph(pg, s)`` over that shard's rows, local ids made global
    (sentinel and padding slots (-1, +inf)), merged by ``partial_merge``;
    ``hops`` and ``n_dist`` summed, ``rounds`` the max, ``truncated`` any."""
    import torch

    from repro_torch.dist.fault import partial_merge
    from repro_torch.graphs.partition import shard_subgraph
    from repro_torch.search.beam import SearchResult
    from repro_torch.search.engine import InMemoryEngine

    nl = pg.n_local
    ids, dists, res = [], [], []
    for s in range(pg.n_shards):
        r = InMemoryEngine(shard_subgraph(pg, s), codes[s * nl:(s + 1) * nl], lut_fn,
                           device=queries.device).search(queries, **kw)
        ok = (r.ids.long() < min(pg.n - s * nl, nl)) & torch.isfinite(r.dists)
        ids.append(torch.where(ok, r.ids.long() + s * nl, -1))
        dists.append(torch.where(ok, r.dists, float("inf")))
        res.append(r)
    m = partial_merge(ids, dists, [True] * pg.n_shards, kw.get("k", 10))
    stack = lambda name: torch.stack([getattr(r, name) for r in res])
    return SearchResult(m.ids, m.dists, hops=stack("hops").sum(0, dtype=torch.int32),
                        n_dist=stack("n_dist").sum(0, dtype=torch.int32),
                        rounds=stack("rounds").amax(0), truncated=stack("truncated").any(0))


def search_row(eng, queries, gt, label: str, *, tag: str = "sharded", **kw
               ) -> tuple[dict, object]:
    """One engine configuration: its first search's recall@10, rounds
    (mean and max), hops, ``n_dist`` and truncated share, its QPS over the
    1000 queries, and its kernel launches in one search."""
    from repro_torch.kernels import ops
    from repro_torch.search.metrics import measure_qps, recall_at_k

    before = ops.launch_counts()
    res = eng.search(queries, k=10, **kw)
    after = ops.launch_counts()
    qps, _ = measure_qps(lambda q: eng.search(q, k=10, **kw), queries)
    row = {"recall": recall_at_k(res.ids, gt, 10), "qps": qps,
           "rounds_mean": float(res.rounds.float().mean()),
           "rounds_max": int(res.rounds.max()), "hops": float(res.hops.float().mean()),
           "n_dist": float(res.n_dist.float().mean()),
           "truncated": float(res.truncated.float().mean()),
           "launches_one_search": {k: after[k] - before[k] for k in after
                                   if after[k] > before[k]}}
    log(f"[{tag}] {label}: recall@10 {row['recall']:.4f} qps {qps:.1f} rounds "
        f"{row['rounds_mean']:.2f} (max {row['rounds_max']}) hops {row['hops']:.2f} "
        f"n_dist {row['n_dist']:.1f} truncated {row['truncated']:.3f}; launches in one "
        f"search {row['launches_one_search']}")
    return row, res


def dp_train(ds, graph, u8_model, data_parallel: bool) -> dict:
    """``fit`` at ``TrainConfig`` defaults for ``DP_STEPS`` steps (one
    routing refresh, at step 0) from the PQ codebooks at R = I: single
    device, or 4 replicas with int8 compression. Median step ms (the
    refresh step left out), peak GiB, finite losses, and each replica's
    error-feedback residual within one quantization step of its leaf."""
    import statistics

    import torch

    from repro_torch.core import quantizer as Q
    from repro_torch.core import trainer as T

    cfg = Q.RPQConfig(dim=ds.base.shape[1], m=16, k=256)
    kw = dict(data_parallel=True, compress_grads=True, dp_replicas=SHARDS) if data_parallel else {}
    tcfg = T.TrainConfig(steps=DP_STEPS, log_every=10, **kw)
    marks = {}

    def on_step(step, params, opt_state):
        torch.cuda.synchronize()
        marks[step] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    marks[-1] = t0 = time.perf_counter()
    st = T.fit(cfg, tcfg, ds.base, graph, seed=0, params=Q.init_params(cfg, u8_model.codebooks),
               checkpoint_cb=on_step, verbose=False, device=ds.base.device)
    wall = time.perf_counter() - t0
    step_ms = statistics.median((marks[s] - marks[s - 1]) * 1e3 for s in range(1, DP_STEPS))
    peak = torch.cuda.max_memory_allocated() / 2**30
    label = "4 replicas, int8 + error feedback" if data_parallel else "one device"
    hist = st.history
    check(all(math.isfinite(h["total"]) and math.isfinite(h["gnorm"]) for h in hist),
          f"DP training ({label}): a logged loss or norm is not finite")
    row = {"steps": DP_STEPS, "wall_s": wall, "median_step_ms": step_ms, "peak_gib": peak,
           "first_step_ms": (marks[0] - marks[-1]) * 1e3,
           "loss": [(h["step"], h["total"]) for h in hist]}
    if data_parallel:
        worst = 0.0
        for err, sc in zip(st.comp_state, st.comp_scales):
            step = sc.reshape((SHARDS,) + (1,) * (err.dim() - 1))
            worst = max(worst, float((err.abs() / step).max()))
        check(worst <= 1.0, f"an error-feedback residual exceeds one quantization step ({worst})")
        row["residual_over_step_max"] = worst
    log(f"[sharded] train ({label}): {DP_STEPS} steps in {wall:.1f} s, median step "
        f"{step_ms:.3f} ms (first {row['first_step_ms']:.1f} ms with the refresh), peak "
        f"{peak:.2f} GiB; loss {hist[0]['total']:.4f} -> {hist[-1]['total']:.4f}"
        + (f"; residual/step max {row['residual_over_step_max']:.4f}" if data_parallel else ""))
    return row


def sharded_path(args, ds, gt, graph, u8_model, u8_codes, fs4_model, fs4_packed,
                 inmem_recall: float, kernels: dict) -> dict:
    """Phase 14: the partitioned Vamana (S=4, R=32, l=64) on the 1M base,
    ``ShardedGraphEngine`` in both layouts (plain, ``expand=4``, local
    rerank), ``ShardedEngine(n_shards=4)`` beside one shard, the partition's
    exact-routed recall, checks (a)–(h), and data-parallel training."""
    import torch

    from repro_torch.dist.fault import resolve_quorum
    from repro_torch.graphs.partition import block_diagonal, build_partitioned_vamana
    from repro_torch.kernels import ops
    from repro_torch.pq import base
    from repro_torch.search import beam
    from repro_torch.search.engine import ShardedEngine, ShardedGraphEngine
    from repro_torch.search.metrics import recall_at_k
    from repro_torch.dist.fault import partial_merge

    times: dict[str, float] = {}
    timed_ = lambda label, fn: timed(times, "sharded", label, fn)
    q, nq, n = ds.queries, ds.queries.shape[0], ds.base.shape[0]
    dev = ds.base.device
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    pg = timed_("build_partitioned_vamana", lambda: build_partitioned_vamana(
        ds.base, SHARDS, generator=torch.Generator().manual_seed(0), r=32, l=64, alpha=1.2,
        batch=args.vamana_batch, verbose=True, device=dev))
    nl = pg.n_local
    codes = {"u8": u8_codes, "fs4": fs4_packed}
    lut_fns = {"u8": lambda qq: base.build_lut(u8_model, qq),
               "fs4": lambda qq: base.build_lut(fs4_model, qq, quantize=True)}
    rows, res, busy, checks = {}, {}, {}, {}
    for lay in ("u8", "fs4"):
        eng = ShardedGraphEngine(pg, codes[lay], lut_fns[lay], n_shards=SHARDS, device=dev)
        rows[lay], res[lay] = search_row(eng, q, gt, f"{lay} ShardedGraphEngine h=32", h=32)
        busy[lay] = device_busy(lambda: eng.search(q, k=10, h=32), nq / rows[lay]["qps"],
                                label=f"{lay} ShardedGraphEngine")
        name = "hop_adc" if lay == "u8" else "hop_adc_fs"
        rows[lay]["kernel_in_search"] = in_search(
            busy[lay], "hop_adc_kernel<" if lay == "u8" else "hop_adc_fs", kernels[name],
            f"{lay} ShardedGraphEngine")
        rows[lay]["busy_share"] = busy[lay]["busy_share"]
        rows[f"{lay}_expand4"], _ = search_row(eng, q, gt, f"{lay} expand=4", h=32, expand=4)
        rer = ShardedGraphEngine(pg, codes[lay], lut_fns[lay], vectors=ds.base,
                                 n_shards=SHARDS, device=dev)
        rows[f"{lay}_rerank"], res[f"{lay}_rerank"] = search_row(
            rer, q, gt, f"{lay} local rerank", h=32)
        # (d) a dead shard: none of its ids, a degraded answer, and no
        # higher recall where the merge ranks by exact distance (the rerank:
        # dropping candidates cannot promote a true neighbour there; on ADC
        # distances it can, so the plain engine's recall is only reported)
        for tag, e in (("", eng), ("_rerank", rer)):
            dead = e.search(q, k=10, h=32, alive=DEAD_SHARD)
            ids = dead.ids.long()
            check(not bool(((ids >= nl) & (ids < 2 * nl)).any()) and dead.degraded,
                  f"(d) {lay}{tag}: a dead shard's id, or an undegraded answer")
            rows[f"{lay}{tag}"]["dead_shard_recall"] = recall_at_k(dead.ids, gt, 10)
        check(rows[f"{lay}_rerank"]["dead_shard_recall"] <= rows[f"{lay}_rerank"]["recall"],
              f"(d) {lay}: a dead shard raised the reranked recall")
        log(f"[sharded] (d) {lay}: shard 1 dead: recall@10 {rows[lay]['recall']:.4f} -> "
            f"{rows[lay]['dead_shard_recall']:.4f} (ADC), reranked "
            f"{rows[lay + '_rerank']['recall']:.4f} -> "
            f"{rows[lay + '_rerank']['dead_shard_recall']:.4f}; no id of shard 1, degraded")
        del rer
        # (a), (b): the lockstep S=4 search equals the four per-shard searches
        for tag, kw in (("a", {}), ("b_seeded_pruned", {"entries": 4, "prune_eps": 0.2}),
                        ("b_max_rounds", {"max_rounds": 5})):
            same = same_search(eng.search(q, k=10, h=32, **kw),
                               per_shard_merge(pg, codes[lay], lut_fns[lay], q, k=10, h=32,
                                               **kw))
            check(same, f"({tag[0]}) {lay} {kw}: the S=4 search differs from the per-shard "
                  f"InMemoryEngine searches merged by partial_merge")
            checks[f"{tag}_{lay}"] = True
        # (e) a straggler past the deadline
        decision = resolve_quorum([True] * SHARDS, STRAGGLER_LATENCY_S, DEADLINE_S)
        check(list(decision.alive) == [True, True, False, True],
              f"(e) resolve_quorum kept {decision.alive}")
        late = eng.search(q, k=10, h=32, deadline_s=DEADLINE_S,
                          shard_latency_s=STRAGGLER_LATENCY_S)
        want = eng.search(q, k=10, h=32, alive=list(decision.alive))
        waited = eng.search(q, k=10, h=32, deadline_s=DEADLINE_S,
                            shard_latency_s=STRAGGLER_LATENCY_S, quorum=SHARDS)
        check(same_search(late, want) and late.degraded,
              f"(e) {lay}: the straggler was not dropped as resolve_quorum says")
        check(same_search(waited, res[lay]) and not waited.degraded,
              f"(e) {lay}: a quorum of {SHARDS} did not wait for the straggler")
        checks[f"d_{lay}"] = checks[f"e_{lay}"] = True
        del eng
    # (c) the reference's bar (tests/test_sharded_graph.py)
    check(rows["u8"]["recall"] >= inmem_recall - 0.05,
          f"(c) S=4 recall {rows['u8']['recall']:.4f} below InMemoryEngine's "
          f"{inmem_recall:.4f} - 0.05")
    for lay in ("u8", "fs4"):
        check(rows[f"{lay}_rerank"]["recall"] >= rows[lay]["recall"],
              f"(c) {lay}: the local rerank lowered recall")
    checks["c"] = True

    # the scan engine: S=4 beside one shard, with and without the rerank
    scan = {}
    for lay in ("u8", "fs4"):
        for s in (1, SHARDS):
            for vec in (False, True):
                eng = ShardedEngine(codes[lay], lut_fns[lay], n_shards=s, device=dev,
                                    vectors=ds.base if vec else None)
                tag = f"{lay}_s{s}" + ("_rerank" if vec else "")
                scan[tag], scan_res = search_row(eng, q, gt, f"{lay} ShardedEngine "
                                                 f"n_shards={s}" + (" + rerank of 40" if vec else ""))
                if not vec:
                    res[f"scan_{lay}_s{s}"] = scan_res
                del eng
        # (f) the S=4 scan's sorted top-10 distances are the one-shard scan's
        one, four = res[f"scan_{lay}_s1"], res[f"scan_{lay}_s{SHARDS}"]
        check(torch.equal(one.dists, four.dists),
              f"(f) {lay}: the S=4 scan's top-10 distances differ from one shard's")
        scan[f"{lay}_same_ids_share"] = float((one.ids == four.ids).all(dim=1).float().mean())
        checks[f"f_{lay}"] = True
        log(f"[sharded] (f) {lay}: S=4 top-10 distances equal one shard's; ids equal on "
            f"{scan[f'{lay}_same_ids_share']:.4f} of queries (the rest differ among equal "
            f"distances)")

    # (g) the partition's own recall under exact routing, merged over shards
    nbrs, medoids = block_diagonal(pg)
    vec_p = ops.pad_sentinel_row(ops.pad_rows_to_multiple(ds.base, SHARDS))
    rx = beam.beam_search(nbrs, medoids.repeat(nq), q, beam.make_exact_dist_fn(vec_p), h=32,
                          max_steps=512, lanes_per_query=SHARDS)
    ids, d = rx.ids[:, :10].long(), rx.dists[:, :10]
    ok = (ids < n) & torch.isfinite(d)
    ids = torch.where(ok, ids, -1).reshape(nq, SHARDS, 10)
    d = torch.where(ok, d, float("inf")).reshape(nq, SHARDS, 10)
    merged = partial_merge([ids[:, s] for s in range(SHARDS)], [d[:, s] for s in range(SHARDS)],
                           [True] * SHARDS, 10)
    exact_recall = recall_at_k(merged.ids, gt, 10)
    del vec_p, rx, nbrs
    log(f"[sharded] partition recall@10 under exact routing (h=32, merged over {SHARDS} "
        f"shards): {exact_recall:.4f}")
    check(exact_recall >= MIN_PARTITION_EXACT_RECALL,
          f"(g) the partition routes badly: exact recall@10 {exact_recall:.4f}")
    checks["g"] = True

    train = {"single": dp_train(ds, graph, u8_model, False),
             "dp4": dp_train(ds, graph, u8_model, True)}
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # (h) the phase ran its kernels
    for name in ("hop_adc", "hop_adc_fs", "adc_scan_batch", "adc_scan_fs"):
        check(counts[name] > 0, f"(h) kernel {name} was not launched by the sharded phase")
    checks["h_kernels"] = True
    log(f"[sharded] launches: { {k: v for k, v in counts.items() if v} }; checks {checks}")
    return dict(times=times, rows=rows, scan=scan, exact_recall=exact_recall, train=train,
                checks=checks, launches=counts, peak_gib=peak_gb, n_local=nl,
                busy={k: {kk: v for kk, v in b.items() if kk != "per_kernel"}
                      for k, b in busy.items()})


# --------------------------------------------------------------------------
# phase 15: the paper's other graphs and its learned baseline
# --------------------------------------------------------------------------

# benchmarks/paper_tables.py:85-86 and benchmarks/common.py:73-77
HNSW_M = 12
NSG_R, NSG_K, NSG_L = 24, 32, 32
# The multiple of M=16 nearest the paper's d_out=40, which the reference's
# own train_pq assert rejects at M=16.
CATALYST_D_OUT = 48
CATALYST_STEPS = 1000


@contextlib.contextmanager
def knn_seconds(module, spent: list):
    """While open, ``module.knn_ids`` appends its synchronized wall seconds
    to ``spent`` (a builder's kNN share)."""
    import torch

    inner = module.knn_ids

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    module.knn_ids = wrapper
    try:
        yield spent
    finally:
        module.knn_ids = inner


@contextlib.contextmanager
def nsg_repair_log(module, out: dict):
    """While open, NSG's connectivity repair records its seconds, the
    nodes a BFS from the medoid misses before each adoption pass
    (``missing_per_pass``: the first is the reference's one pass) and
    after the last."""
    inner_repair, inner_adopt = module._repair_connectivity, module._adopt

    def repair(x, nbrs, medoid, r):
        out["missing_per_pass"] = []
        t0 = time.perf_counter()
        fixed = inner_repair(x, nbrs, medoid, r)
        out["repair_s"] = time.perf_counter() - t0
        out["unreachable_after"] = len(module.unreachable(fixed, medoid))
        return fixed

    def adopt(x, nbrs, missing, r):
        out["missing_per_pass"].append(len(missing))
        inner_adopt(x, nbrs, missing, r)

    module._repair_connectivity, module._adopt = repair, adopt
    try:
        yield out
    finally:
        module._repair_connectivity, module._adopt = inner_repair, inner_adopt


def adjacency_ok(nbrs, max_degree: int) -> bool:
    """Degree ≤ ``max_degree`` (the table's width), no self edge, every id
    in [0, n] (n the sentinel)."""
    import torch

    n = nbrs.shape[0]
    return (nbrs.shape[1] == max_degree and int(nbrs.min()) >= 0 and int(nbrs.max()) <= n
            and not bool((nbrs.long() == torch.arange(n, device=nbrs.device)[:, None]).any()))


def pgraphs_path(args, ds, gt, graph, pq_model, pq_codes, rpq_model, rpq_codes,
                 kernels: dict, train_s: dict) -> dict:
    """Phase 15: HNSW (m=12) and NSG (r=24, k=32, search_l=32) on the 1M
    base, OPQ and Catalyst trained here, the PQ, OPQ and RPQ codes served
    over both graphs (HNSW with ``entry_fn=descend``), Catalyst's codes over
    phase 5's Vamana graph, and checks (a)–(e)."""
    import torch

    from repro_torch.graphs import build_hnsw, build_nsg, descend, degree_stats
    from repro_torch.graphs.knn import knn_ids
    from repro_torch.graphs import hnsw as hnsw_mod
    from repro_torch.graphs import nsg as nsg_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.pq import base, catalyst, train_opq
    from repro_torch.search import beam
    from repro_torch.search.engine import HybridEngine, InMemoryEngine
    from repro_torch.search.metrics import recall_at_k

    times: dict[str, float] = {}
    timed_ = lambda label, fn: timed(times, "pgraphs", label, fn)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    q, nq, n = ds.queries, ds.queries.shape[0], ds.base.shape[0]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    checks, build = {}, {}

    # one exact kNN of the base serves HNSW's layer 0 (k = 4m = 48) and NSG
    # (its first NSG_K columns; bit for bit the k=32 kNN, a CPU test holds it)
    knn = timed_("shared_knn", lambda: knn_ids(ds.base, ds.base, 4 * HNSW_M,
                                               exclude_self=True)[0])
    log(f"[pgraphs] shared exact kNN (k={4 * HNSW_M}) of the base in "
        f"{times['shared_knn']:.2f} s")
    with knn_seconds(hnsw_mod, []) as spent:
        h = timed_("build_hnsw", lambda: build_hnsw(ds.base, generator=gen(2), m=HNSW_M,
                                                    knn0=knn))
    build["hnsw"] = {"s": times["build_hnsw"], "knn_s": sum(spent),
                     "layers": [int(g.n) for g in h.layers],
                     "degree": [degree_stats(g) for g in (h.base, *h.layers)]}
    repair: dict = {}
    with knn_seconds(nsg_mod, []) as spent, nsg_repair_log(nsg_mod, repair):
        g_nsg = timed_("build_nsg", lambda: build_nsg(
            ds.base, r=NSG_R, k=NSG_K, search_l=NSG_L, batch=args.vamana_batch, knn=knn))
    del knn
    build["nsg"] = {"s": times["build_nsg"], "knn_s": sum(spent), **repair,
                    "degree": degree_stats(g_nsg)}
    for name, b in build.items():
        log(f"[pgraphs] {name}: built in {b['s']:.2f} s from the shared kNN, of it exact "
            f"kNN inside the build {b['knn_s']:.2f} s "
            f"({b['knn_s'] / b['s']:.3f}); degree {b['degree']}"
            + (f"; upper layers {b['layers']}" if name == "hnsw" else
               f"; unreachable from the medoid before each adoption pass "
               f"{b['missing_per_pass']}, after the repair {b['unreachable_after']} (repair "
               f"{b['repair_s']:.2f} s)"))
    # (a) degrees, self edges, id range; NSG reachable from its medoid
    check(adjacency_ok(h.base.neighbors, 2 * HNSW_M)
          and all(adjacency_ok(g.neighbors, HNSW_M) for g in h.layers),
          "(a) an HNSW layer has a self edge, an id out of range or a wrong degree")
    check(adjacency_ok(g_nsg.neighbors, NSG_R),
          "(a) NSG has a self edge, an id out of range or a degree above r")
    check(repair["unreachable_after"] == 0,
          f"(a) {repair['unreachable_after']} NSG nodes unreachable from the medoid after "
          f"the repair")
    checks["a"] = True

    opq = timed_("train_opq", lambda: train_opq(ds.train, 16, 256, generator=gen(3),
                                                outer_iters=4, kmeans_iters=8))
    cm, losses = timed_("train_catalyst", lambda: catalyst.train_catalyst(
        ds.train, 16, 256, generator=gen(4), d_out=CATALYST_D_OUT, steps=CATALYST_STEPS))
    opq_codes = timed_("encode_opq", lambda: base.encode(opq, ds.base))
    cat_codes = timed_("encode_catalyst", lambda: catalyst.encode(cm, ds.base))
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    cost = {"pq": {"train_s": train_s["pq"], "bytes": nbytes(pq_model.r, pq_model.codebooks)},
            "opq": {"train_s": times["train_opq"], "bytes": nbytes(opq.r, opq.codebooks)},
            "catalyst": {"train_s": times["train_catalyst"],
                         "bytes": nbytes(*cm.net, cm.pq.r, cm.pq.codebooks)},
            "rpq": {"train_s": train_s["rpq"],
                    "bytes": nbytes(rpq_model.r, rpq_model.codebooks)}}
    log(f"[pgraphs] training s and model bytes (Tables 4-5): {cost}")
    losses_finite = bool(torch.isfinite(losses).all())
    log(f"[pgraphs] catalyst (d_out={CATALYST_D_OUT}, {CATALYST_STEPS} steps): loss "
        f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}, finite at every step "
        f"{losses_finite}")

    lut_fns = {"pq": lambda qq: base.build_lut(pq_model, qq),
               "opq": lambda qq: base.build_lut(opq, qq),
               "rpq": lambda qq: base.build_lut(rpq_model, qq)}
    codes = {"pq": pq_codes, "opq": opq_codes, "rpq": rpq_codes}
    entry_fn = lambda qq: descend(h, qq, ds.base)
    descend_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entries = entry_fn(q)
        torch.cuda.synchronize()
        descend_ms.append((time.perf_counter() - t0) * 1e3)
    rows, res, engines = {}, {}, {}
    for gname, g, efn in (("hnsw", h.base, entry_fn), ("nsg", g_nsg, None)):
        for qn in ("pq", "opq", "rpq"):
            tag = f"{gname}_{qn}"
            engines[tag] = InMemoryEngine(g, codes[qn], lut_fns[qn], entry_fn=efn)
            rows[tag], res[tag] = search_row(engines[tag], q, gt, f"{gname.upper()}-"
                                             f"{qn.upper()} InMemoryEngine h=32", h=32,
                                             tag="pgraphs")
    rows["hnsw_descend_ms"] = statistics.median(descend_ms)
    log(f"[pgraphs] HNSW descent alone for {nq} queries: {rows['hnsw_descend_ms']:.2f} ms "
        f"(median of 3), {rows['hnsw_descend_ms'] * rows['hnsw_pq']['qps'] / nq / 10:.1f}% of "
        f"an HNSW-PQ batch")
    # (b) kernel-routed top-10 equals the plain-routed one, from the same entries
    for tag, g, ent in (("hnsw_pq", h.base, entries), ("nsg_pq", g_nsg, g_nsg.medoid)):
        codes_p = ops.pad_sentinel_row(pq_codes)
        res_p = beam.beam_search(g.neighbors, ent, lut_fns["pq"](q),
                                 lambda luts, ids: ref.hop_adc_ref(codes_p, ids, luts),
                                 h=32, max_steps=512)
        same = float((res_p.ids[:, :10] == res[tag].ids).all(dim=1).float().mean())
        rows[tag]["same_top10_plain"] = same
        log(f"[pgraphs] (b) {tag}: top-10 identical with the plain hop_adc routing on "
            f"{same:.4f} of queries")
        check(same >= 0.99, f"(b) {tag}: kernel-routed and plain-routed searches disagree")
    checks["b"] = True

    # Figure 5: Catalyst codes over phase 5's Vamana graph (and OPQ's beside)
    cat_lut = lambda qq: catalyst.build_lut(cm, qq)
    for tag, eng in (("vamana_catalyst_hybrid", HybridEngine(graph, cat_codes, cat_lut,
                                                             vectors=ds.base)),
                     ("vamana_catalyst_inmemory", InMemoryEngine(graph, cat_codes, cat_lut)),
                     ("vamana_opq_hybrid", HybridEngine(graph, opq_codes, lut_fns["opq"],
                                                        vectors=ds.base))):
        rows[tag], res[tag] = search_row(eng, q, gt, tag, h=32, tag="pgraphs")
    adc = catalyst.adc(cm, cat_codes, q)
    plain = ref.adc_scan_batch_ref(cat_codes, cat_lut(q))
    adc_equal = bool(torch.equal(adc, plain))
    del plain
    rows["catalyst_exhaustive_adc_recall"] = recall_at_k(
        torch.topk(adc, 10, dim=1, largest=False).indices, gt, 10)
    del adc
    log(f"[pgraphs] (d) catalyst adc equals the plain adc_scan_batch on {nq} queries: "
        f"{adc_equal}; exhaustive ADC recall@10 {rows['catalyst_exhaustive_adc_recall']:.4f}")
    check(losses_finite, "(d) a Catalyst training loss is not finite")
    check(adc_equal, "(d) catalyst.adc differs from the plain adc_scan_batch")
    check(rows["vamana_catalyst_hybrid"]["recall"] >= rows["vamana_catalyst_inmemory"]["recall"],
          "(d) Catalyst's HybridEngine recall is below its InMemoryEngine recall")
    checks["d"] = True

    # (c) each graph's own recall under exact routing (HNSW from its descent)
    ex = beam.make_exact_dist_fn(ops.pad_sentinel_row(ds.base))
    exact = {}
    for gname, g, ent in (("hnsw", h.base, entries), ("nsg", g_nsg, g_nsg.medoid)):
        rx = beam.beam_search(g.neighbors, ent, q, ex, h=32, max_steps=512)
        exact[gname] = recall_at_k(rx.ids[:, :10], gt, 10)
    del ex, rx
    log(f"[pgraphs] (c) recall@10 under exact routing (h=32): HNSW {exact['hnsw']:.4f} "
        f"(floor {MIN_EXACT_RECALL_HNSW}), NSG {exact['nsg']:.4f} (floor {MIN_EXACT_RECALL_NSG})")
    check(exact["hnsw"] >= MIN_EXACT_RECALL_HNSW,
          f"(c) HNSW routes badly: exact recall@10 {exact['hnsw']:.4f}")
    check(exact["nsg"] >= MIN_EXACT_RECALL_NSG,
          f"(c) NSG routes badly: exact recall@10 {exact['nsg']:.4f}")
    checks["c"] = True

    busy = device_busy(lambda: engines["hnsw_pq"].search(q, k=10, h=32),
                       nq / rows["hnsw_pq"]["qps"], label="HNSW-PQ InMemoryEngine")
    rows["hnsw_pq"]["busy_share"] = busy["busy_share"]
    rows["hnsw_pq"]["kernel_in_search"] = in_search(busy, "hop_adc_kernel<", kernels["hop_adc"],
                                                    "HNSW-PQ InMemoryEngine")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # (e) the phase ran its kernels
    for name in ("pq_pairwise", "hop_adc", "adc_scan_batch"):
        check(counts[name] > 0, f"(e) kernel {name} was not launched by the pgraphs phase")
    checks["e"] = True
    log(f"[pgraphs] launches: { {k: v for k, v in counts.items() if v} }; peak device memory "
        f"{peak_gb:.2f} GiB; checks {checks}")
    return dict(times=times, build=build, cost=cost, rows=rows, exact_recall=exact,
                catalyst_losses=[float(losses[0]), float(losses[-1])], checks=checks,
                launches=counts, peak_gib=peak_gb,
                busy={k: v for k, v in busy.items() if k != "per_kernel"})


# --------------------------------------------------------------------------
# phase 16: the model zoo (dense and MoE LMs, GAT, recsys)
# --------------------------------------------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the model-FLOPs
# share of an LM train step is 6 · active params · tokens over it.
BF16_FLOPS = 989e12
# (b) granite-moe-1b-a400m trains at train_4k's sequence length on 8 rows
# (train_4k's global batch of 256 cut to 8: one card), 3 steps of one batch;
# then prefill 8 × 2048 and 8 decode steps against forward.
ARCHS_TRAIN = ("granite-moe-1b-a400m", 8, 4096, 3)
ARCHS_DECODE_CHECK = (8, 2048, 8)
# (c) granite-3-8b serves decode_32k's cache length on 8 rows (its global
# batch of 128 cut to 8): prefill 8 × 2048 into 32,768 slots, 16 decodes.
ARCHS_SERVE = ("granite-3-8b", 8, 2048, 32768, 16)
# (d) recsys at train_batch / serve_p99; Bert4Rec's MLM step at 4,096 rows
# (its 20 scored positions' f32 logits over 26,880 items take 17.6 GB a
# copy at 8,192, and the loss's backward holds four); DLRM's 26 tables
# capped at 1,000,000 rows each (the MLPerf tables, ~188M rows, ~96 GB in
# f32, do not fit one card).
ARCHS_RECSYS = dict(train=65536, serve=512, bert4rec_train=4096, mlm_positions=20,
                    dlrm_rows_cap=1_000_000)
# Decode against forward: per-row relative L2 error of the logits, and the
# share of rows whose top-1 token agrees. bf16 rounds at 2^-8 relative and
# the two paths round differently (chunked attention vs the full score
# matrix, other product shapes) through 24 residual layers.
ARCHS_DECODE_TOL = dict(rel_l2=0.05, top1=0.95)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0


def _reset_peak(dev) -> None:
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _tree_to(tree, dev):
    from repro_torch.common.treeutil import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def _adam_step(loss_fn, params, lr: float):
    """One Adam step of ``loss_fn`` from fresh slots (the reference's
    optimizer): (new params, loss)."""
    from repro_torch.common import adam, constant_schedule
    from repro_torch.models import layers as nn

    opt = adam(constant_schedule(lr))
    loss, g = nn.value_and_grad(loss_fn, params)
    return opt.update(g, opt.init(params), params)[0], loss


def _tree_gap(a, b) -> tuple[float, float]:
    """(max |a − b|, share of entries within 1e-4 relative + 1e-6) over two
    param trees, ``a`` on any device, ``b`` on the CPU."""
    import torch

    from repro_torch.common.treeutil import tree_leaves

    gap, near, n = 0.0, 0, 0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.detach().cpu().float() - y.float()).abs()
        gap = max(gap, float(d.max()))
        near += int((d <= 1e-4 * y.float().abs() + 1e-6).sum())
        n += d.numel()
    return gap, near / max(n, 1)


def _recsys_batch(arch: str, cfg, b: int, rng, dev) -> dict:
    """A synthetic batch of ``arch``'s inputs (numpy draws from ``rng``)."""
    import numpy as np
    import torch

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    label = t((rng.random(b) < 0.25).astype(np.float32))
    if arch == "dlrm-mlperf":
        rows = np.asarray(cfg.row_counts)
        return {"dense": t(rng.standard_normal((b, cfg.n_dense), dtype=np.float32)),
                "sparse": t((rng.random((b, len(rows))) * rows).astype(np.int32)),
                "label": label}
    if arch == "deepfm":
        rows = np.asarray(cfg.row_counts)
        return {"sparse": t((rng.random((b, len(rows))) * rows).astype(np.int32)),
                "label": label}
    if arch == "din":
        n = rng.integers(1, cfg.seq_len + 1, (b, 1))
        return {"hist": t(rng.integers(0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)),
                "mask": t(np.arange(cfg.seq_len)[None, :] < n),
                "target": t(rng.integers(0, cfg.n_items, b).astype(np.int32)),
                "label": label}
    p = ARCHS_RECSYS["mlm_positions"]
    items = rng.integers(0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)
    pos = np.stack([rng.permutation(cfg.seq_len)[:p] for _ in range(b)]).astype(np.int32)
    labels = np.take_along_axis(items, pos, 1)
    np.put_along_axis(items, pos, cfg.mask_token, 1)
    return {"items": t(items), "pad": t(np.ones((b, cfg.seq_len), bool)),
            "pos": t(pos), "labels": t(labels)}


def _recsys_fns(arch: str, cfg):
    """(init, forward(params, batch), loss(params, batch)) of ``arch``."""
    from repro_torch.models import recsys as rs

    if arch == "dlrm-mlperf":
        fwd = lambda p, b: rs.dlrm_forward(cfg, p, b["dense"], b["sparse"])
        init = rs.init_dlrm
    elif arch == "deepfm":
        fwd = lambda p, b: rs.deepfm_forward(cfg, p, b["sparse"])
        init = rs.init_deepfm
    elif arch == "din":
        fwd = lambda p, b: rs.din_forward(cfg, p, b["hist"], b["mask"], b["target"])
        init = rs.init_din
    else:
        fwd = lambda p, b: rs.bert4rec_encode(cfg, p, b["items"], b["pad"])
        return rs.init_bert4rec, fwd, lambda p, b: rs.bert4rec_mlm_loss(
            cfg, p, b["items"], b["pad"], b["pos"], b["labels"])
    return init, fwd, lambda p, b: rs.bce_loss(fwd(p, b), b["label"])


def _gat_graph(cfg, n: int, e: int, rng, dev):
    """A synthetic graph of n nodes and e directed edges: features, src,
    dst, labels and a label mask (numpy draws from ``rng``)."""
    import numpy as np
    import torch

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t((rng.random((n, cfg.d_in)) < 0.0127).astype(np.float32)),  # Cora: ~18 words
            t(rng.integers(0, n, e).astype(np.int32)), t(rng.integers(0, n, e).astype(np.int32)),
            t(rng.integers(0, cfg.n_classes, n).astype(np.int32)), t(rng.random(n) < 0.5))


def archs_reduced(dev) -> dict:
    """(a) Every registry arch but ``rpq`` at its reduced config, one set of
    params made on the CPU: the train step (and prefill + decode for the
    LMs) on ``dev`` and on the CPU. Losses within 1e-5 relative, logits
    within 1e-3, params after the step within the step's size (2·lr:
    Adam's first step turns on a gradient's last bits where |g| is near
    1e-8) and 99% of them within 1e-4 relative."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.data import lm_batch
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tf

    cpu = torch.device("cpu")
    rows = {}
    for arch in list_archs():
        spec = get_arch(arch)
        if spec.family == "rpq":
            continue
        cfg = spec.make_reduced()
        gen = torch.Generator().manual_seed(16)
        rng = np.random.default_rng(16)
        out = {}
        if spec.family == "lm":
            lr = 1e-3
            fns = tf.make_train_step(cfg, lr=lr)
            params = fns.init(gen, device=cpu)
            toks, labels = (torch.from_numpy(a) for a in lm_batch(16, 4, 16, cfg.vocab))
            for where in (dev, cpu):
                p = _tree_to(params, where)
                p2, _, loss = fns.train_step(p, fns.opt_init(p), toks.to(where),
                                             labels.to(where))
                lg, cache = tf.prefill(cfg, p2, toks[:, :-1].to(where), max_len=20)
                dec, cache = tf.decode_step(cfg, p2, cache, toks[:, -1].to(where))
                out[where.type] = (p2, loss, torch.cat([lg, dec]).cpu())
        elif spec.family == "gnn":
            lr = 5e-3
            init, step, opt_init = gnn.make_train_step(cfg)
            params = init(gen, device=cpu)
            graph = _gat_graph(cfg, 64, 256, rng, cpu)
            for where in (dev, cpu):
                p = _tree_to(params, where)
                p2, _, loss = step(p, opt_init(p), *(a.to(where) for a in graph))
                out[where.type] = (p2, loss, None)
        else:
            lr = 1e-3
            init, _, loss_fn = _recsys_fns(arch, cfg)
            params = init(gen, cfg, device=cpu)
            batch = _recsys_batch(arch, cfg, 32, rng, cpu)
            for where in (dev, cpu):
                b = _tree_to(batch, where)
                p2, loss = _adam_step(lambda p: loss_fn(p, b), _tree_to(params, where), lr)
                out[where.type] = (p2, loss, None)
        (gp, gl, glog), (cp, cl, clog) = out[dev.type], out["cpu"]
        gap, near = _tree_gap(gp, cp)
        row = dict(loss_dev=float(gl), loss_cpu=float(cl),
                   loss_rel=abs(float(gl) - float(cl)) / max(abs(float(cl)), 1e-30),
                   params_max_abs=gap, params_near=near,
                   logits_max_abs=None if glog is None else float((glog - clog).abs().max()))
        log(f"[archs] (a) {arch} reduced, {dev.type} vs cpu: loss {row['loss_dev']:.6f} vs "
            f"{row['loss_cpu']:.6f} (rel {row['loss_rel']:.2e}, tol 1e-5); params after the "
            f"step max|d| {gap:.2e} (tol {2 * lr:g}), {near:.4f} within 1e-4 rel (tol 0.99)"
            + ("" if glog is None else
               f"; prefill+decode logits max|d| {row['logits_max_abs']:.2e} (tol 1e-3)"))
        check(math.isfinite(row["loss_dev"]) and row["loss_rel"] <= 1e-5,
              f"(a) {arch}: the card's loss differs from the CPU's")
        check(gap <= 2 * lr + 1e-5 and near >= 0.99,
              f"(a) {arch}: the card's params after the step differ from the CPU's")
        check(glog is None or row["logits_max_abs"] <= 1e-3,
              f"(a) {arch}: the card's prefill/decode logits differ from the CPU's")
        rows[arch] = row
    return rows


def _decode_vs_forward(cfg, params, b: int, s: int, n_dec: int, dev) -> dict:
    """Prefill ``s`` tokens, decode ``n_dec`` more teacher-forced, and hold
    the prefill's and each step's logits against forward's at the same
    position, over a
    forward of ``s`` plus a multiple of 128 tokens (so MoE groups of 1024
    tile it)."""
    import torch

    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as tf

    total = s + max(128, -(-n_dec // 128) * 128)
    toks = torch.from_numpy(lm_batch(7, b, total, cfg.vocab)[0]).to(dev)
    logits, cache = tf.prefill(cfg, params, toks[:, :s], max_len=s + n_dec)
    got = [logits]
    for i in range(n_dec):
        logits, cache = tf.decode_step(cfg, params, cache, toks[:, s + i])
        got.append(logits)
    with torch.no_grad():
        full = tf.forward(cfg, params, toks)[0][:, s - 1:s + n_dec]
    got = torch.stack(got, dim=1)                                 # (B, n_dec, V)
    v = cfg.vocab
    got, full = got[..., :v], full[..., :v]
    rel = ((got - full).norm(dim=-1) / full.norm(dim=-1)).flatten()
    top1 = (got.argmax(-1) == full.argmax(-1)).float().mean()
    return dict(rows=int(rel.numel()), rel_l2_max=float(rel.max()),
                rel_l2_median=float(rel.median()), max_abs=float((got - full).abs().max()),
                top1=float(top1), finite=bool(torch.isfinite(got).all()))


def archs_train(dev, arch: str, b: int, s: int, steps: int) -> dict:
    """(b) ``arch`` at its full published config: ``steps`` train steps on
    one fixed ``lm_batch`` of b × s, then decode against forward."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as tf

    cfg = get_arch(arch).make_config()
    _reset_peak(dev)
    fns = tf.make_train_step(cfg, lr=3e-4)
    params = fns.init(torch.Generator(dev).manual_seed(0), device=dev)
    opt = fns.opt_init(params)
    toks, labels = (torch.from_numpy(a).to(dev) for a in lm_batch(0, b, s, cfg.vocab))
    losses, secs = [], []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, loss = fns.train_step(params, opt, toks, labels)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
    step_s = statistics.median(secs)
    out = dict(config=dict(layers=cfg.n_layers, d_model=cfg.d_model, params=cfg.param_count,
                           active=cfg.active_param_count, batch=b, seq=s,
                           microbatches=cfg.microbatches, remat=cfg.remat),
               losses=losses, step_s=secs, step_ms_median=step_s * 1e3,
               tokens_per_s=b * s / step_s,
               mfu=6 * cfg.active_param_count * b * s / (step_s * BF16_FLOPS),
               peak_gib=_peak_gib(dev))
    log(f"[archs] (b) {arch} full ({cfg.n_layers}L d={cfg.d_model}, {cfg.param_count / 1e9:.3f}B "
        f"params, {cfg.active_param_count / 1e9:.3f}B active, bf16, microbatches "
        f"{cfg.microbatches}, remat {cfg.remat}) train {b} x {s}: losses {losses}, step ms "
        f"{[round(x * 1e3, 1) for x in secs]} (median {out['step_ms_median']:.1f}), "
        f"{out['tokens_per_s']:.0f} tokens/s, model-FLOPs share {out['mfu']:.4f} of "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, peak {out['peak_gib']:.2f} GiB")
    check(all(math.isfinite(x) for x in losses), f"(b) {arch}: a loss is not finite")
    check(losses[-1] < losses[0], f"(b) {arch}: the loss did not fall on the repeated batch")
    del opt
    db, ds, dn = ARCHS_DECODE_CHECK
    _reset_peak(dev)
    t0 = time.perf_counter()
    out["decode"] = _decode_vs_forward(cfg, params, db, ds, dn, dev)
    # routing per token: with capacity factor E / k no expert can overflow,
    # so forward's 1024-token groups and decode's 8 route alike
    if cfg.moe:
        wide = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        out["decode_no_drop"] = _decode_vs_forward(wide, params, db, ds, dn, dev)
    out["decode_s"] = time.perf_counter() - t0
    out["decode_peak_gib"] = _peak_gib(dev)
    for key in ("decode", "decode_no_drop"):
        if key in out:
            d = out[key]
            log(f"[archs] (b) {arch} {key}: prefill {db} x {ds} + {dn} decode steps vs "
                f"forward over {d['rows']} rows: rel L2 max {d['rel_l2_max']:.4f} median "
                f"{d['rel_l2_median']:.4f} (tol {ARCHS_DECODE_TOL['rel_l2']}), max|d| "
                f"{d['max_abs']:.4f}, top-1 equal {d['top1']:.4f} (tol "
                f"{ARCHS_DECODE_TOL['top1']})")
    gate = out["decode_no_drop" if cfg.moe else "decode"]
    check(gate["finite"] and gate["rel_l2_max"] <= ARCHS_DECODE_TOL["rel_l2"]
          and gate["top1"] >= ARCHS_DECODE_TOL["top1"],
          f"(b) {arch}: decode disagrees with forward")
    return out


def archs_serve(dev, arch: str, b: int, s: int, max_len: int, n_dec: int) -> dict:
    """(c) ``arch`` at its full published config, serving only: prefill
    b × s into a ``max_len``-slot cache written in place, then ``n_dec``
    decode steps, each beside its HBM bound (weights plus the whole cache
    read once a step)."""
    import torch

    from repro_torch.common.treeutil import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as tf

    cfg = get_arch(arch).make_config()
    _reset_peak(dev)
    t0 = time.perf_counter()
    params = tf.init_lm(torch.Generator(dev).manual_seed(1), cfg, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    toks = torch.from_numpy(lm_batch(8, b, s + n_dec, cfg.vocab)[0]).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = tf.prefill(cfg, params, toks[:, :s], max_len=max_len)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    ms = []
    for i in range(n_dec):
        t0 = time.perf_counter()
        logits, cache = tf.decode_step(cfg, params, cache, toks[:, s + i])
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    if dev.type == "cuda":   # one more step, traced: where a decode step's time goes
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits, cache = tf.decode_step(cfg, params, cache, toks[:, s + n_dec - 1])
            _sync(dev)
        trace = kernel_times(prof, "archs", f"(c) {arch} one decode step",
                             statistics.median(ms))
        trace.pop("per_kernel", None)
    else:
        trace = None
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    c_bytes = 2 * cache.k.numel() * cache.k.element_size()
    bound_ms = (w_bytes + c_bytes) / HBM_BYTES_S * 1e3
    out = dict(config=dict(layers=cfg.n_layers, d_model=cfg.d_model, params=cfg.param_count,
                           batch=b, prompt=s, cache_slots=max_len, decode_steps=n_dec),
               init_s=init_s, prefill_s=prefill_s, decode_ms=ms,
               decode_ms_median=statistics.median(ms), weight_bytes=w_bytes,
               cache_bytes=c_bytes, decode_bound_ms=bound_ms, peak_gib=_peak_gib(dev),
               length=int(cache.length), trace=trace)
    log(f"[archs] (c) {arch} full ({cfg.n_layers}L, {cfg.param_count / 1e9:.3f}B params, "
        f"{w_bytes / 1e9:.2f} GB bf16; cache {max_len} slots x {b} rows, {c_bytes / 1e9:.2f} "
        f"GB): init {init_s:.2f} s, prefill {b} x {s} {prefill_s:.3f} s, decode ms "
        f"{[round(x, 2) for x in ms]} (median {out['decode_ms_median']:.2f}, HBM bound "
        f"{bound_ms:.2f}: weights + whole cache once a step), peak {out['peak_gib']:.2f} GiB")
    check(bool(torch.isfinite(logits).all()), f"(c) {arch}: decode logits not finite")
    check(out["length"] == s + n_dec + (trace is not None),
          f"(c) {arch}: the cache length is {out['length']}")
    return out


def archs_recsys(dev, train_b: int, serve_b: int, b4r_b: int, rows_cap: int) -> dict:
    """(d) DeepFM, DIN, Bert4Rec and DLRM (tables capped at ``rows_cap``
    rows) at their published widths: one train step each (BCE; Bert4Rec's
    MLM at ``b4r_b``), then the forward's device ms at ``serve_b``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.common.treeutil import tree_leaves
    from repro_torch.configs import get_arch

    out = {}
    for seed, arch in enumerate(("deepfm", "din", "bert4rec", "dlrm-mlperf")):
        cfg = get_arch(arch).make_config()
        if arch == "dlrm-mlperf":
            cfg = dataclasses.replace(cfg, row_counts=tuple(min(r, rows_cap)
                                                            for r in cfg.row_counts))
        _reset_peak(dev)
        init, fwd, loss_fn = _recsys_fns(arch, cfg)
        params = init(torch.Generator(dev).manual_seed(2), cfg, device=dev)
        rng = np.random.default_rng(1600 + seed)
        b = b4r_b if arch == "bert4rec" else train_b
        batch = _recsys_batch(arch, cfg, b, rng, dev)
        _sync(dev)
        t0 = time.perf_counter()
        params, loss = _adam_step(lambda p: loss_fn(p, batch), params, 1e-3)
        loss = float(loss)
        step_s = time.perf_counter() - t0
        serve = _recsys_batch(arch, cfg, serve_b, rng, dev)
        with torch.no_grad():
            y = fwd(params, serve)
            fwd_ms = cuda_ms(lambda: fwd(params, serve), iters=20) if dev.type == "cuda" else None
        n_params = sum(t.numel() for t in tree_leaves(params))
        out[arch] = dict(train_batch=b, loss=loss, step_s=step_s, serve_batch=serve_b,
                         forward_ms=fwd_ms, params=n_params, peak_gib=_peak_gib(dev))
        log(f"[archs] (d) {arch} ({n_params / 1e6:.1f}M params): train step at {b} "
            f"loss {loss:.4f} in {step_s:.3f} s; forward at {serve_b}: "
            f"{'not measured' if fwd_ms is None else f'{fwd_ms:.3f} ms'}; peak "
            f"{out[arch]['peak_gib']:.2f} GiB")
        check(math.isfinite(loss) and bool(torch.isfinite(y).all()),
              f"(d) {arch}: loss or forward not finite")
        del params, batch, serve, y
    return out


def archs_gnn(dev, graph_nodes: int, graph_edges: int, steps: int, molecule: dict,
              minibatch: dict) -> dict:
    """(d) GAT-cora at its config on a synthetic graph of Cora's shape,
    ``steps`` train steps (the loss falls); one ``graph_pool_loss`` step at
    the molecule shape; one ``sample_block`` at minibatch_lg over a
    synthetic CSR of that shape's node and edge counts, and a forward on
    the block."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import gnn

    cfg = get_arch("gat-cora").make_config()
    _reset_peak(dev)
    rng = np.random.default_rng(160)
    init, step, opt_init = gnn.make_train_step(cfg)
    params = init(torch.Generator(dev).manual_seed(3), device=dev)
    opt = opt_init(params)
    graph = _gat_graph(cfg, graph_nodes, graph_edges, rng, dev)
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, loss = step(params, opt, *graph)
        losses.append(float(loss))
    train_s = time.perf_counter() - t0
    log(f"[archs] (d) gat-cora: {steps} train steps on {graph_nodes} nodes / {graph_edges} "
        f"edges / {cfg.d_in} features in {train_s:.3f} s, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "(d) gat-cora: the loss did not fall")
    # molecule: batched small graphs, mean-pooled
    nb, n_per, e_per = molecule["batch"], molecule["n_nodes"], molecule["n_edges"]
    base = np.repeat(np.arange(nb) * n_per, e_per)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    mol = (t((rng.random((nb * n_per, cfg.d_in)) < 0.05).astype(np.float32)),
           t((rng.integers(0, n_per, nb * e_per) + base).astype(np.int32)),
           t((rng.integers(0, n_per, nb * e_per) + base).astype(np.int32)),
           t(np.repeat(np.arange(nb), n_per).astype(np.int32)))
    y = t(rng.integers(0, cfg.n_classes, nb).astype(np.int32))
    _, mol_loss = _adam_step(lambda p: gnn.graph_pool_loss(cfg, p, *mol, nb, y), params, 5e-3)
    mol_loss = float(mol_loss)
    # minibatch_lg: a synthetic CSR of the shape's node and edge counts
    n, e = minibatch["n_nodes"], minibatch["n_edges"]
    t0 = time.perf_counter()
    indptr = np.concatenate([[0], np.sort(rng.integers(0, e, n - 1)), [e]]).astype(np.int64)
    indices = rng.integers(0, n, e)
    feats = rng.random((n, cfg.d_in), dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, n)
    csr_s = time.perf_counter() - t0
    seeds = rng.choice(n, minibatch["batch_nodes"], replace=False)
    t0 = time.perf_counter()
    blk = gnn.sample_block(rng, indptr, indices, feats, labels, seeds,
                           tuple(minibatch["fanout"]), device=dev)
    _sync(dev)
    sample_s = time.perf_counter() - t0
    with torch.no_grad():
        h = gnn.forward(cfg, params, blk.feats, blk.src, blk.dst, edge_mask=blk.edge_mask)
    check(math.isfinite(mol_loss) and bool(torch.isfinite(h).all()),
          "(d) gat-cora: the molecule loss or the block forward is not finite")
    out = dict(losses=losses, train_s=train_s, molecule_loss=mol_loss, csr_s=csr_s,
               sample_s=sample_s, block_nodes=int(blk.feats.shape[0]),
               block_edges=int(blk.src.shape[0]), block_live_edges=int(blk.edge_mask.sum()),
               peak_gib=_peak_gib(dev))
    log(f"[archs] (d) gat-cora molecule ({nb} graphs x {n_per} nodes / {e_per} edges): "
        f"graph_pool_loss step loss {mol_loss:.4f}; sample_block over a {n}-node / {e}-edge "
        f"CSR (built in {csr_s:.2f} s): {minibatch['batch_nodes']} seeds, fanout "
        f"{tuple(minibatch['fanout'])} -> {out['block_nodes']} node slots, "
        f"{out['block_live_edges']}/{out['block_edges']} edges in {sample_s:.3f} s; forward "
        f"on the block finite; peak {out['peak_gib']:.2f} GiB")
    del indices, feats
    return out


def archs_path(dev) -> dict:
    """Phase 16: (a) every reduced arch on ``dev`` against the CPU, (b) the
    MoE LM training at full width, (c) the dense LM decoding against a 32k
    cache at full width, (d) the recsys models and GAT at their widths."""
    from repro_torch.configs import base
    from repro_torch.device import full_f32_matmul
    from repro_torch.kernels import ops

    full_f32_matmul()
    ops.reset_launch_counts()
    times, out = {}, {}
    t0 = time.perf_counter()
    out["reduced"] = archs_reduced(dev)
    times["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch, b, s, steps = ARCHS_TRAIN
    out["train"] = archs_train(dev, arch, b, s, steps)
    times["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch, b, s, max_len, n_dec = ARCHS_SERVE
    out["serve"] = archs_serve(dev, arch, b, s, max_len, n_dec)
    times["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shapes = {sp.name: sp.dims for sp in base.GNN_SHAPES}
    out["recsys"] = archs_recsys(dev, ARCHS_RECSYS["train"], ARCHS_RECSYS["serve"],
                                 ARCHS_RECSYS["bert4rec_train"],
                                 ARCHS_RECSYS["dlrm_rows_cap"])
    g = shapes["full_graph_sm"]
    out["gnn"] = archs_gnn(dev, g["n_nodes"], g["n_edges"], 20, shapes["molecule"],
                           shapes["minibatch_lg"])
    times["d"] = time.perf_counter() - t0
    _reset_peak(dev)
    out["times"] = times
    out["launches"] = ops.launch_counts()
    log(f"[archs] parts (a)-(d) in s: { {k: round(v, 2) for k, v in times.items()} }; kernel "
        f"launches { {k: v for k, v in out['launches'].items() if v} } (the zoo runs none)")
    return out


# --------------------------------------------------------------------------
# phase 17: the launch harness (dry-run cells), the rpq cells on the card,
# and the four example twins
# --------------------------------------------------------------------------

# the reference's dry-run test cells (tests/test_dryrun_cells.py) and the
# seven rpq cells, checked on meta on both production meshes
LAUNCH_META_CELLS = (("gat-cora", "molecule"), ("deepfm", "serve_p99"),
                     ("granite-moe-1b-a400m", "long_500k"), ("rpq", "quant_train"),
                     ("rpq", "serve_1m"), ("rpq", "encode_bulk"), ("rpq", "adc_bulk"),
                     ("rpq", "sharded_graph"), ("rpq", "sharded_graph_fs4"),
                     ("rpq", "sharded_graph_wide"))
# the card kernel each rpq cell's step must launch
LAUNCH_CARD_KERNELS = {"quant_train": "pq_pairwise", "serve_1m": "adc_scan_batch",
                       "encode_bulk": "pq_pairwise", "adc_bulk": "adc_scan_batch",
                       "sharded_graph": "hop_adc", "sharded_graph_fs4": "hop_adc_fs",
                       "sharded_graph_wide": "hop_adc"}
# examples/train_rpq_e2e_torch.py's Args, lowered (a cut): 60 steps on
# sift-small with the crash at step 35, in a temporary ckpt_dir
E2E_ARGS = dict(steps=60, fail_at_step=35, checkpoint_every=10, refresh_every=20,
                log_every=20)


def launch_twins(dev, work_dir: str) -> dict:
    """The four example twins at ``--dry-run`` on ``dev``, in this process
    (train_rpq_e2e_torch at :data:`E2E_ARGS`)."""
    import contextlib as _ctx
    import importlib
    import io

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    out, times = {}, {}
    for name in ("adaptive_routing_torch", "serve_ann_torch", "streaming_torch",
                 "train_rpq_e2e_torch"):
        mod = importlib.import_module(name)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with _ctx.redirect_stdout(buf):
            if name == "train_rpq_e2e_torch":
                args = mod.Args()
                for k, v in E2E_ARGS.items():
                    setattr(args, k, v)
                args.ckpt_dir = os.path.join(work_dir, "e2e")
                args.device = dev.type
                res = mod.main(args)
            else:
                res = mod.main(["--dry-run", "--device", dev.type])
        times[name] = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            if line.strip() and not line.startswith("[rpq] step"):
                log(f"[launch] {name}: {line}")
        out[name] = {"s": times[name], "lines": len(text.splitlines())}
        if name == "adaptive_routing_torch":
            out[name]["recall"] = [r["recall"] for r in res["rows"]]
            check(len(res["rows"]) == 5 and all(0 <= r <= 1 for r in out[name]["recall"]),
                  "[launch] adaptive_routing_torch: not five rows of recall")
        elif name == "serve_ann_torch":
            out[name]["recall"] = [r["recall"] for r in res["rows"]]
            check(len(res["rows"]) == 4 and all(r["qps"] > 0 for r in res["rows"]),
                  "[launch] serve_ann_torch: not four rows with QPS")
        elif name == "streaming_torch":
            out[name]["recall"] = res["recalls"]
            check("self-contained restore" in text, "[launch] streaming_torch did not finish")
        else:
            out[name]["recall"] = res["recall"]
            check(res["restarts"] == 1 and "[train] resumed from step 30" in text,
                  "[launch] train_rpq_e2e_torch: no restart from step 30")
    log(f"[launch] twins in s: { {k: round(v, 2) for k, v in times.items()} }")
    return out


def launch_path(dev) -> dict:
    """Phase 17: the dry-run check of :data:`LAUNCH_META_CELLS` on both
    production meshes (meta device), the seven rpq cells run for real at
    full width on the host mesh (step ms, peak GiB, the kernels each
    launched), then the four example twins."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (PRODUCTION_MESHES, hbm_capacity_bytes,
                                         make_production_mesh)

    _reset_peak(dev)
    times, out = {}, {"meta": [], "card": []}
    t0 = time.perf_counter()
    hbm = hbm_capacity_bytes(dev)
    for mesh_name, multi in PRODUCTION_MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        for arch, shape in LAUNCH_META_CELLS:
            rec = dryrun.run_cell(arch, shape, mesh, mesh_name, hbm)
            log(f"[launch] meta {dryrun._line(rec)}")
            check(rec["ok"], f"[launch] meta check of {arch} {shape} on {mesh_name} failed: "
                  f"{rec.get('error')}")
            out["meta"].append({k: rec[k] for k in ("arch", "shape", "mesh", "memory", "cost",
                                                    "fits", "check_s")})
    times["meta"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = {name: 0 for name in ops.launch_counts()}
    for shape, kernel in LAUNCH_CARD_KERNELS.items():
        rec = dryrun.card_record(shape, dev)
        check(rec["ok"], f"[launch] card run of rpq {shape} failed: {rec.get('error')}")
        run = rec["run"]
        log(f"[launch] card rpq {shape:18s} on {rec['mesh']}: step {run['step_ms']:.3f} ms "
            f"(median of {len(run['step_ms_all'])}), peak {run['peak_bytes'] / 2**30:.2f} GiB, "
            f"kernels {run['launches']}")
        check(run["launches"].get(kernel, 0) > 0,
              f"[launch] rpq {shape} did not launch {kernel}")
        for name, n in run["launches"].items():
            launches[name] += n
        out["card"].append({"shape": shape, "mesh": rec["mesh"], "memory": rec["memory"],
                            "cost": rec["cost"], **run})
        torch.cuda.empty_cache()
    times["card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="rpq_launch_") as d:
        out["twins"] = launch_twins(dev, d)
    for name, n in ops.launch_counts().items():
        launches[name] += n
    times["twins"] = time.perf_counter() - t0
    out["times"], out["launches"] = times, launches
    log(f"[launch] parts in s: { {k: round(v, 2) for k, v in times.items()} }; kernel "
        f"launches { {k: v for k, v in launches.items() if v} }")
    return out


def run_launch() -> dict:
    """Phase 17 on the card, after the earlier phases' tensors are freed."""
    import torch

    return launch_path(torch.device("cuda"))


# --------------------------------------------------------------------------
# phase 11: the train -> checkpoint -> serve command lines
# --------------------------------------------------------------------------

# Runs ``python -m <module> <args>`` with the repository's src on the path
# (set here, not through PYTHONPATH: src/sitecustomize.py would import the
# JAX package at startup) and prints the process's kernel launch counts last.
CLI_WRAPPER = """import atexit, json, runpy, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops
atexit.register(lambda: print('[launches] ' + json.dumps(ops.launch_counts()), flush=True))
module = sys.argv[2]
sys.argv = [module] + sys.argv[3:]
runpy.run_module(module, run_name='__main__', alter_sys=True)
"""
SERVE_LINE = re.compile(
    r"^\[serve\] (?P<scenario>[\w-]+): recall@10=(?P<recall>[\d.]+) qps=(?P<qps>[\d.]+) "
    r"hops=(?P<hops>[\d.]+) rounds=(?P<rounds>[\d.]+) truncated=(?P<truncated>[\d.]+) "
    r"(?P<degraded>DEGRADED )?resident=(?P<resident_mb>[\d.]+)MB$", re.M)
STREAM_LINE = re.compile(
    r"^\[serve\] streaming/(?P<tag>\w+): recall@10=(?P<recall>[\d.]+) qps=(?P<qps>[\d.]+) "
    r"live=(?P<live>\d+) gen=(?P<gen>\d+) resident=(?P<resident_mb>[\d.]+)MB "
    r"truncated=(?P<truncated>[\d.]+)$", re.M)
DISK_IO_LINE = re.compile(
    r"^\[serve\] disk io: cache_hit_rate=(?P<cache_hit_rate>[\d.]+) "
    r"bytes_read=(?P<bytes_read>\d+) n_reads=(?P<n_reads>\d+) "
    r"io_wait=(?P<io_wait_ms>[\d.]+)ms retries=(?P<retries>\d+)$", re.M)
DISK_CHAOS = "slow_read=2,corrupt_record,io=0.05"
# the graphs the CLIs build at 100k: 4096 nodes a round, 4x fewer beam
# searches than the reference's 1024
CLI_WIDTHS = ["--graph-r", "64", "--graph-l", "128", "--graph-batch", "4096"]
TRAIN_ARGS = ["--dataset", "sift", "--m", "16", "--k", "256", *CLI_WIDTHS,
              "--steps", "200", "--checkpoint-every", "50", "--fail-at-step", "120"]


# the CLI subprocesses still running, killed by stop_cli when the run ends
CLI_PROCS: set = set()
CLI_LOCK = threading.Lock()
CLI_STOP = threading.Event()
CLI_WORKERS = 3  # serve chains run at once after train


def stop_cli() -> None:
    """Kill every CLI subprocess still running and start no other."""
    with CLI_LOCK:
        CLI_STOP.set()
        for proc in CLI_PROCS:
            proc.kill()


def run_cli(tag: str, module: str, args: list, timeout: float) -> tuple[str, dict, float]:
    """One driver as a subprocess; fails the run on a non-zero exit.
    Returns its stdout, its kernel launches and its wall seconds."""
    t0 = time.perf_counter()
    with CLI_LOCK:
        check(not CLI_STOP.is_set(), f"{tag}: not started, the run is ending")
        proc = subprocess.Popen([sys.executable, "-c", CLI_WRAPPER, SRC, module, *args],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=ROOT)
        CLI_PROCS.add(proc)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    finally:
        CLI_PROCS.discard(proc)
    wall = time.perf_counter() - t0
    lines = [f"[cli] {tag} | {line}" for line in stdout.splitlines()
             if not line.startswith(("[rpq]", "[launches]"))]
    if lines:
        log("\n".join(lines))
    if proc.returncode:
        log(stderr[-4000:])
    check(proc.returncode == 0, f"{tag}: exit code {proc.returncode}")
    found = re.findall(r"^\[launches\] (\{.*\})$", stdout, re.M)
    check(len(found) == 1, f"{tag}: no launch counts")
    log(f"[cli] {tag}: {wall:.1f} s, launches {found[0]}")
    return stdout, json.loads(found[0]), wall


def cli_path() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    t_cli = time.perf_counter()
    runs, walls, serve = {}, {}, {}

    with tempfile.TemporaryDirectory(prefix="rpq_cli_") as d:
        def cli(tag, module, args, timeout=600):
            out, runs[tag], walls[tag.replace(" ", "_").replace("-", "_")] = run_cli(
                tag, module, args, timeout)
            return out

        out = cli("train", "repro_torch.launch.train", TRAIN_ARGS + ["--ckpt-dir", d], 900)
        check("[supervise] restart 1" in out, "train: no supervised restart")
        check("[train] resumed from step 100" in out, "train: did not resume from step 100")
        check("[train] final recall@10=" in out, "train: no final evaluation")
        serve_args = ["--ckpt-dir", d, *CLI_WIDTHS]
        srv = lambda tag, extra: cli(tag, "repro_torch.launch.serve", serve_args + extra)

        def memory_then_hybrid():
            serve["memory"] = parse_serve(srv("serve memory", ["--scenario", "memory"]),
                                          "memory")
            # the hybrid run's deadline: half the memory run's batch of 1000
            deadline_ms = 0.5 * 1000.0 / serve["memory"]["qps"] * 1e3
            out = srv("serve hybrid", ["--scenario", "hybrid", "--entries", "8",
                                       "--prune-eps", "0.2", "--deadline-ms",
                                       f"{deadline_ms:.3f}", "--degrade-level", "2",
                                       "--chaos", "io=0.05"])
            serve["hybrid"] = parse_serve(out, "hybrid")
            serve["hybrid"]["deadline_ms"] = deadline_ms
            check("max_rounds=" in out, "serve hybrid: no deadline budget")

        def sharded():
            serve["sharded"] = parse_serve(srv("serve sharded", ["--scenario", "sharded"]),
                                           "sharded")

        def streaming():
            serve["streaming"] = parse_streaming(srv(
                "serve streaming", ["--scenario", "streaming", "--churn", "0.1",
                                    "--churn-rounds", "4", "--refresh-every", "2"]))

        def disk():
            serve["disk"] = parse_disk(srv("serve disk", ["--scenario", "disk"]))
            check(serve["disk"]["retries"] == 0, "serve disk: retries without injected faults")
            out = srv("serve disk chaos", ["--scenario", "disk", "--chaos", DISK_CHAOS])
            serve["disk_chaos"] = parse_disk(out)
            for line in ("[serve] chaos: silently corrupted record",
                         "[serve] chaos: transient read fault p=0.05 injected on segment reads"):
                check(line in out, f"serve disk chaos: no '{line}' line")

        def sharded_graph():
            # at the sharded_graph cell's R=32, l=64: the first run builds
            # graph_part4.npz, the second loads it, the third drops shard 1
            part_args = ["--ckpt-dir", d, "--graph-r", "32", "--graph-l", "64",
                         "--graph-batch", "4096",
                         "--scenario", "sharded-graph", "--shards", str(SHARDS)]
            for tag, extra, line in (("", [], "[serve] partition built in"),
                                     ("_cached", [], "[serve] partition loaded from"),
                                     ("_dead", ["--chaos", "dead=1"],
                                      f"[serve] chaos: 1/{SHARDS} shard(s) dead")):
                out = cli(f"serve sharded-graph{tag}", "repro_torch.launch.serve",
                          part_args + extra)
                check(line in out, f"serve sharded-graph{tag}: no '{line}' line")
                serve[f"sharded_graph{tag}"] = parse_serve(out, "sharded-graph")
                check(serve[f"sharded_graph{tag}"]["degraded"] == (tag == "_dead"),
                      f"serve sharded-graph{tag}: degraded flag wrong")

        # the longest chains first; each raises what its checks raise
        with ThreadPoolExecutor(CLI_WORKERS) as pool:
            chains = [pool.submit(f) for f in (streaming, sharded_graph, disk,
                                               memory_then_hybrid, sharded)]
        for chain in chains:
            chain.result()
    from repro_torch.kernels import ops

    full = {k: sum(c.get(k, 0) for c in runs.values()) for k in ops.launch_counts()}
    for name in ("pq_pairwise", "hop_adc", "adc_scan_batch"):
        check(full[name] > 0, f"kernel {name} was not launched by the CLIs")
    log(f"[cli] launches: {full}; wall {walls}")
    log(f"[cli] done in {time.perf_counter() - t_cli:.1f} s")
    return dict(walls=walls, serve=serve, launches=full)


def parse_streaming(out: str) -> dict:
    """The streaming scenario's per-round lines (generation 0 = the 90k
    rows the hold-out leaves of the 100k base) and its two refreshed
    consolidations."""
    rows = {m["tag"]: {k: float(v) for k, v in m.groupdict().items() if k != "tag"}
            for m in STREAM_LINE.finditer(out)}
    want = ("round0", "round1", "refreshed1", "round2", "round3", "consolidated")
    check(tuple(rows) == want, f"serve streaming: rounds {tuple(rows)} != {want}")
    check("[serve] streaming: base 90000 rows (gen 0)" in out,
          "serve streaming: generation 0 is not the 90k hold-out base")
    check(out.count("codebooks refreshed (live distortion") == 2,
          "serve streaming: not two refreshed consolidations")
    for tag, row in rows.items():
        check(math.isfinite(row["recall"]) and row["qps"] > 0,
              f"serve streaming/{tag}: recall or qps not finite")
    return rows


def parse_disk(out: str) -> dict:
    """The disk scenario's ``[serve] disk:`` result line and its ``[serve]
    disk io:`` line."""
    row = parse_serve(out, "disk")
    found = [m.groupdict() for m in DISK_IO_LINE.finditer(out)]
    check(len(found) == 1, "serve disk: no parseable [serve] disk io line")
    row.update({k: float(v) for k, v in found[0].items()})
    check(row["n_reads"] > 0 and row["bytes_read"] > 0, "serve disk: no record was read")
    return row


def parse_serve(out: str, scenario: str) -> dict:
    found = [m.groupdict() for m in SERVE_LINE.finditer(out)]
    check(len(found) == 1 and found[0]["scenario"] == scenario,
          f"serve {scenario}: no parseable [serve] line")
    row = {k: float(v) for k, v in found[0].items() if k not in ("scenario", "degraded")}
    row["degraded"] = bool(found[0]["degraded"])
    for k in ("recall", "qps", "resident_mb"):
        check(math.isfinite(row[k]), f"serve {scenario}: {k} not finite")
    check(row["qps"] > 0, f"serve {scenario}: qps not positive")
    return row


def run_archs() -> dict:
    """Phase 16 on the card, after the earlier phases' tensors are freed."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[archs] resident before the phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return archs_path(torch.device("cuda"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0,
                    help="sift spec scale: 10 → 1M base vectors (default), "
                         "1 → the registered 100k")
    ap.add_argument("--vamana-batch", type=int, default=VAMANA_BATCH,
                    help="nodes per batched Vamana insert round")
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--retrieval-us", action="store_true",
                    help="only time phase 9's per-query loop on seeded 1M x 16 uint8 "
                         "codes, with the repro_torch of --src, and print it as JSON")
    ap.add_argument("--adc-batch", action="store_true",
                    help="only time adc_scan_batch's diagnostic rows (adc_batch_rows), "
                         "with the repro_torch of --src, and print them as JSON")
    ap.add_argument("--archs", action="store_true",
                    help="only run phase 16 (the model zoo) and print its results as JSON")
    ap.add_argument("--launch", action="store_true",
                    help="only run phase 17 (dry-run cells, the rpq cells on the card, the "
                         "example twins) and print its results as JSON")
    ap.add_argument("--beam-round", action="store_true",
                    help="only run the classic beam round's kernels at the benchmark's "
                         "widths (beam_round_rows) and print their rows as JSON")
    ap.add_argument("--src", default=SRC,
                    help="the src directory --retrieval-us and --adc-batch import "
                         "repro_torch from (default: this checkout's)")
    args = ap.parse_args()
    src = args.src if args.retrieval_us or args.adc_batch else SRC

    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}")
    if args.retrieval_us:
        _build.build(("adc_scan",))
        print(json.dumps({"src": src, "device": smi, **retrieval_us()}))
        return 0
    if args.adc_batch:
        for line in _build.build(("adc_scan",)).get("adc_scan", "").splitlines():
            if "Used" in line or "spill" in line or "properties for" in line:
                log(f"[build] adc_scan: {line.strip()}")
        print(json.dumps({"src": src, "device": smi, "rows": adc_batch_rows()}))
        return 0

    if args.archs:
        print(json.dumps({"device": smi, "archs": run_archs()}))
        return 0
    if args.beam_round:
        for name, text in _build.build(("beam_round", "hop_adc")).items():
            for line in text.splitlines():
                if "Used" in line or "spill" in line or "properties for" in line:
                    log(f"[build] {name}: {line.strip()}")
        rows = beam_round_rows(max(int(100_000 * args.scale), 1000))
        print(json.dumps({"device": smi, "rows": rows}))
        return 0
    if args.launch:
        t0 = time.perf_counter()
        launch = run_launch()
        log(f"[launch] done in {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"device": smi, "launch": launch}))
        return 0

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
    kernels.update(wide_parity_and_timing(n_base, 1000))
    kernels.update(beam_round_rows(n_base))
    log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    small_reference()
    log(f"[small] done in {time.perf_counter() - t0:.1f} s")
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as background:
        cli = background.submit(cli_path)  # phase 11, beside phase 5's build
        try:
            result, ds, gt, graph, pq_model, pq_codes, res_main = main_path(args, cli.result)
        finally:
            if not cli.done():
                stop_cli()
    phases = {"main": result, "cli": cli.result()}
    result["hop_adc_in_search"] = in_search(result["search_busy"], "hop_adc_kernel<",
                                            kernels["hop_adc"], "InMemoryEngine")
    t0 = time.perf_counter()
    phases["fs4"], fs4_model, fs4_packed = fs4_path(ds, gt, graph, pq_model, pq_codes)
    phases["fs4"]["hop_adc_fs_in_search"] = in_search(
        phases["fs4"]["search_busy"], "hop_adc_fs", kernels["hop_adc_fs"], "fs4 InMemoryEngine")
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
    t0 = time.perf_counter()
    phases["adaptive"] = adaptive_path(ds, gt, graph, pq_model, pq_codes, res_main,
                                       fs4_model, fs4_packed)
    log(f"[adaptive] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rpq_stream_") as d:
        phases["stream"] = stream_path(ds, graph, pq_model, pq_codes, fs4_model,
                                       fs4_packed, d)
    log(f"[stream] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rpq_disk_") as d:
        phases["disk"] = disk_path(ds, gt, graph, pq_model, pq_codes, fs4_model, fs4_packed,
                                   res_main, result["recall"]["inmemory"], d)
    log(f"[disk] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phases["sharded"] = sharded_path(args, ds, gt, graph, pq_model, pq_codes, fs4_model,
                                     fs4_packed, result["recall"]["inmemory"], kernels)
    log(f"[sharded] done in {time.perf_counter() - t0:.1f} s")
    del fs4_packed, res_main
    t0 = time.perf_counter()
    from repro_torch.core.trainer import to_model

    phases["pgraphs"] = pgraphs_path(
        args, ds, gt, graph, pq_model, pq_codes, to_model(cfg, params), rpq_codes, kernels,
        {"pq": result["times"]["train_pq"], "rpq": phases["train"]["fit_s"]})
    log(f"[pgraphs] done in {time.perf_counter() - t0:.1f} s")
    del ds, gt, graph, pq_codes, params, rpq_codes
    t0 = time.perf_counter()
    phases["archs"] = run_archs()
    log(f"[archs] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phases["launch"] = run_launch()
    log(f"[launch] done in {time.perf_counter() - t0:.1f} s")
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
