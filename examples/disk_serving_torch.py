"""All-in-storage serving on the PyTorch + CUDA port: segment file →
DiskEngine → chaos.

    PYTHONPATH=src python examples/disk_serving_torch.py [--dry-run] [--device cpu]

The twin of ``examples/disk_serving.py`` through ``repro_torch``:

1. build a frozen base segment (Vamana graph + PQ codes) and export it to
   the storage tier's on-disk format — one mmap-able file of per-vertex
   records (adjacency + codes in the same 8-byte-aligned slab) plus the
   quantizer sidecar, written atomically,
2. restore the segment VECTOR-FREE (``load_segment(with_vectors=False)``
   reads zero vector bytes) — all the export path needs,
3. open a :class:`~repro_torch.storage.engine.DiskEngine` on the directory
   from the sidecar alone: DRAM holds only the query LUTs and a bounded
   hot-vertex cache (BFS-seeded from the medoid and pinned); every beam
   round reads its frontier records through the async reader and scores
   them on the device,
4. search twice — serial read-then-compute vs double-buffered prefetch —
   and compare answers, wall time, and the engine's I/O accounting,
5. tombstone rows and cap budgets: deletes mask answers immediately,
   ``max_rounds`` truncates honestly,
6. corrupt the newest generation's header on disk: ``DiskEngine.open``
   falls back to the newest intact generation and keeps serving.

``--dry-run`` shrinks the dataset so the walkthrough runs in seconds; the
pipeline and printed format are identical. The default device is ``cuda``.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.data import load_dataset
from repro_torch.index import BaseSegment
from repro_torch.index.segment import load_segment, save_segment
from repro_torch.pq import train_pq
from repro_torch.search.metrics import live_ground_truth, recall_at_k
from repro_torch.storage import (DiskEngine, corrupt_header, segment_path,
                                 write_segment)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny data so the walkthrough runs in seconds")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without CUDA pass --device cpu")
    args = ap.parse_args()
    dev = args.device

    ds = load_dataset("unit-test", device=dev)   # 2k × 32, clustered anisotropic
    if args.dry_run:
        ds = dataclasses.replace(ds, base=ds.base[:600],
                                 queries=ds.queries[:32],
                                 train=ds.train[:300])
    gen = lambda seed: torch.Generator().manual_seed(seed)
    model = train_pq(ds.train, 4, 32, generator=gen(1), device=dev)
    seg = BaseSegment.build(ds.base, model, generator=gen(0), r=16, l=32,
                            device=dev)
    gt = live_ground_truth(ds.base, np.arange(int(ds.base.shape[0])),
                           ds.queries, 10)

    with tempfile.TemporaryDirectory() as d:
        # 1. export: checkpoint snapshot -> vector-free restore -> segment
        save_segment(f"{d}/ckpt", seg, model=model)
        lean = load_segment(f"{d}/ckpt", with_vectors=False, device=dev)
        assert lean.vectors is None and lean.dim == seg.dim
        path = write_segment(d, lean, model=model)
        print(f"segment: {os.path.getsize(path)} bytes on disk for "
              f"{seg.n} records ({seg.n} x "
              f"{os.path.getsize(path) // max(seg.n, 1)}B)")

        # 2-4. serve from storage, serial vs double-buffered prefetch
        with DiskEngine.open(d, cache_mb=0.02, device=dev) as eng:
            print(f"DRAM-resident serving state: {eng.memory_bytes()} "
                  f"bytes (cache), generation {eng.generation}")
            t0 = time.perf_counter()
            res_s = eng.search(ds.queries, k=10, h=32, overlap=False)
            wall_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res_p = eng.search(ds.queries, k=10, h=32, overlap=True)
            wall_p = time.perf_counter() - t0
            io = eng.last_io
            rec_s = recall_at_k(res_s.ids, gt, 10)
            rec_p = recall_at_k(res_p.ids, gt, 10)
            print(f"serial   : recall@10 = {rec_s:.3f}  "
                  f"wall = {wall_s * 1e3:.0f} ms")
            print(f"prefetch : recall@10 = {rec_p:.3f}  "
                  f"wall = {wall_p * 1e3:.0f} ms  "
                  f"cache_hit_rate = {io['cache_hit_rate']:.2f}  "
                  f"bytes_read = {io['bytes_read']}")
            assert abs(rec_p - rec_s) <= 0.02, "stale frontier diverged"

            # 5. deletes + budgets
            dead = np.arange(0, seg.n, 37)
            eng.delete(dead)
            ids = eng.search(ds.queries, k=10, h=32).ids.cpu().numpy()
            assert not np.isin(ids, dead).any()
            capped = eng.search(ds.queries, k=10, h=32, max_rounds=4)
            print(f"tombstoned {dead.size} rows — never returned; "
                  f"max_rounds=4 truncated "
                  f"{float(capped.truncated.float().mean()):.0%} "
                  f"of queries honestly")

        # 6. corruption fallback: gen 1 arrives broken, serving survives
        write_segment(d, dataclasses.replace(lean, generation=1),
                      model=model)
        corrupt_header(segment_path(d, 1), seed=3)
        falls = []
        with DiskEngine.open(
                d, cache_mb=0.02, device=dev,
                on_fallback=lambda g, e: falls.append(g)) as eng:
            rec = recall_at_k(eng.search(ds.queries, k=10, h=32).ids,
                              gt, 10)
            print(f"gen 1 corrupted on disk -> fell back past {falls} to "
                  f"generation {eng.generation}, recall@10 = {rec:.3f}")
            assert eng.generation == 0 and falls == [1]


if __name__ == "__main__":
    main()
