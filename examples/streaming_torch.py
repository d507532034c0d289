"""Streaming index walkthrough on the PyTorch + CUDA port: insert → query →
delete → consolidate.

    PYTHONPATH=src python examples/streaming_torch.py [--dry-run] [--device cpu]

The twin of ``examples/streaming.py`` through ``repro_torch``:

1. build a frozen base segment (Vamana graph + PQ codes) over a small
   clustered dataset,
2. insert a batch of new vectors — they are encoded with the same
   quantizer and served from the bounded delta segment immediately,
3. delete some rows (including the graph's own entry point) — tombstones
   mask them out of every answer without touching the graph,
4. consolidate — the delta folds into the next base generation, tombstoned
   rows are compacted away, and the snapshot can be restored,
5. consolidate with a codebook REFRESH (DESIGN.md §12) — the quantizer
   retrains on the live graph, every surviving row re-encodes, and the
   snapshot carries the new codebooks so ``restore()`` needs no
   caller-side model at all.

``--dry-run`` shrinks the dataset so the walkthrough runs in seconds; the
pipeline and printed format are identical. The default device is ``cuda``.
"""

import argparse
import dataclasses
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.data import load_dataset
from repro_torch.index import BaseSegment, RefreshConfig, StreamingEngine
from repro_torch.index.segment import save_segment
from repro_torch.pq import train_pq
from repro_torch.search.metrics import live_ground_truth, recall_at_k


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny data so the walkthrough runs in seconds")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without CUDA pass --device cpu")
    args = ap.parse_args(argv)
    dev = args.device

    ds = load_dataset("unit-test", device=dev)   # 2k × 32, clustered anisotropic
    if args.dry_run:
        ds = dataclasses.replace(ds, base=ds.base[:500], queries=ds.queries[:20],
                                 train=ds.train[:250])
    n = int(ds.base.shape[0])
    n0 = n - n // 10                        # hold out 10% as the stream
    base_x, stream = ds.base[:n0].cpu().numpy(), ds.base[n0:].cpu().numpy()
    queries = ds.queries.cpu().numpy()
    print(f"corpus: {n0} base rows + {len(stream)} streamed, dim {ds.dim}")

    gen = lambda seed: torch.Generator().manual_seed(seed)
    model = train_pq(ds.train, 4, 32, generator=gen(1), device=dev)
    seg = BaseSegment.build(torch.from_numpy(base_x), model, generator=gen(0),
                            r=16, l=32, device=dev)
    engine = StreamingEngine(seg, model, delta_capacity=len(stream), device=dev)
    recalls = {}

    def report(tag):
        occupied = np.arange(n0 + engine.delta.count)
        live = occupied[~engine.tombstones.contains(occupied)]
        all_x = np.concatenate([base_x, stream])
        gt_g = live_ground_truth(all_x, live, queries, 10)
        rec = recall_at_k(engine.search(queries, k=10, h=32).ids, gt_g, 10)
        recalls[tag.strip()] = rec
        print(f"{tag}: recall@10 = {rec:.3f}  live rows = {engine.n_live}  "
              f"generation = {engine.generation}")

    report("frozen base        ")

    # INSERT: the stream lands in the delta and is served immediately
    gids = engine.insert(stream)
    report("after insert       ")

    # QUERY at an inserted vector: read-your-writes, the new id wins
    hit = engine.search(stream[:1], k=1, h=32)
    assert int(hit.ids[0, 0]) == int(gids[0])

    # DELETE: tombstone some base rows AND the entry point itself
    dead = np.arange(0, n0, 97)
    medoid = int(seg.graph.medoid)
    engine.delete(dead)
    engine.delete(medoid)
    assert not np.isin(engine.search(queries, k=10, h=32).ids.cpu().numpy(),
                       np.append(dead, medoid)).any()
    print(f"deleted {len(dead) + 1} rows (incl. the medoid) — "
          f"never returned again")

    # CONSOLIDATE: fold delta + tombstones into generation 1
    stats = engine.consolidate()
    print(f"consolidated: dropped {stats['dropped']}, folded "
          f"{stats['folded']} delta rows → {stats['n']} rows")
    rec = recall_at_k(engine.search(queries, k=10, h=32).ids,
                      live_ground_truth(engine.base.vectors, np.arange(stats["n"]),
                                        queries, 10), 10)
    recalls[f"generation {engine.generation}"] = rec
    print(f"generation {engine.generation}: recall@10 = {rec:.3f}  "
          f"live rows = {engine.n_live}")

    # REFRESH: another churn round, then a consolidation that also
    # retrains the codebooks on the live graph (sized tiny here — a real
    # deployment would run more steps; see launch/serve.py --refresh-every)
    engine.delete(np.arange(0, engine.base.n, 5))
    stats = engine.consolidate(
        refresh=RefreshConfig(steps=4, kmeans_iters=3, triplet_batch=64,
                              routing_batch=64, routing_pool_queries=16, beam_h=8))
    rep = stats["refresh"]
    print(f"refreshed consolidation → generation {engine.generation}: "
          f"live distortion {rep['distortion_before']:.3f} → "
          f"{rep['distortion_after']:.3f} over {stats['n']} re-encoded rows")

    # the snapshot carries the refreshed quantizer: restore() rebuilds the
    # engine from disk alone — no model argument
    with tempfile.TemporaryDirectory() as td:
        save_segment(td, engine.base, model=engine.model)
        restored = StreamingEngine.restore(td, device=dev)
        a = engine.search(queries, k=5, h=16).ids.cpu().numpy()
        b = restored.search(queries, k=5, h=16).ids.cpu().numpy()
        assert np.array_equal(a, b)
    print("self-contained restore: snapshot → engine, no caller-side model")
    return dict(seg=seg, model=model, base_x=base_x, queries=queries, recalls=recalls)


if __name__ == "__main__":
    main()
