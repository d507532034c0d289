"""Quickstart on the PyTorch + CUDA port: the whole RPQ pipeline.

    PYTHONPATH=src python examples/quickstart_torch.py [--dry-run] [--device cpu]

The twin of ``examples/quickstart.py`` through ``repro_torch``:

1. synthesize a small clustered dataset,
2. build Vamana proximity graphs,
3. train the paper's routing-guided quantizer (RPQ) end to end,
4. serve queries through the DiskANN-style hybrid engine,
5. compare against classic PQ at the same bit budget.

RPQ trains on ``ds.train`` with a graph built over those rows (its
features gather rows by graph id); serving uses a second graph over
``ds.base``. ``--dry-run`` shrinks every knob (a few hundred vectors, a
handful of training steps) so the example runs in seconds; the pipeline
and printed format are identical. The default device is ``cuda``.
"""

import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.core import RPQConfig, TrainConfig, train_rpq
from repro_torch.data import load_dataset
from repro_torch.graphs import build_vamana, knn_ids
from repro_torch.pq import base, train_pq
from repro_torch.search.engine import HybridEngine
from repro_torch.search.metrics import recall_at_k


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run", action="store_true",
                    help="minutes → seconds: tiny data + few train steps")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without CUDA pass --device cpu")
    args = ap.parse_args()

    ds = load_dataset("unit-test", device=args.device)  # 2k × 32, clustered anisotropic
    if args.dry_run:
        ds = dataclasses.replace(ds, base=ds.base[:400], queries=ds.queries[:20],
                                 train=ds.train[:200])
    steps = 10 if args.dry_run else 150
    print(f"dataset: {ds.base.shape[0]} base vectors, dim {ds.dim}")

    gen = lambda seed: torch.Generator().manual_seed(seed)
    graph = build_vamana(ds.base, generator=gen(0), r=16, l=32, device=args.device)
    train_graph = build_vamana(ds.train, generator=gen(3), r=16, l=32,
                               device=args.device)
    gt, _ = knn_ids(ds.base, ds.queries, 10)

    m, k = 4, 32                            # 4 sub-bytes per vector
    pq_model = train_pq(ds.train, m, k, generator=gen(1), device=args.device)
    cfg = RPQConfig(dim=ds.dim, m=m, k=k)
    tcfg = TrainConfig(steps=steps, refresh_every=max(steps // 3, 1),
                       triplet_batch=256, routing_batch=256,
                       routing_pool_queries=48, log_every=max(steps // 3, 1))
    rpq = train_rpq(ds.train, train_graph, seed=2, cfg=cfg, tcfg=tcfg,
                    device=args.device)

    for name, model in (("PQ ", pq_model), ("RPQ", rpq.model)):
        codes = base.encode(model, ds.base)
        engine = HybridEngine(graph, codes,
                              lambda q, _m=model: base.build_lut(_m, q),
                              vectors=ds.base, device=args.device)
        res = engine.search(ds.queries, k=10, h=32)
        print(f"{name}: recall@10 = {recall_at_k(res.ids, gt, 10):.3f}  "
              f"mean hops = {float(res.hops.float().mean()):.1f}  "
              f"codes = {codes.shape[0]}×{codes.shape[1]}B")


if __name__ == "__main__":
    main()
