"""Batched ANN serving demo on the PyTorch + CUDA port: both paper
scenarios + QPS measurement.

    PYTHONPATH=src python examples/serve_ann_torch.py [--n 20000] [--h 16 32 64] \\
        [--dry-run] [--device cpu]

The twin of ``examples/serve_ann.py`` through ``repro_torch``. Builds an
index (Vamana + trained RPQ codes) and serves query batches via
 (a) the in-memory engine (PQ distances only — paper §7 scenario 2) and
 (b) the DiskANN hybrid engine (ADC routing + exact rerank, modeled SSD IO).
Reports a QPS / recall@10 operating curve — the paper's Fig. 5/6 axes.

RPQ trains on ``ds.train`` with a graph built over those rows (its
features gather rows by graph id); serving uses the graph over
``ds.base``. ``--dry-run`` (not in the reference) shrinks the corpus, the
training and the h sweep so the demo runs in seconds; the default device
is ``cuda``.
"""

import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.core import RPQConfig, TrainConfig, train_rpq
from repro_torch.data.synth import DatasetSpec, synth
from repro_torch.graphs import build_vamana, knn_ids
from repro_torch.pq import base
from repro_torch.search.engine import HybridEngine, InMemoryEngine
from repro_torch.search.metrics import measure_qps, recall_at_k


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--h", type=int, nargs="+", default=[8, 16, 32, 64])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dry-run", action="store_true",
                    help="1000 vectors, 32 queries, 10 steps, h 16 32")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without CUDA pass --device cpu")
    args = ap.parse_args(argv)
    if args.dry_run:
        args.n, args.queries, args.steps, args.h = 1000, 32, 10, [16, 32]

    ds = synth(DatasetSpec("serve", args.dim, args.n, args.queries, 96, 0.35, 0.1,
                           seed=3), device=args.device)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    graph = build_vamana(ds.base, generator=gen(0), r=24, l=48, device=args.device)
    train_graph = build_vamana(ds.train, generator=gen(2), r=24, l=48,
                               device=args.device)
    gt, _ = knn_ids(ds.base, ds.queries, 10)

    cfg = RPQConfig(dim=args.dim, m=8, k=64)
    tcfg = TrainConfig(steps=args.steps, refresh_every=args.steps // 3,
                       triplet_batch=512, routing_batch=512,
                       routing_pool_queries=96, log_every=args.steps // 3)
    rpq = train_rpq(ds.train, train_graph, seed=1, cfg=cfg, tcfg=tcfg,
                    device=args.device)
    codes = base.encode(rpq.model, ds.base)
    lut_fn = lambda q: base.build_lut(rpq.model, q)

    mem = InMemoryEngine(graph, codes, lut_fn, device=args.device)
    hyb = HybridEngine(graph, codes, lut_fn, vectors=ds.base, device=args.device)
    print(f"index: n={args.n} codes={codes.shape[1]}B/vec "
          f"resident={mem.memory_bytes()/1e6:.1f}MB "
          f"(full vectors would be {ds.base.numel()*4/1e6:.1f}MB)")
    print(f"{'engine':8s} {'h':>4s} {'recall@10':>10s} {'QPS':>9s} "
          f"{'hops':>6s} {'SSD ms/q':>9s}")
    rows = []
    for h in args.h:
        qps, res = measure_qps(lambda q: mem.search(q, k=10, h=h), ds.queries)
        rec = recall_at_k(res.ids, gt, 10)
        rows.append(dict(engine="inmem", h=h, recall=rec, qps=qps))
        print(f"{'inmem':8s} {h:4d} {rec:10.3f} "
              f"{qps:9.1f} {float(res.hops.float().mean()):6.1f} {'—':>9s}")
        qps, res = measure_qps(lambda q: hyb.search(q, k=10, h=h), ds.queries)
        io_ms = float(hyb.io_time(res).mean()) * 1e3
        rec = recall_at_k(res.ids, gt, 10)
        rows.append(dict(engine="hybrid", h=h, recall=rec, qps=qps))
        print(f"{'hybrid':8s} {h:4d} {rec:10.3f} "
              f"{qps:9.1f} {float(res.hops.float().mean()):6.1f} {io_ms:9.2f}")
    return dict(ds=ds, graph=graph, model=rpq.model, codes=codes, gt=gt, rows=rows)


if __name__ == "__main__":
    main()
