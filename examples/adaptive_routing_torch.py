"""Adaptive routing walkthrough on the PyTorch + CUDA port: multi-entry
seeding + hop pruning.

    PYTHONPATH=src python examples/adaptive_routing_torch.py [--dry-run] [--device cpu]

The twin of ``examples/adaptive_routing.py`` through ``repro_torch``. The
classic beam starts every query at the one graph medoid and spends its
first hops escaping the medoid's neighborhood; then every hop full-scores
the whole frontier. Adaptive routing (DESIGN.md §11) attacks both costs:

* ``entries=S``: a PQ-hash coarse index over the resident codes turns the
  query's own LUT into S near-query entry points;
* ``prune_eps=ε``: each hop scores the frontier on the first m′ < M
  subspaces (a certified lower bound), extrapolates with a per-query
  calibration and full-scores only lanes with d̂·(1+ε) ≤ τ.

Both default OFF and S=1/ε=0 is bit-identical to the classic beam. The
table compares the two knobs separately and combined against the
sequential baseline — rounds (sequential trips) and n_dist (full-LUT-
equivalent distance evaluations) are the costs being cut. ``--dry-run``
shrinks every knob so the walkthrough runs in seconds; the default device
is ``cuda``.
"""

import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.data.synth import DatasetSpec, synth
from repro_torch.graphs import build_vamana, knn_ids
from repro_torch.pq import base, train_pq
from repro_torch.search.engine import InMemoryEngine
from repro_torch.search.metrics import recall_at_k
from repro_torch.search.seed import build_seed_index

ROWS = (
    ("classic (S=1, eps=0, E=1)", {}),
    ("seeded (S=8)", dict(entries=8)),
    ("pruned (eps=0.2, m'=2)", dict(prune_eps=0.2, m_prefix=2)),
    ("seeded+pruned", dict(entries=8, prune_eps=0.2, m_prefix=2)),
    ("full adaptive (+E=4)", dict(entries=8, prune_eps=0.2, m_prefix=2, expand=4)),
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--dry-run", action="store_true", help="tiny corpus, CI-sized")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without CUDA pass --device cpu")
    args = ap.parse_args(argv)
    if args.dry_run:
        args.n, args.queries = 3000, 64

    ds = synth(DatasetSpec("adaptive", args.dim, args.n, args.queries, 32, 0.3, 0.2,
                           seed=5), device=args.device)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    graph = build_vamana(ds.base, generator=gen(0), r=16, l=32, device=args.device)
    gt, _ = knn_ids(ds.base, ds.queries, 10)
    model = train_pq(ds.train, 8, 64, generator=gen(1),
                     iters=8 if args.dry_run else 15, device=args.device)
    codes = base.encode(model, ds.base)
    eng = InMemoryEngine(graph, codes, lambda q: base.build_lut(model, q),
                         device=args.device)

    # a peek at the seeding machinery: the coarse index hashes the corpus
    # on the first m_hash sub-codes; the query gets its bucket key for free
    # from the LUT it already built
    ix = build_seed_index(codes.cpu().numpy(), device="cpu")
    occupied = int((ix.table >= 0).any(dim=1).sum())
    print(f"seed index: {ix.table.shape[0]} buckets on the first "
          f"{ix.m_hash} sub-code(s) (base K={ix.k}), {occupied} occupied, "
          f"{ix.n_candidates} candidates probed per query "
          f"(bucket cap {ix.table.shape[1]} + {ix.pivots.shape[0]} pivots)")

    def run(tag, **kw):
        res = eng.search(ds.queries, k=10, h=args.h, **kw)
        return dict(tag=tag, recall=recall_at_k(res.ids, gt, 10),
                    rounds=float(res.rounds.float().mean()),
                    n_dist=float(res.n_dist.float().mean()))

    rows = [run(tag, **kw) for tag, kw in ROWS]
    base_row = rows[0]
    print(f"\n{'config':28s} {'recall@10':>10s} {'rounds':>8s} "
          f"{'n_dist':>8s} {'rounds cut':>11s} {'n_dist cut':>11s}")
    for r in rows:
        print(f"{r['tag']:28s} {r['recall']:10.3f} {r['rounds']:8.2f} "
              f"{r['n_dist']:8.1f} "
              f"{base_row['rounds'] / max(r['rounds'], 1e-9):10.2f}x "
              f"{1 - r['n_dist'] / base_row['n_dist']:+10.1%}")
    print("\n(rounds = sequential while-loop trips; n_dist = full-LUT-"
          "equivalent\n distance evaluations incl. the seed probe; S=1/"
          "eps=0 is bit-identical\n to the classic beam — "
          "tests/test_adaptive.py holds that bar)")
    return dict(ds=ds, graph=graph, model=model, codes=codes, gt=gt, rows=rows)


if __name__ == "__main__":
    main()
