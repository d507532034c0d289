"""Fault-tolerant end-to-end RPQ training driver (the paper's pipeline).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --dataset sift-small --steps 400 --ckpt-dir runs/rpq \
        --checkpoint-every 50 [--fail-at-step 120] [--resume] [--device cpu]

Port of ``repro/launch/train.py``, with the same flags plus ``--device``
(default ``cuda``; without CUDA the driver raises unless given ``--device
cpu``). Builds (or loads) the dataset + Vamana PG over the training rows,
then runs the multi-feature joint training with atomic checkpoints
(``dist/checkpoint.py``, the reference's format: either package restores
the other's); after a crash the ``supervise`` wrapper restarts it from the
latest checkpoint, and the per-step generators of ``core/trainer.fit``
replay the uninterrupted run's draws. Ends with a ``HybridEngine``
evaluation on the base set.

The draws come from ``torch.Generator``s seeded from ``--seed`` (JAX's
threefry draws cannot be reproduced), so the trained numbers differ from
the reference's; the checkpoints and the cached graphs (``graph.npz``,
``graph_base.npz``: ``neighbors``, ``medoid``) are interchangeable.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.common import adam, one_cycle
from repro_torch.core import quantizer as Q
from repro_torch.core import trainer as T
from repro_torch.data import load_dataset
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.fault import FailureInjector, supervise
from repro_torch.graphs import build_vamana, knn_ids
from repro_torch.graphs.adjacency import Graph
from repro_torch.pq import base as pqbase
from repro_torch.search.engine import HybridEngine
from repro_torch.search.metrics import recall_at_k


def build_or_load_graph(generator: torch.Generator, x: torch.Tensor,
                        cache_path: str, r: int, l: int, batch: int = 1024) -> Graph:
    """The Vamana graph over ``x`` (on x's device), read from
    ``cache_path`` when it exists, else built ``batch`` nodes a round and
    written there (the reference's ``.npz`` keys, so the two drivers share
    a cache)."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        return Graph(neighbors=torch.from_numpy(z["neighbors"].astype(np.int32)).to(x.device),
                     medoid=torch.tensor(int(z["medoid"]), device=x.device))
    g = build_vamana(x, generator=generator, r=r, l=l, batch=batch, device=x.device)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez(cache_path, neighbors=g.neighbors.cpu().numpy(),
                 medoid=g.medoid.cpu().numpy())
    return g


def template_state(cfg: Q.RPQConfig, tcfg: T.TrainConfig, device
                   ) -> tuple[Q.RPQParams, object]:
    """Params and Adam state of the config's shapes (zeros): the ``like=``
    template that restores a checkpoint's NamedTuples."""
    params = Q.init_params(cfg, torch.zeros((cfg.m, cfg.k, cfg.dsub), device=device))
    return params, adam(one_cycle(tcfg.lr, tcfg.steps)).init(params)


def run(args) -> dict:
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, scale=args.scale, device=dev)
    x = ds.train
    graph_gen = lambda: torch.Generator().manual_seed(args.seed)
    graph = build_or_load_graph(graph_gen(), x, os.path.join(args.ckpt_dir, "graph.npz"),
                                args.graph_r, args.graph_l, args.graph_batch)

    cfg = Q.RPQConfig(dim=x.shape[1], m=args.m, k=args.k)
    tcfg = T.TrainConfig(steps=args.steps, refresh_every=args.refresh_every,
                         triplet_batch=args.batch, routing_batch=args.batch,
                         routing_pool_queries=args.routing_queries,
                         log_every=args.log_every)

    params = None
    opt_state = None
    start_step = 0
    step = ckpt.latest_step(args.ckpt_dir)
    if step is not None:
        params_t, opt_t = template_state(cfg, tcfg, dev)
        state = ckpt.restore(args.ckpt_dir, step, like={"params": params_t, "opt": opt_t},
                             device=dev)
        params, opt_state, start_step = state["params"], state["opt"], state["step"] + 1
        print(f"[train] resumed from step {state['step']}")

    injector = FailureInjector(fail_at_step=args.fail_at_step)
    args.fail_at_step = None  # one-shot: a restarted (replaced) node must
    #                           not re-crash at the same step

    def checkpoint_cb(step, p, o):
        injector.maybe_fail(step)
        if step % args.checkpoint_every == 0 and step > 0:
            ckpt.save(args.ckpt_dir, step, keep=args.keep, params=p, opt=o,
                      extra={"dataset": args.dataset, "m": args.m, "k": args.k})

    state = T.fit(cfg, tcfg, x, graph, seed=args.seed, params=params,
                  opt_state=opt_state, start_step=start_step,
                  checkpoint_cb=checkpoint_cb, verbose=not args.quiet, device=dev)
    ckpt.save(args.ckpt_dir, tcfg.steps, keep=args.keep, params=state.params,
              opt=state.opt_state,
              extra={"final": True, "dataset": args.dataset, "m": args.m, "k": args.k})

    # final evaluation: hybrid (DiskANN) serving on the base set
    model = T.to_model(cfg, state.params)
    codes = pqbase.encode(model, ds.base)
    base_graph = (graph if ds.base.shape[0] == x.shape[0] else build_or_load_graph(
        graph_gen(), ds.base, os.path.join(args.ckpt_dir, "graph_base.npz"),
        args.graph_r, args.graph_l, args.graph_batch))
    engine = HybridEngine(base_graph, codes, lambda q: pqbase.build_lut(model, q),
                          vectors=ds.base, device=dev)
    gt, _ = knn_ids(ds.base, ds.queries, 10)
    res = engine.search(ds.queries, k=10, h=args.beam)
    rec = recall_at_k(res.ids, gt, 10)
    print(f"[train] final recall@10={rec:.4f} mean hops={float(res.hops.float().mean()):.1f}")
    return {"recall": rec, "history": state.history}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="sift-small")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--routing-queries", type=int, default=64)
    ap.add_argument("--refresh-every", type=int, default=100)
    ap.add_argument("--graph-r", type=int, default=24)
    ap.add_argument("--graph-l", type=int, default=48)
    ap.add_argument("--graph-batch", type=int, default=1024,
                    help="nodes per batched Vamana insert round of a graph built "
                    "here (the reference builder's 1024)")
    ap.add_argument("--beam", type=int, default=48)
    ap.add_argument("--ckpt-dir", default="runs/rpq")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint (the driver "
                    "always does when one exists)")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a crash at this step (fault-tolerance demo)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without CUDA pass --device cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    resolve_device(args.device)  # no CUDA and no --device cpu: raise now

    result, restarts = supervise(
        lambda: run(args), max_restarts=args.max_restarts,
        on_restart=lambda n, e: print(f"[supervise] restart {n} after: {e}"))
    if restarts:
        print(f"[supervise] completed after {restarts} restart(s)")
    return result


if __name__ == "__main__":
    main()
