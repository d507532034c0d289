"""End-to-end fault-tolerant training demo on the PyTorch + CUDA port.

    PYTHONPATH=src python examples/train_rpq_e2e_torch.py [--device cpu]

The twin of ``examples/train_rpq_e2e.py``: a thin wrapper over
``repro_torch.launch.train`` that trains RPQ for a few hundred steps with
checkpointing, INJECTS A CRASH mid-run, and lets the supervisor restart
from the latest checkpoint — then evaluates serving recall. A caller can
pass its own :class:`Args` (fewer ``steps``, another ``fail_at_step``, a
``ckpt_dir`` of its own) to :func:`main`.
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.device import resolve_device
from repro_torch.dist.fault import supervise
from repro_torch.launch import train as T


class Args:
    dataset = "sift-small"
    scale = None
    steps = 300
    m = 8
    k = 64
    batch = 256
    routing_queries = 64
    refresh_every = 75
    graph_r = 24
    graph_l = 48
    graph_batch = 1024
    beam = 48
    ckpt_dir = "runs/e2e_demo"
    checkpoint_every = 50
    keep = 3
    log_every = 50
    seed = 0
    resume = False
    fail_at_step = 160          # <- injected node failure
    max_restarts = 3
    quiet = False
    device = "cuda"


def main(args=None) -> dict:
    if args is None:
        ap = argparse.ArgumentParser()
        ap.add_argument("--device", default="cuda",
                        help="torch device; without CUDA pass --device cpu")
        args = Args()
        args.device = ap.parse_args().device
    resolve_device(args.device)  # no CUDA and no --device cpu: raise now
    print(f"[e2e] training RPQ on {args.dataset} for {args.steps} steps; "
          f"a crash will be injected at step {args.fail_at_step}")
    result, restarts = supervise(
        lambda: T.run(args), max_restarts=args.max_restarts,
        on_restart=lambda n, e: print(f"[e2e] supervisor restart #{n}: {e}"))
    print(f"[e2e] finished with {restarts} restart(s); "
          f"final recall@10 = {result['recall']:.3f}")
    return dict(result, restarts=restarts)


if __name__ == "__main__":
    main()
