"""The system under test, set up through the program: a Vamana graph over
the base and an RPQ quantizer trained on it, cached in the checkout, then
the resident codes and the configuration's serving engine, which
``perfbench/engines/<engine>.py`` makes from them (``hybrid`` where the
configuration names none).

The cache (``perfbench/.cache/index-<key>.pt``) holds the graph and the
trained quantizer's state. Its key is the configuration's name, its data
seed, the configuration's build settings, the generator's source and every
source file of the program, so a change to any of them builds anew. A run
that finds it loads it; the first run in a checkout builds it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = ROOT / "src" / "repro_torch"
CACHE = BENCH / ".cache"
BUILD_KEYS = ("n_base", "dim", "data", "graph_r", "graph_l", "graph_alpha",
              "graph_passes", "graph_batch", "graph_seed", "layout", "pq_m",
              "pq_k", "train_steps", "train_seed")


def cache_key(cfg: dict) -> str:
    """Hex key of everything the cached index depends on."""
    h = hashlib.sha256()
    h.update(json.dumps({k: cfg.get(k) for k in BUILD_KEYS}, sort_keys=True).encode())
    h.update((BENCH / "gen.py").read_bytes())
    for path in sorted(p for p in PROGRAM.rglob("*") if p.is_file()
                       and "__pycache__" not in p.parts):
        h.update(str(path.relative_to(PROGRAM)).encode())
        h.update(path.read_bytes())
    return f"{cfg['name']}-{cfg['data']['seed']}-{h.hexdigest()[:16]}"


@dataclasses.dataclass
class Index:
    """The program's serving state and what the reference may read of it:
    the trained quantizer's rotation generator and codebooks."""
    engine: object
    codes: torch.Tensor          # resident codes: (N, M) u8, or (N, M/2) packed
    theta: torch.Tensor
    codebooks: torch.Tensor
    built: bool                  # True when this run built the index
    build_s: float


def _rpq_cfg(cfg: dict):
    from repro_torch.core.quantizer import RPQConfig

    return RPQConfig(dim=cfg["dim"], m=cfg["pq_m"], k=cfg["pq_k"])


def _build(cfg: dict, x: torch.Tensor, device) -> dict:
    from repro_torch.core.trainer import TrainConfig, fit
    from repro_torch.graphs.vamana import build_vamana

    graph = build_vamana(x, generator=torch.Generator().manual_seed(cfg["graph_seed"]),
                         r=cfg["graph_r"], l=cfg["graph_l"], alpha=cfg["graph_alpha"],
                         passes=cfg["graph_passes"], batch=cfg["graph_batch"],
                         device=device)
    state = fit(_rpq_cfg(cfg), TrainConfig(steps=cfg["train_steps"]), x, graph,
                seed=cfg["train_seed"], verbose=False, device=device)
    return {"neighbors": graph.neighbors.cpu(), "medoid": graph.medoid.cpu(),
            "theta": state.params.theta.detach().cpu(),
            "codebooks": state.params.codebooks.detach().cpu(),
            "log_alpha": state.params.log_alpha.detach().cpu()}


def load_or_build(cfg: dict, x: torch.Tensor, device, make_engine, *,
                  use_cache: bool = True, mark=lambda name: None) -> Index:
    """The cell's engine over base ``x``: the cached graph and quantizer, or
    a fresh build saved to the cache, made into the serving engine by
    ``make_engine(cfg, graph, model, codes, x, device)`` (an engine
    module's ``make``). The engine is no build setting and stays out of
    the cache key. ``mark(name)`` closes each phase of the set-up's
    timing."""
    from repro_torch.core.quantizer import RPQParams
    from repro_torch.core.trainer import to_model
    from repro_torch.graphs.adjacency import Graph
    from repro_torch.pq import base as pqbase
    from repro_torch.pq.pack import pack_codes

    mark("index_imports")
    path = CACHE / f"index-{cache_key(cfg)}.pt"
    mark("index_key")
    t0 = time.perf_counter()
    built = not (use_cache and path.exists())
    if built:
        state = _build(cfg, x, device)
        if use_cache:
            CACHE.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
            torch.save(state, tmp)
            os.replace(tmp, path)
    else:
        state = torch.load(path, map_location="cpu")
    build_s = time.perf_counter() - t0
    mark("index_load")
    graph = Graph(neighbors=state["neighbors"].to(device), medoid=state["medoid"].to(device))
    params = RPQParams(state["theta"].to(device), state["codebooks"].to(device),
                       state["log_alpha"].to(device))
    model = to_model(_rpq_cfg(cfg), params)
    mark("index_to_device")
    codes = pqbase.encode(model, x)
    if cfg["layout"] == "fs4":
        codes = pack_codes(codes)
    mark("index_encode")
    engine = make_engine(cfg, graph, model, codes, x, device)
    mark("index_engine")
    return Index(engine, codes, params.theta.detach(), params.codebooks.detach(),
                 built, build_s)
