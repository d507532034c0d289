"""Arch registry: --arch <id> → (family, config, shapes). Port of
``repro/configs/base.py``.

Every architecture registers here with its published config and its own
input-shape set. `make_reduced()` returns the small same-family config the
CPU tests use; a full config too large for one card is touched only on the
``meta`` device (shapes and parameter counts).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | serve | retrieval | graph
    dims: dict
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str        # lm | gnn | recsys
    make_config: Callable[[], Any]
    make_reduced: Callable[[], Any]
    shapes: tuple[ShapeSpec, ...]
    source: str        # citation tag from the assignment
    notes: str = ""


def register(spec: ArchSpec):
    _REGISTRY[spec.arch_id] = spec
    return spec


_MODULES = [
    "granite_3_8b", "llama3_405b", "starcoder2_3b", "granite_moe_1b_a400m",
    "olmoe_1b_7b", "gat_cora", "bert4rec", "deepfm", "din", "dlrm_mlperf",
    "rpq_paper",
]


def _ensure_loaded():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


# Shared LM shape set (the brief: seq_len × global_batch per mode)
LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1),
              note="decode-only is O(S)/token, runnable for full attention; "
                   "500k PREFILL would need sub-quadratic attention "
                   "(DESIGN.md §5)"),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "graph",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    ShapeSpec("minibatch_lg", "graph",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout=(15, 10))),
    ShapeSpec("ogb_products", "graph",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    ShapeSpec("molecule", "graph",
              dict(n_nodes=30, n_edges=64, batch=128)),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)
