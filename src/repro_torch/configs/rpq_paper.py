"""rpq (the paper's own system) as an 11th selectable arch.

train  : 500K×128 quantizer training step (paper §8.1 training subset)
serve  : batched ADC beam-search serving over a 1M-code index
"""
import dataclasses

from repro_torch.configs import base
from repro_torch.core.quantizer import RPQConfig


@dataclasses.dataclass(frozen=True)
class RPQArchConfig:
    name: str
    quant: RPQConfig
    n_base: int
    n_train: int
    beam_h: int = 32
    graph_degree: int = 64


def make_config() -> RPQArchConfig:
    return RPQArchConfig(name="rpq", quant=RPQConfig(dim=128, m=16, k=256),
                         n_base=1_000_000, n_train=500_000)


def make_reduced() -> RPQArchConfig:
    return RPQArchConfig(name="rpq-reduced",
                         quant=RPQConfig(dim=32, m=4, k=32),
                         n_base=2000, n_train=1000, beam_h=8,
                         graph_degree=8)


RPQ_SHAPES = (
    base.ShapeSpec("quant_train", "train",
                   dict(batch=8192, routing_batch=4096, h=16)),
    base.ShapeSpec("serve_1m", "serve",
                   dict(n_base=1_000_000, query_batch=4096, k=10)),
    base.ShapeSpec("encode_bulk", "serve", dict(batch=1_000_000)),
    base.ShapeSpec("adc_bulk", "retrieval",
                   dict(n_codes=1_000_000, query_batch=1024)),
    # graph-ROUTED sharded serving: per-shard Vamana beam search inside
    # shard_map (search/engine.sharded_graph_topk), R=32 adjacency
    base.ShapeSpec("sharded_graph", "serve",
                   dict(n_base=1_000_000, query_batch=256, k=10, h=32,
                        r=32)),
    # same routing scenario in the FAST-SCAN layout (DESIGN.md §8):
    # 4-bit packed codes (M/2 bytes/row resident) + uint8 QuantizedLUTs
    base.ShapeSpec("sharded_graph_fs4", "serve",
                   dict(n_base=1_000_000, query_batch=256, k=10, h=32,
                        r=32)),
    # FRONTIER-BATCHED routing (DESIGN.md §9): expand=4 beam over an R=64
    # subgraph — every round is one E·R = 256-wide fused hop-ADC call
    base.ShapeSpec("sharded_graph_wide", "serve",
                   dict(n_base=1_000_000, query_batch=256, k=10, h=32,
                        r=64, expand=4)),
)

base.register(base.ArchSpec(
    arch_id="rpq", family="rpq", make_config=make_config,
    make_reduced=make_reduced, shapes=RPQ_SHAPES,
    source="this paper"))
