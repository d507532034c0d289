"""Top-level RPQ API — one import for the whole paper pipeline.

Port of ``repro/core/rpq.py``::

    from repro_torch.core.rpq import train_rpq
    rpq = train_rpq(x, graph, seed=0)       # paper Fig. 2, end to end
    codes = rpq.encode(x)
    engine = InMemoryEngine(graph, codes, rpq.lut_fn())
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import quantizer as Q
from repro_torch.core import trainer as T
from repro_torch.graphs.adjacency import Graph
from repro_torch.pq import base as pqbase


@dataclasses.dataclass
class RPQ:
    cfg: Q.RPQConfig
    params: Q.RPQParams
    history: list

    @property
    def model(self) -> pqbase.QuantizerModel:
        return T.to_model(self.cfg, self.params)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return pqbase.encode(self.model, x)

    def lut_fn(self):
        model = self.model
        return lambda q: pqbase.build_lut(model, q)


def train_rpq(x: torch.Tensor, graph: Graph, *, seed: int = 0, m: int = 8,
              k: int = 256, cfg: Optional[Q.RPQConfig] = None,
              tcfg: Optional[T.TrainConfig] = None, verbose: bool = True,
              device=None) -> RPQ:
    if cfg is None:
        cfg = Q.RPQConfig(dim=x.shape[1], m=m, k=k)
    if tcfg is None:
        tcfg = T.TrainConfig()
    state = T.fit(cfg, tcfg, x, graph, seed=seed, verbose=verbose, device=device)
    return RPQ(cfg=cfg, params=state.params, history=state.history)
