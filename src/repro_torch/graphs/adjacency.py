"""Padded fixed-degree adjacency — the PG representation the engines use.

Every proximity graph is an (N, R) int32 tensor of neighbor ids, padded with
the sentinel ``N`` (one past the last valid id), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Graph:
    neighbors: torch.Tensor  # (N, R) int32, sentinel = N for padding
    medoid: torch.Tensor     # () int64 — entry vertex for routing

    @property
    def n(self) -> int:
        return self.neighbors.shape[0]

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]

    def to(self, device) -> "Graph":
        return Graph(self.neighbors.to(device), self.medoid.to(device))


def find_medoid(x: torch.Tensor, sample: int = 4096) -> torch.Tensor:
    """Vector closest to the dataset centroid among the first ``sample``
    rows (DiskANN's entry point; the JAX function's keyless path)."""
    m = min(x.shape[0], sample)
    c = x.mean(dim=0)
    d = ((x[:m] - c) ** 2).sum(dim=1)
    return torch.argmin(d)
