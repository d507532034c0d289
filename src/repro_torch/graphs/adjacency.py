"""Padded fixed-degree adjacency — the PG representation the engines use.

Every proximity graph is an (N, R) int32 tensor of neighbor ids, padded with
the sentinel ``N`` (one past the last valid id), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


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


def from_lists(lists, r: int, medoid: int, *, device=None) -> Graph:
    """Ragged neighbor lists → padded Graph on ``device`` (default
    ``cuda``); lists longer than ``r`` are cut."""
    n = len(lists)
    out = np.full((n, r), n, np.int32)
    for i, lst in enumerate(lists):
        lst = np.asarray(lst, np.int32)[:r]
        out[i, :len(lst)] = lst
    dev = resolve_device(device)
    return Graph(neighbors=torch.from_numpy(out).to(dev),
                 medoid=torch.tensor(int(medoid), device=dev))


def degree_stats(g: Graph) -> dict:
    valid = (g.neighbors < g.n).sum(dim=1).cpu().numpy()
    return {"mean": float(valid.mean()), "min": int(valid.min()),
            "max": int(valid.max()), "R": g.degree, "n": g.n}


def symmetrize(neighbors: np.ndarray, r: int) -> np.ndarray:
    """Add reverse edges (dropping overflow) to an (N, R) host adjacency —
    the reference's numpy routine, copied."""
    n = neighbors.shape[0]
    lists: list[list[int]] = [list(row[row < n]) for row in neighbors]
    for i in range(n):
        for j in neighbors[i]:
            if j < n and i not in lists[j][:r]:
                if len(lists[j]) < r:
                    lists[j].append(i)
    out = np.full((n, r), n, np.int32)
    for i, lst in enumerate(lists):
        out[i, : min(len(lst), r)] = np.asarray(lst[:r], np.int32)
    return out


def find_medoid(x: torch.Tensor, sample: int = 4096,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Vector closest to the dataset centroid (DiskANN's entry point),
    among ``sample`` rows: drawn without replacement from a CPU
    ``generator`` when one is given and N > sample, else the first rows."""
    n = x.shape[0]
    if generator is not None and n > sample:
        idx = torch.randperm(n, generator=generator)[:sample].to(x.device)
    else:
        idx = torch.arange(min(n, sample), device=x.device)
    c = x.mean(dim=0)
    d = ((x[idx] - c) ** 2).sum(dim=1)
    return idx[torch.argmin(d)]
