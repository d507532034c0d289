"""Synthetic vector datasets emulating the paper's benchmarks (§8.1 Table 3).

A copy of the JAX package's ``data/synth.py`` generator: the same numpy
draws in the same order, so the arrays are bit-identical to the
reference's; only the container differs (tensors on ``device``). SIFT/GIST/
Deep/BigANN/UKBench are emulated with matched dimensionality, cluster
structure and a decaying spectrum (what OPQ/RPQ's rotation exploits).

``load_dataset`` also reads real ``.fvecs`` / ``.npy`` files when present.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    dim: int
    n_base: int
    n_query: int
    n_clusters: int
    noise: float          # within-cluster std (vs unit centers)
    spectrum_decay: float  # eigenvalue ratio last/first (1.0 = isotropic)
    seed: int = 0


# paper Table 3 stand-ins (dims faithful; sizes scaled by ``scale``)
SPECS = {
    "sift": DatasetSpec("sift", 128, 100_000, 1_000, 200, 0.35, 0.10),
    "gist": DatasetSpec("gist", 960, 20_000, 200, 100, 0.30, 0.02),
    "deep": DatasetSpec("deep", 96, 100_000, 1_000, 200, 0.35, 0.20),
    "bigann": DatasetSpec("bigann", 128, 100_000, 1_000, 200, 0.35, 0.10),
    "ukbench": DatasetSpec("ukbench", 128, 50_000, 200, 500, 0.25, 0.15),
    # small variants for tests / quick examples
    "sift-small": DatasetSpec("sift-small", 64, 10_000, 200, 64, 0.35, 0.15),
    "unit-test": DatasetSpec("unit-test", 32, 2_000, 100, 20, 0.35, 0.25),
}


@dataclasses.dataclass
class Dataset:
    name: str
    base: torch.Tensor     # (N, D) f32
    queries: torch.Tensor  # (Q, D) f32
    train: torch.Tensor    # (T, D) f32 — quantizer training subset

    @property
    def dim(self) -> int:
        return self.base.shape[1]


def _dataset(name: str, base: np.ndarray, queries: np.ndarray,
             train: np.ndarray, device: torch.device) -> Dataset:
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Dataset(name, as_t(base), as_t(queries), as_t(train))


def synth(spec: DatasetSpec, *, scale: Optional[float] = None,
          device=None) -> Dataset:
    """Generate a clustered anisotropic dataset (+ held-out queries) on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    n, d = spec.n_base, spec.dim
    if scale:
        n = max(int(n * scale), 1000)
    centers = rng.normal(size=(spec.n_clusters, d)).astype(np.float32)
    # anisotropic basis: random rotation × decaying spectrum
    q_basis, _ = np.linalg.qr(rng.normal(size=(d, d)))
    eigs = np.geomspace(1.0, spec.spectrum_decay, d)
    basis = (q_basis * eigs[None, :]).astype(np.float32)

    def draw(count: int, seed: int) -> np.ndarray:
        r = np.random.default_rng(seed)
        asg = r.integers(0, spec.n_clusters, count)
        pts = centers[asg] + spec.noise * r.normal(size=(count, d)).astype(np.float32)
        return (pts @ basis).astype(np.float32)

    base = draw(n, spec.seed + 1)
    queries = draw(spec.n_query, spec.seed + 2)
    # paper: train on a 500K subset of the base — we use 50% (≤ 500k)
    t = min(n // 2, 500_000)
    train = base[rng.permutation(n)[:t]].copy()
    return _dataset(spec.name, base, queries, train, dev)


def _read_fvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    d = raw[0]
    raw = raw.reshape(-1, d + 1)[:, 1:]
    if max_rows:
        raw = raw[:max_rows]
    return raw.view(np.float32).copy()


def load_dataset(name: str, *, data_dir: str = "data",
                 scale: Optional[float] = None, device=None) -> Dataset:
    """Real files if present (``<data_dir>/<name>_base.fvecs|.npy``), else
    synth. Tensors land on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    base_f = os.path.join(data_dir, f"{name}_base")
    query_f = os.path.join(data_dir, f"{name}_query")
    if os.path.exists(base_f + ".npy"):
        base = np.load(base_f + ".npy").astype(np.float32)
        queries = np.load(query_f + ".npy").astype(np.float32)
    elif os.path.exists(base_f + ".fvecs"):
        base = _read_fvecs(base_f + ".fvecs")
        queries = _read_fvecs(query_f + ".fvecs")
    else:
        if name not in SPECS:
            raise KeyError(f"unknown dataset {name!r}; options: {sorted(SPECS)}")
        return synth(SPECS[name], scale=scale, device=dev)
    rng = np.random.default_rng(0)
    t = min(len(base) // 2, 500_000)
    train = base[rng.permutation(len(base))[:t]].copy()
    return _dataset(name, base, queries, train, dev)
