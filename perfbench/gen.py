"""The benchmark's data generator: clustered vectors in a low-dimensional
latent space, mapped linearly to the published width with small noise.

A base drawn this way behaves under product quantization like SIFT or Deep:
neighbours lie along a few latent directions, so a 16-byte code separates
them (an isotropic Gaussian blob in full width does not: its neighbours are
all but equidistant). Everything is drawn on the device with a
``torch.Generator`` in a few large calls. The base comes from the data seed
of the configuration file (a public dataset is one fixed file); queries and
arrivals come from the run's ``--seed``.

The configuration's ``data`` section gives the constants:
``dim``, ``n_base``, ``latent_dim``, ``n_clusters``, ``center_std``,
``cluster_std``, ``noise_std``, ``seed`` and ``kind``: ``"uint8"`` (SIFT:
non-negative integers up to 255, held as float32, ``offset`` + ``scale`` ·
y rounded and clipped) or ``"unit"`` (Deep: unit-norm rows).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# purposes of the generators drawn from one seed
MAP, BASE, QUERIES, ARRIVALS, ORDER, SAMPLE = range(6)


def generator(device, seed: int, purpose: int) -> torch.Generator:
    """A generator on ``device`` for (seed, purpose); any non-negative
    seed, 64-bit values included, gives its own stream."""
    state = np.random.SeedSequence([int(seed), purpose]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def _latent_map(spec: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cluster centres (C, L), linear map (L, D)) of the data seed."""
    g = generator(device, spec["seed"], MAP)
    lat, dim = spec["latent_dim"], spec["dim"]
    centers = torch.randn((spec["n_clusters"], lat), generator=g, device=device)
    w = torch.randn((lat, dim), generator=g, device=device) / math.sqrt(lat)
    return centers * spec["center_std"], w


def _draw(spec: dict, n: int, g: torch.Generator, device,
          latent=None) -> torch.Tensor:
    centers, w = _latent_map(spec, device) if latent is None else latent
    which = torch.randint(0, centers.shape[0], (n,), generator=g, device=device)
    z = centers[which] + spec["cluster_std"] * torch.randn(
        (n, centers.shape[1]), generator=g, device=device)
    noise = torch.randn((n, spec["dim"]), generator=g, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = z @ w + spec["noise_std"] * noise
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if spec["kind"] == "uint8":
        return torch.clamp(torch.round(spec["offset"] + spec["scale"] * y), 0, 255)
    if spec["kind"] == "unit":
        return y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    raise ValueError(f"unknown data kind {spec['kind']!r}")


def base(spec: dict, device) -> torch.Tensor:
    """The (n_base, dim) float32 base of the configuration's data seed."""
    return _draw(spec, spec["n_base"], generator(device, spec["seed"], BASE), device)


class QueryStream:
    """Queries of the run's seed from the base's distribution (the same
    clusters and map, fresh draws): successive :meth:`take` calls continue
    one stream, so a run's queries depend only on the seed and on how many
    it has taken."""

    def __init__(self, spec: dict, seed: int, device):
        self.spec, self.device = spec, device
        self.latent = _latent_map(spec, device)
        self.gen = generator(device, seed, QUERIES)

    def take(self, n: int) -> torch.Tensor:
        """The next (n, dim) float32 queries."""
        return _draw(self.spec, n, self.gen, self.device, self.latent)


def pooled(spec: dict, n: int, pool_seed: int, seed: int, device) -> torch.Tensor:
    """(n, dim) queries: a pool of n drawn from ``pool_seed`` in the order
    the run's ``seed`` draws, so every seed offers the same queries in
    another order."""
    pool = QueryStream(spec, pool_seed, device).take(n)
    return pool[torch.randperm(n, generator=generator("cpu", seed, ORDER)).to(device)]


def arrivals(rate: float, n: int, gap_seed: int, seed: int) -> np.ndarray:
    """(n,) due times in seconds of a Poisson stream at ``rate`` per
    second: the exponential gaps come from the traffic file's ``gap_seed``
    and the run's ``seed`` only reorders them, so every seed offers the
    same gaps in another order."""
    gaps = torch.empty(n, dtype=torch.float64).exponential_(
        rate, generator=generator("cpu", gap_seed, ARRIVALS))
    order = torch.randperm(n, generator=generator("cpu", seed, ORDER))
    return np.cumsum(gaps[order].numpy())
