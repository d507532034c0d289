"""Meshes as data, for the sharding rules and the dry-run cells. Port of
``repro/launch/mesh.py``.

A :class:`Mesh` holds the axis names and their sizes and nothing else: no
devices and no process group. The rules of ``dist/sharding.py`` need only
names and sizes, so the reference's production meshes (16×16 and 2×16×16
TPU chips) are described here without the devices they name. Axis
semantics:

  pod    — inter-pod data parallelism (DCN-connected slices)
  data   — intra-pod data / FSDP axis (batch, parameter shards)
  model  — tensor/expert/table parallel axis

Hardware constants are the NVIDIA H100 SXM5 80GB's (700 W), from NVIDIA's
data sheet; the card's own HBM capacity comes from
``torch.cuda.get_device_properties`` where a card is present
(:func:`hbm_capacity_bytes`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

# NVIDIA H100 SXM5 80GB, 700 W (data sheet): dense bf16 tensor-core FLOP/s,
# HBM3 bytes/s, NVLink 4 bytes/s per link and direction (900 GB/s both ways
# over 18 links), and the HBM size the data sheet names.
CARD = "NVIDIA H100 80GB HBM3, 700 W (SXM5 data sheet)"
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW_PER_LINK = 25e9
HBM_BYTES = 80e9

PRODUCTION_MESHES = {"1pod_16x16": False, "2pod_2x16x16": True}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names in order and ``shape`` as {axis name: size}."""
    axis_names: tuple
    shape: dict


def make_mesh(sizes: tuple, names: tuple) -> Mesh:
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} sizes for {len(names)} axis names")
    return Mesh(tuple(names), dict(zip(names, (int(s) for s in sizes))))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
    ``("pod", "data", "model")`` with ``multi_pod``."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_host_mesh(device=None) -> Mesh:
    """(1, n) ``("data", "model")``: n visible CUDA devices on ``device``
    (default ``cuda``, which raises without CUDA), 1 on the CPU."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_mesh((1, n), ("data", "model"))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """All batch-parallel axes present in ``mesh`` (pod included if any)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def hbm_capacity_bytes(device=None) -> int:
    """Device memory of the card behind ``device`` (``total_memory``); the
    data sheet's :data:`HBM_BYTES` on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(HBM_BYTES)
