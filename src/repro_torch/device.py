"""The one device-resolution rule of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without CUDA raises: an entry
    point never carries on silently on the CPU — the caller asks for it
    with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def full_f32_matmul() -> None:
    """Run f32 matrix products and convolutions in full f32 on the card.

    Sets PyTorch's process-wide TF32 switches off (TF32 keeps about three
    decimal digits, too few for distances that the port compares with the
    JAX reference). ``knn_ids`` and ``rotate_split`` call it before their
    products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def visible_cuda_devices() -> int:
    """The visible CUDA devices, at least 1: the default shard and replica
    count, as the reference's default mesh is ``len(jax.devices())``."""
    return max(1, torch.cuda.device_count())
