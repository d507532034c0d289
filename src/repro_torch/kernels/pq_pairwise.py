"""Wrapper of the per-subspace distance-table kernel (``csrc/pq_pairwise.cu``).

Replaces ``repro/kernels/pq_pairwise.py::pq_pairwise``. It serves k-means
assignment, ``encode`` and ``build_lut``, and is bound by its output
writes: the (N, M, K) f32 table is 16 GB at 1M × 16 × 256, so callers that
reduce it (``pq.base.encode``, ``pq.kmeans``) go through it in row chunks.
Callers go through :func:`repro_torch.kernels.ops.pq_pairwise`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("pq_pairwise").pq_pairwise_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(x: torch.Tensor, codebook: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors; no validation here."""
    global launches
    n, m, dsub = x.shape
    k = codebook.shape[1]
    if n and m and k:
        err = _entry()(x.data_ptr(), codebook.data_ptr(), out.data_ptr(), n, m,
                       k, dsub, _build.stream_handle(x.device))
        _build.check("pq_pairwise", err)
        launches += 1
    return out


def pq_pairwise(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, M, dsub) × (M, K, dsub) f32 → (N, M, K) f32 on the card."""
    for name, t in (("x", x), ("codebook", codebook)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"pq_pairwise: {name} must be on {x.device} (CUDA)")
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"pq_pairwise: {name} must be a contiguous 3-d "
                             f"float32 tensor, got {t.dtype} {tuple(t.shape)}")
    n, m, dsub = x.shape
    if codebook.shape[0] != m or codebook.shape[2] != dsub:
        raise ValueError(f"pq_pairwise: codebook {tuple(codebook.shape)} does "
                         f"not match x {tuple(x.shape)}")
    if m > 65535:
        raise ValueError("pq_pairwise: at most 65535 subspaces")
    out = torch.empty((n, m, codebook.shape[1]), dtype=torch.float32,
                      device=x.device)
    return launch(x, codebook, out)
