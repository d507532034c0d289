"""Wrapper of the batched fast-scan ADC kernel (``csrc/adc_scan_fs.cu``).

Replaces ``repro/kernels/adc_scan_fs.py::adc_scan_fs``: bulk ADC of every
packed code row against a batch of uint8 query LUTs, as exact int32 sums
(the TPU kernel's bf16 one-hot GEMM is not carried over). It is bound by
the (Q, N) int32 output writes, 4 GB at 1000 × 1M. Callers go through
:func:`repro_torch.kernels.ops.adc_scan_fs`, which dequantizes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

TILE_Q = 8                      # queries per block (the kernel's kTileQ)
MAX_QUERIES_PER_LAUNCH = 65535 * TILE_Q   # grid.y limit
# The block's paired table is ceil(M/2) × 256 × 16 bytes of shared memory.
MAX_TABLE_BYTES = 200 * 1024

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("adc_scan_fs").adc_scan_fs_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(packed: torch.Tensor, luts_u8: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors; no validation here."""
    global launches
    n, mb = packed.shape
    q, m, _ = luts_u8.shape
    if n and q:
        err = _entry()(packed.data_ptr(), n, mb, luts_u8.data_ptr(), q, m,
                       out.data_ptr(), _build.stream_handle(packed.device))
        _build.check("adc_scan_fs", err)
        launches += 1
    return out


def adc_scan_fs(packed: torch.Tensor, luts_u8: torch.Tensor) -> torch.Tensor:
    """(N, ceil(M/2)) uint8 packed codes × (Q, M, 16) uint8 LUTs → (Q, N)
    int32 exact accumulators on the card. Query batches beyond the grid's
    reach go in chunks, each written in place into the output."""
    for name, t, ndim in (("packed", packed, 2), ("luts_u8", luts_u8, 3)):
        if t.device.type != "cuda" or t.device != packed.device:
            raise ValueError(f"adc_scan_fs: {name} must be on {packed.device} (CUDA)")
        if t.dtype != torch.uint8 or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"adc_scan_fs: {name} must be a contiguous {ndim}-d "
                             f"uint8 tensor, got {t.dtype} {tuple(t.shape)}")
    n, mb = packed.shape
    q, m, k = luts_u8.shape
    if k != 16 or (m + 1) // 2 != mb:
        raise ValueError(f"adc_scan_fs: luts_u8 {tuple(luts_u8.shape)} do not "
                         f"match packed {tuple(packed.shape)}")
    if mb * 256 * 16 > MAX_TABLE_BYTES:
        raise ValueError(f"adc_scan_fs: M={m} needs a paired table beyond "
                         f"{MAX_TABLE_BYTES} bytes of shared memory")
    out = torch.empty((q, n), dtype=torch.int32, device=packed.device)
    for q0 in range(0, q, MAX_QUERIES_PER_LAUNCH):
        q1 = min(q, q0 + MAX_QUERIES_PER_LAUNCH)
        launch(packed, luts_u8[q0:q1], out[q0:q1])
    return out
