"""Wrapper of the batched ADC scan kernel (``csrc/adc_scan.cu``).

Replaces ``repro/kernels/adc_scan.py::adc_scan_batch``: bulk ADC of every
code row against a batch of query LUTs, in f32 (the TPU kernel's bf16
one-hot GEMM is not carried over). It is bound by the (Q, N) output writes,
4 GB at 1000 × 1M. Callers go through
:func:`repro_torch.kernels.ops.adc_scan_batch`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

# Shared memory a block spends on its query tile's LUTs: 64 KB keeps three
# blocks resident per SM at M=16, K=256 (tile of 4 queries).
LUT_TILE_BYTES = 64 * 1024
MAX_QUERY_TILE = 8          # the kernel's register accumulators per thread
MAX_QUERIES_PER_LAUNCH = 65535  # grid.y limit times the smallest tile

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("adc_scan").adc_scan_batch_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def query_tile(m: int, k: int) -> int:
    """Queries per block: as many LUTs as fit LUT_TILE_BYTES, 1..8."""
    return max(1, min(MAX_QUERY_TILE, LUT_TILE_BYTES // (m * k * 4)))


def launch(codes: torch.Tensor, luts: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors; no validation here."""
    global launches
    n, m = codes.shape
    q, _, k = luts.shape
    if n and q:
        err = _entry()(codes.data_ptr(), n, m, luts.data_ptr(), q, k,
                       query_tile(m, k), out.data_ptr(),
                       _build.stream_handle(codes.device))
        _build.check("adc_scan", err)
        launches += 1
    return out


def adc_scan_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(N, M) uint8 codes × (Q, M, K) f32 LUTs → (Q, N) f32 on the card.
    Query batches beyond the grid's reach go in chunks of
    MAX_QUERIES_PER_LAUNCH, each written in place into the output."""
    for name, t, dtype, ndim in (("codes", codes, torch.uint8, 2),
                                 ("luts", luts, torch.float32, 3)):
        if t.device.type != "cuda" or t.device != codes.device:
            raise ValueError(f"adc_scan_batch: {name} must be on {codes.device} (CUDA)")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"adc_scan_batch: {name} must be a contiguous "
                             f"{ndim}-d {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    n, m = codes.shape
    q, lm, k = luts.shape
    if lm != m:
        raise ValueError(f"adc_scan_batch: luts {tuple(luts.shape)} do not "
                         f"match codes {tuple(codes.shape)}")
    if k > 256:
        raise ValueError("adc_scan_batch: uint8 codes address at most K=256 codewords")
    if m * k * 4 > 200 * 1024:
        raise ValueError("adc_scan_batch: one query's LUT must fit in shared memory")
    out = torch.empty((q, n), dtype=torch.float32, device=codes.device)
    for q0 in range(0, q, MAX_QUERIES_PER_LAUNCH):
        q1 = min(q, q0 + MAX_QUERIES_PER_LAUNCH)
        launch(codes, luts[q0:q1], out[q0:q1])
    return out
