"""Wrappers of the ADC scan kernels (``csrc/adc_scan.cu``).

:func:`adc_scan_batch` replaces ``repro/kernels/adc_scan.py::adc_scan_batch``:
bulk ADC of every code row against a batch of query LUTs, in f32 (the TPU
kernel's bf16 one-hot GEMM is not carried over). It is bound by the (Q, N)
output writes, 4 GB at 1000 × 1M; the f32 shared-memory lookups set a floor
near twice that. Its plan (query tile, grid, each block's share of the work)
is computed here as the kernel computes it, so the CPU tests can check it.

:func:`adc_scan` replaces ``repro/kernels/adc_scan.py::adc_scan``: one
query's LUT against every code row, the retrieval scorer's scan
(``models/recsys.score_candidates_adc``). It is bound by the code bytes and
the (N,) output, 20 MB at 1M × 16.

Callers go through :func:`repro_torch.kernels.ops.adc_scan_batch` and
:func:`repro_torch.kernels.ops.adc_scan`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads them):
launches = 0          # adc_scan_batch
query_launches = 0    # adc_scan, one query

# The batch kernel's plan, as csrc/adc_scan.cu computes it. A block holds
# the LUTs of TQ queries in shared memory, interleaved by query
# ([j][c][TQ]): TQ is the largest of 8, 4, 2, 1 whose tile fits, 8 at M=16,
# K=256 (128 KB, one 768-thread block per SM). A code row is scored by
# TQ / 4 lanes (1 below TQ = 4), each with 4 (or TQ) queries in registers.
# The grid is persistent: the flat (query tile, row) space is cut into one
# contiguous range per block, so a block stages a tile's LUT once per range.
BATCH_THREADS = 768         # the kernel's kBatchThreads
MAX_QUERY_TILE = 8
MAX_TILE_BYTES = 227 * 1024  # shared memory one block may take on the H100
MAX_LUT_BYTES = 200 * 1024   # one query's LUT, the most the wrapper takes

_fn = None
_query_fn = None


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
    """Queries per tile: the largest of 8, 4, 2, 1 whose (TQ, M, K) f32
    LUTs fit MAX_TILE_BYTES (1 for any LUT the wrapper accepts)."""
    tq = MAX_QUERY_TILE
    while tq > 1 and tq * m * k * 4 > MAX_TILE_BYTES:
        tq //= 2
    return tq


def rows_per_pass(tq: int) -> int:
    """Code rows one block scores per pass: TQ / 4 lanes per row."""
    return BATCH_THREADS // max(1, tq // 4)


def grid_blocks(n: int, q: int, tq: int, resident: int) -> int:
    """Blocks launched: all that stay resident on the card (``resident``,
    SMs × blocks per SM), but no more than one per pass of rows or, for
    short N, one per query tile."""
    tiles = -(-q // tq)
    need = max(-(-tiles * n // rows_per_pass(tq)), tiles)
    return min(need, resident)


def block_work(n: int, q: int, tq: int, blocks: int, b: int):
    """Block ``b``'s share of the flat (tile, row) space as the kernel walks
    it: (tile, first row, end row) segments, in order."""
    work = -(-q // tq) * n
    f, hi = work * b // blocks, work * (b + 1) // blocks
    while f < hi:
        tile, r0 = divmod(f, n)
        r1 = min(n, r0 + hi - f)
        yield tile, r0, r1
        f += r1 - r0


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
    """(N, M) uint8 codes × (Q, M, K) f32 LUTs → (Q, N) f32 on the card."""
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
    if m * k * 4 > MAX_LUT_BYTES:
        raise ValueError("adc_scan_batch: one query's LUT must fit in shared memory")
    out = torch.empty((q, n), dtype=torch.float32, device=codes.device)
    return launch(codes, luts, out)


def _query_entry():
    global _query_fn
    if _query_fn is None:
        fn = _build.load("adc_scan").adc_scan_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _query_fn = fn
    return _query_fn


def launch_query(codes: torch.Tensor, lut: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """Launch the one-query kernel on checked tensors; no validation here."""
    global query_launches
    n, m = codes.shape
    if n:
        err = _query_entry()(codes.data_ptr(), n, m, lut.data_ptr(), lut.shape[1],
                             out.data_ptr(), _build.stream_handle(codes.device))
        _build.check("adc_scan", err)
        query_launches += 1
    return out


def adc_scan(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(N, M) uint8 codes × (M, K) f32 LUT → (N,) f32 on the card."""
    for name, t, dtype in (("codes", codes, torch.uint8),
                           ("lut", lut, torch.float32)):
        if t.device.type != "cuda" or t.device != codes.device:
            raise ValueError(f"adc_scan: {name} must be on {codes.device} (CUDA)")
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"adc_scan: {name} must be a contiguous 2-d "
                             f"{dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    n, m = codes.shape
    if lut.shape[0] != m:
        raise ValueError(f"adc_scan: lut {tuple(lut.shape)} does not match "
                         f"codes {tuple(codes.shape)}")
    if lut.shape[1] > 256:
        raise ValueError("adc_scan: uint8 codes address at most K=256 codewords")
    if m * lut.shape[1] * 4 > 200 * 1024:
        raise ValueError("adc_scan: the LUT must fit in shared memory")
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    return launch_query(codes, lut, out)
