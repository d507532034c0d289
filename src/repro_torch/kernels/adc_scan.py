"""Wrappers of the ADC scan kernels (``csrc/adc_scan.cu``).

:func:`adc_scan_batch` replaces ``repro/kernels/adc_scan.py::adc_scan_batch``:
bulk ADC of every code row against a batch of query LUTs, in f32 (the TPU
kernel's bf16 one-hot GEMM is not carried over), for uint8 codes and (K >
256) int32 codes, the latter packed into uint16 by a first kernel into
scratch allocated here; a LUT passing shared memory goes in subspace
chunks. It is bound by the (Q, N) output writes, 4 GB at 1000 × 1M; the f32
shared-memory lookups set a floor near twice that. Its plan (query tile,
grid, each block's share of the work, the row loads, the packed layout) is
computed here as the kernel computes it, so the CPU tests can check it.

:func:`adc_scan` replaces ``repro/kernels/adc_scan.py::adc_scan``: one
query's LUT against every code row, the retrieval scorer's scan
(``models/recsys.score_candidates_adc``). It is bound by the code bytes and
the (N,) output, 20 MB at 1M × 16; its random shared-memory lookups set a
floor of about the same size. The 16-byte row vectors a thread holds are
picked here (``hop_adc.row_vectors``); the kernel sizes its grid by its own
occupancy.

Callers go through :func:`repro_torch.kernels.ops.adc_scan_batch` and
:func:`repro_torch.kernels.ops.adc_scan`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hop_adc import (CODE_DTYPES, MAX_LUT_BYTES, prefetch_vectors,
                                        row_vectors, subspace_chunks)

# kernel launches since the last reset (chip_smoke.py reads them):
launches = 0              # adc_scan_batch, uint8 codes
launches_i32 = 0          # adc_scan_batch, int32 codes (K > 256)
query_launches = 0        # adc_scan, one query, uint8 codes
query_launches_i32 = 0    # adc_scan, int32 codes

# The batch kernel's plan, as csrc/adc_scan.cu computes it. A block holds
# the LUTs of TQ queries in shared memory, interleaved by query
# ([j][c][TQ]): TQ is the largest of 8, 4, 2, 1 whose tile fits, 8 at M=16,
# K=256 (128 KB, one 768-thread block per SM), 4 at K=512. A code row is
# scored by TQ / 4 lanes (1 below TQ = 4), each with 4 (or TQ) queries in
# registers. The grid is persistent: the flat (query tile, row) space is cut
# into one contiguous range per block, so a block stages a tile's LUT once
# per range. uint8 rows on 16 bytes are read as 16-byte vectors, the first
# of a lane's next row loaded ahead (byte loads otherwise). int32 codes are
# first packed into uint16, vector-major in groups of PACK_GROUP rows
# (``packed_index``), into scratch the wrapper allocates, so that a warp's
# 32 rows read each 16-byte vector as 512 contiguous bytes; a lane loads
# the first (up to 4) vectors of its next packed row ahead.
BATCH_THREADS = 768         # the kernel's kBatchThreads
MAX_QUERY_TILE = 8
MAX_TILE_BYTES = 227 * 1024  # shared memory one block may take on the H100
PACK_GROUP = 32             # the kernel's kGroup
# One query's LUT beyond MAX_LUT_BYTES (200 KB, hop_adc.py) goes in
# subspace chunks (hop_adc.subspace_chunks), each launch continuing the sums.

_fn = None
_query_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("adc_scan").adc_scan_batch_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
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


def packed_vectors(mc: int) -> int:
    """16-byte vectors of a packed row of ``mc`` uint16 codes."""
    return -(-mc // 8)


def packed_index(row: int, v: int, nv: int) -> int:
    """The 16-byte vector v (codes 8v .. 8v + 7) of packed row ``row``, rows
    of ``nv`` vectors: vector-major within each group of PACK_GROUP rows."""
    return ((row // PACK_GROUP) * nv + v) * PACK_GROUP + row % PACK_GROUP


def packed_bytes(n: int, mc: int) -> int:
    """Scratch of the packed codes: whole groups of rows, zeros past ``n``."""
    return -(-n // PACK_GROUP) * PACK_GROUP * packed_vectors(mc) * 16


def batch_prefetch(ptr: int, ldc: int, j0: int, mc: int, size: int) -> int:
    """16-byte vectors of its next row a lane loads while it scores this one
    (the kernel's kPre), for the codes [j0, j0 + mc) of rows of ``ldc``
    codes of ``size`` bytes at ``ptr``: uint8 rows 1 where every row and
    the chunk start on 16 bytes and the chunk fills whole vectors, else 0
    (byte loads); int32 codes, packed, the smallest of 1, 2, 4 that covers
    the row, at most 4 (the rest load during the sum)."""
    if size == 1:
        return int((ptr + j0) % 16 == 0 and ldc % 16 == 0 and mc % 16 == 0)
    return prefetch_vectors(packed_vectors(mc))


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


def lut_stages(n: int, q: int, tq: int, blocks: int) -> int:
    """Tile LUTs the blocks stage in shared memory in one launch: one at
    each change of tile along a block's segments."""
    return sum(len({tile for tile, _, _ in block_work(n, q, tq, blocks, b)})
               for b in range(blocks))


def _check(fn: str, tensors) -> None:
    for name, t, dtypes, ndim in tensors:
        if t.device.type != "cuda" or t.device != tensors[0][1].device:
            raise ValueError(f"{fn}: {name} must be on {tensors[0][1].device} (CUDA)")
        if t.dtype not in dtypes or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {ndim}-d "
                             f"{' or '.join(map(str, dtypes))} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")


def launch(codes: torch.Tensor, luts: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors, one launch per subspace chunk
    (int32 codes: the packing, then the scan); no validation here."""
    global launches, launches_i32
    n, m = codes.shape
    q, _, k = luts.shape
    if n and q:
        size = codes.element_size()
        chunks = subspace_chunks(m, k, MAX_LUT_BYTES)
        packed = (torch.empty(packed_bytes(n, max(j1 - j0 for j0, j1 in chunks)),
                              dtype=torch.uint8, device=codes.device)
                  if size == 4 else None)
        for j0, j1 in chunks:
            err = _entry()(codes.data_ptr() + j0 * size, size, n, m, j1 - j0,
                           luts.data_ptr() + j0 * k * 4, m * k, q, k,
                           query_tile(j1 - j0, k),
                           batch_prefetch(codes.data_ptr(), m, j0, j1 - j0, size),
                           int(j0 > 0), None if packed is None else packed.data_ptr(),
                           out.data_ptr(), _build.stream_handle(codes.device))
            _build.check("adc_scan", err)
            if codes.dtype == torch.int32:
                launches_i32 += 1
            else:
                launches += 1
    return out


def adc_scan_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(N, M) uint8 or int32 codes × (Q, M, K) f32 LUTs → (Q, N) f32 on the
    card. Codes must be below K."""
    _check("adc_scan_batch", (("codes", codes, CODE_DTYPES, 2),
                              ("luts", luts, (torch.float32,), 3)))
    n, m = codes.shape
    q, lm, k = luts.shape
    if lm != m:
        raise ValueError(f"adc_scan_batch: luts {tuple(luts.shape)} do not "
                         f"match codes {tuple(codes.shape)}")
    out = torch.empty((q, n), dtype=torch.float32, device=codes.device)
    return launch(codes, luts, out)


def _query_entry():
    global _query_fn
    if _query_fn is None:
        fn = _build.load("adc_scan").adc_scan_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _query_fn = fn
    return _query_fn


def launch_query(codes: torch.Tensor, lut: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """Launch the one-query kernel on checked tensors, one launch per
    subspace chunk; no validation here."""
    global query_launches, query_launches_i32
    n, m = codes.shape
    k = lut.shape[1]
    if n:
        size = codes.element_size()
        for j0, j1 in subspace_chunks(m, k, MAX_LUT_BYTES):
            pre = prefetch_vectors(row_vectors(codes.data_ptr(), m, j0, j1 - j0, size))
            err = _query_entry()(codes.data_ptr() + j0 * size, size, n, m, j1 - j0,
                                 lut.data_ptr() + j0 * k * 4, k, int(j0 > 0), pre,
                                 out.data_ptr(), _build.stream_handle(codes.device))
            _build.check("adc_scan", err)
            if codes.dtype == torch.int32:
                query_launches_i32 += 1
            else:
                query_launches += 1
    return out


def adc_scan(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(N, M) uint8 or int32 codes × (M, K) f32 LUT → (N,) f32 on the card.
    Codes must be below K."""
    _check("adc_scan", (("codes", codes, CODE_DTYPES, 2),
                        ("lut", lut, (torch.float32,), 2)))
    n, m = codes.shape
    if lut.shape[0] != m:
        raise ValueError(f"adc_scan: lut {tuple(lut.shape)} does not match "
                         f"codes {tuple(codes.shape)}")
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    return launch_query(codes, lut, out)
