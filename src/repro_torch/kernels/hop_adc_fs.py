"""Wrapper of the fused per-hop fast-scan ADC kernel (``csrc/hop_adc_fs.cu``).

Replaces ``repro/kernels/hop_adc.py::hop_adc_fs``, the Pallas kernel of
every fs4 beam round: packed 4-bit codes, uint8 LUTs, exact int32 sums.
One launch per round is short enough that launch latency sets its time:
one thread per (query, frontier lane) and, for frontiers of a multiple of
32, one warp per query that loads its LUT beside its ids and rows, so a
lane's critical path is its id and then its row. :func:`launch_empty` puts an empty kernel on the same grid, the
floor of that latency. Callers go through
:func:`repro_torch.kernels.ops.hop_adc_fs`, which fixes the dtypes, sends
CPU tensors to the plain version and dequantizes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

_fn = None
_empty_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("hop_adc_fs").hop_adc_fs_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch_empty(q: int, r: int) -> None:
    """An empty kernel on the grid :func:`launch` uses for (Q, R′) ids: the
    latency floor for timing. Not counted in ``launches``."""
    global _empty_fn
    if _empty_fn is None:
        fn = _build.load("hop_adc_fs").hop_adc_fs_empty_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _empty_fn = fn
    _build.check("hop_adc_fs", _empty_fn(q, r, _build.stream_handle(None)))


def launch(packed: torch.Tensor, ids: torch.Tensor, luts_u8: torch.Tensor,
           m_eff: int, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors; no validation here."""
    global launches
    q, r = ids.shape
    n_rows, mb = packed.shape
    m = luts_u8.shape[1]
    if q and r:
        err = _entry()(packed.data_ptr(), n_rows, mb, ids.data_ptr(), q, r,
                       luts_u8.data_ptr(), m, m_eff, out.data_ptr(),
                       _build.stream_handle(packed.device))
        _build.check("hop_adc_fs", err)
        launches += 1
    return out


def hop_adc_fs(packed: torch.Tensor, ids: torch.Tensor, luts_u8: torch.Tensor,
               *, m_prefix: int = 0) -> torch.Tensor:
    """(N, ceil(M/2)) uint8 packed codes, (Q, R′) int32 ids, (Q, M, 16)
    uint8 LUTs → (Q, R′) int32 exact accumulators on the card. Every id
    must be a row of ``packed`` (with the sentinel row, [0, N]); the check
    is a device-side assert. ``0 < m_prefix < M`` sums the first
    ``m_prefix`` sub-codes only (odd counts included)."""
    for name, t, dtype, ndim in (("packed", packed, torch.uint8, 2),
                                 ("ids", ids, torch.int32, 2),
                                 ("luts_u8", luts_u8, torch.uint8, 3)):
        if t.device.type != "cuda" or t.device != packed.device:
            raise ValueError(f"hop_adc_fs: {name} must be on {packed.device} (CUDA)")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"hop_adc_fs: {name} must be a contiguous {ndim}-d "
                             f"{dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    q, _ = ids.shape
    n_rows, mb = packed.shape
    m = luts_u8.shape[1]
    if luts_u8.shape[0] != q or luts_u8.shape[2] != 16 or (m + 1) // 2 != mb:
        raise ValueError(f"hop_adc_fs: luts_u8 {tuple(luts_u8.shape)} do not match "
                         f"ids {tuple(ids.shape)} and packed {tuple(packed.shape)}")
    if ids.numel():
        torch._assert_async(((ids >= 0) & (ids < n_rows)).all(),
                            f"hop_adc_fs: ids outside [0, {n_rows})")
    m_eff = m_prefix if 0 < m_prefix < m else m
    out = torch.empty(ids.shape, dtype=torch.int32, device=packed.device)
    return launch(packed, ids, luts_u8, m_eff, out)
