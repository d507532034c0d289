"""Wrapper of the fused per-hop ADC kernel (``csrc/hop_adc.cu``).

Replaces ``repro/kernels/hop_adc.py::hop_adc``, the Pallas kernel of every
beam round. It is bound by bytes: the per-query LUTs dominate a round's
reads (16 MB at Q=1000, M=16, K=256). Design and bound are noted in the
source. Callers go through :func:`repro_torch.kernels.ops.hop_adc`, which
fixes the dtypes and sends CPU tensors to the plain version.
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
        fn = _build.load("hop_adc").hop_adc_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor,
           m_eff: int, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors; no validation here."""
    global launches
    q, r = ids.shape
    n_rows, m = codes.shape
    k = luts.shape[2]
    if q and r:
        err = _entry()(codes.data_ptr(), n_rows, m, ids.data_ptr(), q, r,
                       luts.data_ptr(), k, m_eff, out.data_ptr(),
                       _build.stream_handle(codes.device))
        _build.check("hop_adc", err)
        launches += 1
    return out


def hop_adc(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor, *,
            m_prefix: int = 0) -> torch.Tensor:
    """(N, M) uint8 codes, (Q, R′) int32 ids, (Q, M, K) f32 LUTs → (Q, R′)
    f32 on the card. Every id must be a row of ``codes`` — with the
    sentinel row appended by ``ops.pad_sentinel_row``, that is [0, N]; the
    check is a device-side assert, not a Python exception.
    ``0 < m_prefix < M`` sums the first ``m_prefix`` subspaces only."""
    for name, t, dtype, ndim in (("codes", codes, torch.uint8, 2),
                                 ("ids", ids, torch.int32, 2),
                                 ("luts", luts, torch.float32, 3)):
        if t.device.type != "cuda" or t.device != codes.device:
            raise ValueError(f"hop_adc: {name} must be on {codes.device} (CUDA)")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"hop_adc: {name} must be a contiguous {ndim}-d "
                             f"{dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    q, _ = ids.shape
    n_rows, m = codes.shape
    if luts.shape[:2] != (q, m):
        raise ValueError(f"hop_adc: luts {tuple(luts.shape)} do not match "
                         f"ids {tuple(ids.shape)} and codes {tuple(codes.shape)}")
    if luts.shape[2] > 256:
        raise ValueError("hop_adc: uint8 codes address at most K=256 codewords")
    if ids.numel():
        # asynchronous, so a beam round pays no host sync for it: a bad id
        # fails the next synchronization with a device-side assert
        torch._assert_async(((ids >= 0) & (ids < n_rows)).all(),
                            f"hop_adc: ids outside [0, {n_rows})")
    m_eff = m_prefix if 0 < m_prefix < m else m
    out = torch.empty(ids.shape, dtype=torch.float32, device=codes.device)
    return launch(codes, ids, luts, m_eff, out)
